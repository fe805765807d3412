"""Plain float32 pieces the references share: norms, rotary embedding,
causal attention and the linear map, with an optional fp8 control.

Nothing here imports the program under test.  Every product runs in full
float32: :func:`f32_only` turns TF32 off for the duration.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def f32_only():
    """Full-precision float32 products on the card (no TF32), restored on
    exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x, dim: int):
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the largest magnitude of each slice maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


class _Fp8Linear(torch.autograd.Function):
    """x @ w with every product's operands rounded to fp8 e4m3, forward
    and backward: ``x`` by row and ``w`` by output column forward; the
    incoming gradient by row for ``dx = g w^T`` and by column for ``dw =
    x^T g`` (each operand scaled along the dimension it is not summed
    over)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return fp8_round(x, -1) @ fp8_round(w, 0)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = fp8_round(g, -1) @ fp8_round(w, 1).transpose(0, 1)
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        dw = fp8_round(x2, 0).transpose(0, 1) @ fp8_round(g2, 0)
        return dx, dw


def linear(x, w, quant: str | None = None):
    """x [..., K] @ w [K, N] in float32.  ``quant="fp8"`` is the control:
    every product's operands rounded to fp8 e4m3 (:class:`_Fp8Linear`)."""
    w = w.to(F32)
    x = x.to(F32)
    if quant == "fp8":
        return _Fp8Linear.apply(x, w)
    if quant is not None:
        raise ValueError(f"unknown control precision {quant!r}")
    return x @ w


def layer_norm(x, eps: float):
    """Non-parametric LayerNorm over the last axis."""
    return F.layer_norm(x.to(F32), (x.shape[-1],), eps=eps)


def rms_norm(x, scale, eps: float):
    x = x.to(F32)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.to(F32)


def rope(x, positions, theta: float):
    """Rotary embedding of x [S, n, d] at ``positions`` [S], in the
    rotate-half layout: the first half of each head pairs with the second
    (pair i is (x_i, x_{i + d/2}), rotated by ``positions * theta^(-2i/d)``)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
    ang = (positions.to(torch.float64)[:, None] * freq).to(F32)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, scale: float):
    """q [S, H, dq], k [S, K, dq], v [S, K, dv] -> [S, H, dv]; query head h
    reads kv head ``h // (H / K)``; softmax in float32 over keys at or before
    the query."""
    S, H = q.shape[0], q.shape[1]
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("qhd,khd->hqk", q.to(F32), k.to(F32)) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, -1)
    return torch.einsum("hqk,khd->qhd", p, v.to(F32))

