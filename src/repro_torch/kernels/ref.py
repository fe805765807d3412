"""Plain PyTorch versions of the ported kernels (port of ``repro.kernels.ref``).

They are the kernels' ground truth: the CPU path of every wrapper and the
yardstick ``chip_smoke.py`` holds each CUDA kernel against on the card.
Like the JAX oracles they accumulate in f32 and round P to the value dtype
before the PV product.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import quantize, quantize_over

F32 = torch.float32
NEG = -1e30


def block_gemm_ref(a, b, out_dtype=None, trans_b: bool = False,
                   trans_a: bool = False):
    """C = A @ B with f32 accumulation and one cast to ``out_dtype``.
    ``trans_b``: b is given as [N, K] (the tied LM head reads the
    embedding table so); ``trans_a``: a is given as [K, M] (the weight
    gradient of the GEMM's backward reads the activations so)."""
    out_dtype = out_dtype or a.dtype
    a, b = a.to(F32), b.to(F32)
    return torch.matmul(a.T if trans_a else a, b.T if trans_b else b).to(out_dtype)


def block_gemm_int8_ref(a_q, b_q, a_scale, b_scale, out_dtype=F32):
    """int8 x int8 -> exact integer sums, then ``(acc * a_scale[m]) *
    b_scale[n]`` in f32 and one cast.  a_q: [M, K] int8; b_q: [N, K] int8
    (K contiguous: the port's packed weight layout, the transpose of the
    JAX operand); a_scale: [M, 1] f32; b_scale: [1, N] f32.  The sums run
    in f64, exact for |acc| < 2^53, since CUDA has no integer matmul."""
    return int8_epilogue_ref(block_gemm_int8_acc_ref(a_q, b_q), a_scale, b_scale, out_dtype)


def block_gemm_int8_acc_ref(a_q, b_q):
    """The raw accumulator of :func:`block_gemm_int8_ref`: a_q [M, K] int8
    times b_q [N, K] int8 -> the exact integer sums [M, N] int32 (summed in
    f64, exact for |acc| < 2^53), no epilogue."""
    return torch.matmul(a_q.to(torch.float64), b_q.to(torch.float64).T).to(torch.int32)


def int8_epilogue_ref(acc, a_scale, b_scale, out_dtype=F32):
    """The epilogue of :func:`block_gemm_int8_ref` on an int32 accumulator
    [M, N]: ``(float(acc) * a_scale[m]) * b_scale[n]`` in f32, cast once.
    Of the whole-K accumulator it is ``block_gemm_int8_ref`` bit for bit."""
    acc = acc.to(F32)
    return (acc * a_scale.reshape(-1, 1) * b_scale.reshape(1, -1)).to(out_dtype)


def row_amax_ref(x):
    """max_k |x[m, k]| of x [M, K] as [M, 1] f32."""
    return x.to(F32).abs().amax(dim=1, keepdim=True)


def quantize_rows_given_ref(x, amax):
    """x [M, K] quantized per row with the given maxima ``amax`` [M, 1] f32
    (``core.quant.quantize_over``'s rule with the max replaced): (q [M, K]
    int8, scale [M, 1] f32)."""
    qt = quantize_over(x, (1,), amax_hook=lambda _: amax)
    return qt.q, qt.scale


def quantize_rows_ref(x):
    """Per-row symmetric int8: x [M, K] -> (q [M, K] int8, scale [M, 1]
    f32), ``scale = max(amax, 1e-8) / 127`` and ``q = clip(round(x /
    scale), -127, 127)`` with round-half-to-even, all in f32:
    ``core.quant.quantize(x, axis=0)`` itself."""
    qt = quantize(x, axis=0)
    return qt.q, qt.scale


def _as_rows(x, B: int, device) -> torch.Tensor:
    """[B] int32 tensor from a scalar or a [B] array-like."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(B)


def _softmax_masked(s, mask):
    """Softmax over the last axis with masked entries at -1e30; a row with
    every entry masked gives zeros (the kernels' contract), not 1/S."""
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.where(mask, p, torch.zeros_like(p))


def _gather_pages(pool, pages):
    """Pool [P, ps, K, d] + tables [B, npp] -> dense [B, npp*ps, K, d]."""
    B, npp = pages.shape
    g = pool[pages.long()]  # [B, npp, ps, K, d]
    return g.reshape(B, npp * pool.shape[1], *pool.shape[2:])


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                        softcap=0.0, q_start=None):
    """Dense attention.  q: [B,H,Sq,d]; k/v: [B,K,Sk,d] with H % K == 0
    (query head h reads kv-head h // (H/K)).  Query row i sits at position
    ``q_start + i``, by default ``i + Sk - Sq`` (the last query aligned
    with the last key: ``Sq < Sk`` continues a cached prefix; a block of a
    query-chunked call passes its own start); masks: causal ``kpos <=
    qpos``, window ``kpos > qpos - window``.  A row with every key masked
    gives zeros."""
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    q_start = Sk - Sq if q_start is None else q_start
    scale = scale if scale is not None else d ** -0.5
    kb = k.repeat_interleave(G, dim=1)
    vb = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), kb.to(F32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    dev = q.device
    qpos = torch.arange(Sq, device=dev)[:, None] + q_start
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    p = _softmax_masked(s, mask)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(vb.dtype).to(F32), vb.to(F32))
    return o.to(vb.dtype)


def flash_attention_paged_ref(q, k, v, pages, q_start, k_len, *, window=0,
                              scale=None, softcap=0.0):
    """Query chunk over a paged past (chunked prefill).  q: [B,H,C,d]; k/v:
    page pools [P,ps,K,d]; pages: [B,npp] int32; q_start/k_len: [B].  Query
    row ``i`` of slot ``b`` sits at ``q_start[b] + i`` and attends causally
    over logical rows ``[0, k_len[b])``.  Rows past the chunk's valid length
    are the caller's padding; their output is unspecified."""
    B, H, C, d = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    q_start = _as_rows(q_start, B, dev)
    k_len = _as_rows(k_len, B, dev)
    kb = _gather_pages(k, pages).repeat_interleave(G, dim=2)  # [B,S,H,d]
    vb = kb if v is k else _gather_pages(v, pages).repeat_interleave(G, dim=2)
    S = kb.shape[1]
    s = torch.einsum("bhqd,bshd->bhqs", q.to(F32), kb.to(F32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = q_start[:, None] + torch.arange(C, dtype=torch.int32, device=dev)
    kpos = torch.arange(S, dtype=torch.int32, device=dev)
    mask = (kpos[None, None, :] < k_len[:, None, None]) & \
        (kpos[None, None, :] <= qpos[:, :, None])
    if window:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    p = _softmax_masked(s, mask[:, None])
    o = torch.einsum("bhqs,bshd->bhqd", p.to(vb.dtype).to(F32), vb.to(F32))
    return o.to(vb.dtype)


def flash_decode_ref(q, k, v, pos, start=None, *, layout="linear",
                     softcap=0.0, scale=None, dv=None, pages=None):
    """Batched single-token decode.  q: [B,H,dq]; k [B,S,K,dq], v
    [B,S,K,>=dv].  ``layout`` "linear": rows ``[start, pos]`` live; "ring":
    entry j holds absolute row ``a = pos - ((pos - j) mod S)`` (floored
    mod), live iff ``a >= 0`` and ``a >= start``.  Paged (``pages``
    [B,npp]): k/v are pools [P,ps,K,d] gathered through the page table and
    the linear rule applies to logical rows.  ``dv`` reads only the first
    dv value columns (v may be k).  Slots with no live row give exact
    zeros."""
    if pages is not None:
        if str(layout) not in ("linear", "paged"):
            raise ValueError(f"paged decode is linear-validity only, "
                             f"got layout={layout!r}")
        shared = v is k
        k = _gather_pages(k, pages)
        v = k if shared else _gather_pages(v, pages)
        layout = "linear"
    elif str(layout) not in ("linear", "ring"):
        raise ValueError(f"unknown decode layout {layout!r}")
    B, H, dq = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    scale = scale if scale is not None else dq ** -0.5
    pos = _as_rows(pos, B, dev)
    start = _as_rows(0 if start is None else start, B, dev)
    if dv is not None:
        v = v[..., :dv]
    qg = q.reshape(B, K, G, dq)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(F32), k.to(F32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    j = torch.arange(S, device=dev)[None, :]
    if str(layout) == "ring":
        a = pos[:, None] - torch.remainder(pos[:, None] - j, S)
        valid = (a >= 0) & (a >= start[:, None])
    else:
        valid = (j >= start[:, None]) & (j <= pos[:, None])
    p = _softmax_masked(s, valid[:, None, None, :])
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).to(F32), v.to(F32))
    return o.to(v.dtype).reshape(B, H, v.shape[-1])
