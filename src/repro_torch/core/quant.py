"""int8 quantization — the paper's packed-data path and the error-feedback
gradient compressor (port of ``repro.core.quant``).

Symmetric int8 with f32 scales, bit for bit the JAX package's rule:
``scale = max(amax, 1e-8) / 127``, ``q = clip(round(x / scale), -127,
127)`` with round-half-to-even, all in f32.  The 127 is a tensor: PyTorch's
CUDA kernels turn a division by a Python number into a product with its
reciprocal, which lands one ulp off for some scales."""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32


class QTensor(NamedTuple):
    q: torch.Tensor      # int8
    scale: torch.Tensor  # f32, per channel (broadcastable against q) or scalar


def quantize(x, axis: int | None = -1) -> QTensor:
    """Symmetric int8 quantization with per-channel scales along ``axis``
    (the max runs over every other axis; ``None``: one scalar scale)."""
    if axis is None:
        return quantize_over(x, None)
    return quantize_over(x, tuple(i for i in range(x.dim()) if i != axis % x.dim()))


def quantize_over(x, red_axes: tuple | None, amax_hook=None) -> QTensor:
    """Symmetric int8 with the max taken over ``red_axes`` (kept as size-1
    dims; ``None``: all of x, one scalar scale).  The port's one copy of
    the rule: activations per row, weights per output channel, and the
    quantize kernel's plain version all call it.  ``amax_hook`` maps the
    local max before the scale is taken: a shard's max all-reduced over the
    ranks that hold the rest of the reduced dims."""
    xf = x.to(F32)
    if red_axes is None:
        amax = xf.abs().amax()
    elif not red_axes:  # one scale an element (``amax(dim=())`` would reduce all)
        amax = xf.abs()
    else:
        amax = xf.abs().amax(dim=red_axes, keepdim=True)
    if amax_hook is not None:
        amax = amax_hook(amax)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def dequantize(qt: QTensor, dtype=F32):
    return (qt.q.to(F32) * qt.scale).to(dtype)


def quantized_matmul_ref(x_q: QTensor, w_q: QTensor, out_dtype=F32):
    """(x_scale * x_q) @ (w_q * w_scale) with exact integer sums.  x_q.q:
    [..., K] (per-row scales), w_q.q: [K, N] (per-column scales).  The sums
    run in f64, exact for |acc| < 2^53 (CUDA has no integer matmul)."""
    acc = torch.matmul(x_q.q.to(torch.float64), w_q.q.to(torch.float64))
    return (acc.to(torch.int32).to(F32) * x_q.scale * w_q.scale).to(out_dtype)


# ---------------------------------------------------------------------------
# Error-feedback int8 gradient compression
# ---------------------------------------------------------------------------

def compress_grad(g, err):
    """Returns (q: QTensor with a scalar scale, new_err).  ``err`` carries
    the quantization residual into the next step (error feedback), which
    keeps SGD / Adam unbiased to first order."""
    gf = g.to(F32) + err
    qt = quantize(gf, axis=None)
    return qt, gf - dequantize(qt)


def decompress_grad(qt: QTensor, dtype=F32):
    return dequantize(qt, dtype)
