"""Block-wise GEMM public API (port of ``repro.core.gemm``).

``cgra_gemm`` is the float path; ``cgra_gemm_w8a8`` is the paper's
packed-data path (quantize the activation per row -> int8 GEMM -> fused
dequant)."""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels.ops import cgra_matmul, cgra_matmul_int8, quantize_rows


def cgra_gemm(a, b, out_dtype=None, trans_b: bool = False):
    """C = A[..., M, K] @ B[K, N] (B stored [N, K] with ``trans_b``);
    leading dims of A are flattened into M.  ``out_dtype`` selects the
    accumulator's store dtype (default a.dtype)."""
    lead = a.shape[:-1]
    out = cgra_matmul(a.reshape(-1, a.shape[-1]).contiguous(), b, out_dtype,
                      trans_b)
    return out.reshape(*lead, b.shape[0 if trans_b else -1])


def cgra_gemm_w8a8(x, w_q: QTensor, out_dtype=torch.float32):
    """Dynamic-activation int8 GEMM: x [..., K] is quantized per row (one
    kernel launch on the card, ``core.quant.quantize(x, axis=0)`` bit for
    bit), then multiplied with the pre-quantized weight ``w_q`` (q [N, K]
    int8, the packed layout of ``model.quantize_params``; per-column scales
    [1, N])."""
    lead = x.shape[:-1]
    q, scale = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())  # scales [M, 1]
    out = cgra_matmul_int8(q, w_q.q, scale, w_q.scale, out_dtype)
    return out.reshape(*lead, w_q.q.shape[0])
