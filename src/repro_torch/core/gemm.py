"""Block-wise GEMM public API (port of ``repro.core.gemm``)."""
from __future__ import annotations

from repro_torch.kernels.ops import cgra_matmul


def cgra_gemm(a, b, out_dtype=None):
    """C = A[..., M, K] @ B[K, N]; leading dims of A are flattened into M.
    ``out_dtype`` selects the accumulator's store dtype (default a.dtype)."""
    lead = a.shape[:-1]
    out = cgra_matmul(a.reshape(-1, a.shape[-1]).contiguous(), b, out_dtype)
    return out.reshape(*lead, b.shape[-1])
