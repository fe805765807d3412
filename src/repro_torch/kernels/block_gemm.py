"""Block GEMM wrapper: ``csrc/block_gemm.cu`` on the card, the plain
version on the CPU.

Port of ``repro.kernels.block_gemm.block_gemm`` (TPU kernel
``_gemm_kernel``).  ``block_gemm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_gemm_ref

_DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _entry():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("block_gemm", "repro_block_gemm",
                          [P, P, P, I, I, I, I, I, P])
    return _fn


def block_gemm(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A[M,K] @ B[K,N] with an f32 accumulator and one cast to
    ``out_dtype`` (default ``a.dtype``; f32 is the LM head's store).  B is
    row-major [K, N], not ``nn.Linear``'s [N, K]."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return block_gemm_ref(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"block_gemm: a on {a.device}, b on {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"block_gemm: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"block_gemm: dtypes {a.dtype}, {b.dtype}")
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"block_gemm: out_dtype {out_dtype} for {a.dtype} inputs")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_gemm: a and b must be contiguous")
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    if K == 0:
        return c.zero_()
    err = _entry()(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                   int(a.dtype == torch.bfloat16),
                   int(out_dtype == torch.bfloat16),
                   _build.stream_ptr(a.device))
    _build.check(err, "block_gemm")
    block_gemm.launches += 1
    return c


block_gemm.launches = 0
