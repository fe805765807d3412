"""Per-row activation quantization: ``csrc/quantize.cu`` on the card, the
plain version on the CPU.

Port of the activation half of ``repro.core.gemm.cgra_gemm_w8a8``:
``repro.core.quant.quantize(x, axis=0)`` just before the int8 GEMM, which
XLA fuses into one pass.  ``quantize_rows.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_rows_ref

_DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _entry():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("quantize", "repro_quantize_rows", [P, P, P, I, I, I, P])
    return _fn


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (f32 or bf16, contiguous) -> (q [M, K] int8, scale [M, 1]
    f32): ``scale = max(max_k |x|, 1e-8) / 127`` and ``q = clip(round(x /
    scale), -127, 127)``, rounding half to even, in f32 -- bit for bit
    ``core.quant.quantize(x, axis=0)`` for finite x.  Inference only."""
    _build.refuse_grad("quantize_rows", x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_rows: x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_rows: dtype {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"quantize_rows: x must be [M, K], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("quantize_rows: x must be contiguous")
    if x.device.type == "cpu":
        return quantize_rows_ref(x)
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, scale
    err = _entry()(x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K,
                   int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, "quantize_rows")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0
