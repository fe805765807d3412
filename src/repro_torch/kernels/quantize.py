"""Per-row activation quantization: ``csrc/quantize.cu`` on the card, the
plain version on the CPU.

Port of the activation half of ``repro.core.gemm.cgra_gemm_w8a8``:
``repro.core.quant.quantize(x, axis=0)`` just before the int8 GEMM, which
XLA fuses into one pass.  A row whose K is cut over a mesh's ranks (the
row-parallel w8a8 GEMM, ``core.gemm.cgra_gemm_w8a8_row``) takes its two
passes apart: :func:`row_amax`, then, after the ranks' maxima are joined,
:func:`quantize_rows_given`.  Each wrapper's ``.launches`` counts its
kernel's launches.  Inside a dry run (``kernels.dry``) a meta tensor takes
the CUDA route up to the launch and reports the call instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.ref import quantize_rows_given_ref, quantize_rows_ref, row_amax_ref

_DTYPES = (torch.float32, torch.bfloat16)
_FNS: dict = {}


def _entry(fn: str, n_ptrs: int):
    """The C entry ``fn`` of ``csrc/quantize.cu``: ``n_ptrs`` pointers, then
    M, K, is_bf16 and the stream."""
    if fn not in _FNS:
        P, I = ctypes.c_void_p, ctypes.c_int
        _FNS[fn] = _build.bind("quantize", fn, [P] * n_ptrs + [I, I, I, P])
    return _FNS[fn]


def _check_x(what: str, x):
    _build.refuse_grad(what, x)
    if x.device.type != "cpu" and not dry.on_card(x):
        raise ValueError(f"{what}: x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [M, K], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (f32 or bf16, contiguous) -> (q [M, K] int8, scale [M, 1]
    f32): ``scale = max(max_k |x|, 1e-8) / 127`` and ``q = clip(round(x /
    scale), -127, 127)``, rounding half to even, in f32 -- bit for bit
    ``core.quant.quantize(x, axis=0)`` for finite x.  Inference only."""
    _check_x("quantize_rows", x)
    if x.device.type == "cpu":
        return quantize_rows_ref(x)
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, scale
    if x.is_meta:
        dry.report("quantize_rows", flops=0, nbytes=x.nbytes + q.nbytes + scale.nbytes,
                   outputs=(q, scale))
        return q, scale
    err = _entry("repro_quantize_rows", 3)(x.data_ptr(), q.data_ptr(), scale.data_ptr(), M,
                                           K, int(x.dtype == torch.bfloat16),
                                           _build.stream_ptr(x.device))
    _build.check(err, "quantize_rows")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """x [M, K] (f32 or bf16, contiguous) -> max_k |x| [M, 1] f32: the first
    pass of :func:`quantize_rows` alone.  Inference only."""
    _check_x("row_amax", x)
    if x.device.type == "cpu":
        return row_amax_ref(x)
    M, K = x.shape
    amax = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return amax
    if x.is_meta:
        dry.report("row_amax", flops=0, nbytes=x.nbytes + amax.nbytes, outputs=(amax,))
        return amax
    err = _entry("repro_row_amax", 2)(x.data_ptr(), amax.data_ptr(), M, K,
                                      int(x.dtype == torch.bfloat16),
                                      _build.stream_ptr(x.device))
    _build.check(err, "row_amax")
    row_amax.launches += 1
    return amax


row_amax.launches = 0


def quantize_rows_given(x: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor,
                                                                     torch.Tensor]:
    """x [M, K] (f32 or bf16, contiguous) quantized with the row maxima
    ``amax`` [M, 1] f32 (a whole row's, of which x may be a slice of the
    columns): ``scale = max(amax, 1e-8) / 127`` and ``q = clip(round(x /
    scale), -127, 127)`` as :func:`quantize_rows`.  With ``amax =
    row_amax(x)`` the two equal ``quantize_rows(x)`` bit for bit.
    Returns (q [M, K] int8, scale [M, 1] f32).  Inference only."""
    _check_x("quantize_rows_given", x)
    M, K = x.shape
    if amax.shape != (M, 1) or amax.dtype != torch.float32 or amax.device != x.device:
        raise ValueError(f"quantize_rows_given: amax {tuple(amax.shape)} {amax.dtype} on "
                         f"{amax.device} for x [{M}, {K}] on {x.device}")
    if x.device.type == "cpu":
        return quantize_rows_given_ref(x, amax)
    amax = amax.contiguous()
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, scale
    if x.is_meta:
        dry.report("quantize_rows_given", flops=0, nbytes=x.nbytes + amax.nbytes + q.nbytes
                   + scale.nbytes, outputs=(q, scale))
        return q, scale
    err = _entry("repro_quantize_rows_given", 4)(
        x.data_ptr(), amax.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, "quantize_rows_given")
    quantize_rows_given.launches += 1
    return q, scale


quantize_rows_given.launches = 0
