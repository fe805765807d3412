"""Public kernel entry points (port of ``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
kernel's plain version.  There is no other branch and no fallback.  The
block GEMM's custom VJP waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.cache import CacheLayout
from repro_torch.kernels.block_gemm import block_gemm, block_gemm_int8
from repro_torch.kernels.decode_attention import flash_decode, flash_decode_paged
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_paged
from repro_torch.kernels.quantize import quantize_rows

#: every kernel wrapper; each counts its launches in ``.launches``
LAUNCH_COUNTERS = (block_gemm, block_gemm_int8, quantize_rows, flash_attention,
                   flash_attention_paged, flash_decode, flash_decode_paged)


def cgra_matmul(a, b, out_dtype=None, trans_b: bool = False):
    """C = A @ B through the block-GEMM kernel; ``out_dtype`` is the
    epilogue's store dtype (the f32 accumulator is cast exactly once);
    ``trans_b``: b is stored [N, K]."""
    return block_gemm(a, b, out_dtype=out_dtype, trans_b=trans_b)


def cgra_matmul_int8(a_q, b_q, a_scale, b_scale, out_dtype=None):
    """Packed int8 GEMM with the fused per-row x per-column dequant:
    a_q [M,K], b_q [N,K] (packed weight layout), a_scale [M,1], b_scale
    [1,N]; f32 out unless ``out_dtype`` says otherwise."""
    return block_gemm_int8(a_q, b_q, a_scale, b_scale,
                           out_dtype=out_dtype or torch.float32)


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, pages=None,
              q_start=None, k_len=None):
    """q: [B,H,Sq,d]; k/v: [B,K,Sk,d] (GQA: H % K == 0), the last query
    aligned with the last key.  ``pages`` ([B, npp] int32) switches to the
    chunked-prefill paged past: k/v become page pools [P,ps,K,d] and
    ``q_start``/``k_len`` [B] place the chunk at positions ``q_start + i``
    over logical rows ``[0, k_len)`` (causal by definition)."""
    if pages is None:
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    if not causal:
        raise ValueError("paged chunk-prefill attention is causal by definition")
    return flash_attention_paged(q, k, v, pages, q_start, k_len,
                                 window=window, softcap=softcap)


def attend_decode(q, k, v, pos, start=None, *,
                  layout: str | CacheLayout = CacheLayout.LINEAR,
                  softcap=0.0, scale=None, dv=None, pages=None):
    """Batched single-token decode: q [B,H,dq] -> [B,H,dv].  Slot caches
    k/v [B,S,K,d] in the ``linear`` or ``ring`` layout, or, with ``pages``
    [B,npp], page pools [P,ps,K,d] read through the table (linear
    validity).  ``pos``/``start`` [B] int32 bound the live rows."""
    if pages is None:
        return flash_decode(q, k, v, pos, start, layout=layout,
                            softcap=softcap, scale=scale, dv=dv)
    if str(layout) not in ("linear", "paged"):
        raise ValueError(f"paged decode is linear-validity only, got {layout!r}")
    return flash_decode_paged(q, k, v, pos, start, pages, softcap=softcap,
                              scale=scale, dv=dv)
