"""Public kernel entry points (port of ``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
kernel's plain version.  There is no other branch and no fallback.  The
block GEMM's custom VJP waits for the training slice.
"""
from __future__ import annotations

from repro_torch.core.cache import CacheLayout
from repro_torch.kernels.block_gemm import block_gemm
from repro_torch.kernels.decode_attention import flash_decode_paged
from repro_torch.kernels.flash_attention import flash_attention_paged


def cgra_matmul(a, b, out_dtype=None):
    """C = A @ B through the block-GEMM kernel; ``out_dtype`` is the
    epilogue's store dtype (the f32 accumulator is cast exactly once)."""
    return block_gemm(a, b, out_dtype=out_dtype)


def attention(q, k, v, *, window=0, softcap=0.0, pages=None, q_start=None,
              k_len=None):
    """Chunked-prefill attention over a paged past: q [B,H,C,d]; k/v page
    pools [P,ps,K,d]; ``pages`` [B,npp]; ``q_start``/``k_len`` [B].  The
    dense (unpaged) layout is not ported yet."""
    if pages is None:
        raise NotImplementedError("dense flash attention is not ported yet")
    return flash_attention_paged(q, k, v, pages, q_start, k_len,
                                 window=window, softcap=softcap)


def attend_decode(q, k, v, pos, start=None, *,
                  layout: str | CacheLayout = CacheLayout.PAGED,
                  softcap=0.0, scale=None, dv=None, pages=None):
    """Batched single-token decode over page pools: q [B,H,dq]; k/v
    [P,ps,K,d]; ``pages`` [B,npp]; ``pos``/``start`` [B] -> [B,H,dv].  The
    linear and ring slot-cache layouts are not ported yet."""
    if pages is None or str(layout) not in ("linear", "paged"):
        raise NotImplementedError("only the paged decode layout is ported")
    return flash_decode_paged(q, k, v, pos, start, pages, softcap=softcap,
                              scale=scale, dv=dv)
