"""Public kernel entry points (port of ``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
kernel's plain version; a meta tensor, only inside a dry run
(``kernels.dry``), is counted as the kernel's call.  There is no other
branch and no fallback.  The block GEMM is trainable (:data:`CGRA_MATMUL`,
with the reference's custom VJP); every other kernel wrapper raises under
autograd (``_build.refuse_grad``).
"""
from __future__ import annotations

import torch

from repro_torch.core.cache import CacheLayout
from repro_torch.kernels import _build
from repro_torch.kernels.block_gemm import (block_gemm, block_gemm_int8, block_gemm_int8_acc,
                                            int8_epilogue)
from repro_torch.kernels.decode_attention import flash_decode, flash_decode_paged
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_paged
from repro_torch.kernels.quantize import quantize_rows, quantize_rows_given, row_amax

#: every kernel wrapper; each counts its launches in ``.launches``
LAUNCH_COUNTERS = (block_gemm, block_gemm_int8, quantize_rows, flash_attention,
                   flash_attention_paged, flash_decode, flash_decode_paged,
                   block_gemm_int8_acc, int8_epilogue, row_amax, quantize_rows_given)


@torch.library.custom_op("repro_torch::cgra_matmul", mutates_args=(), schema=(
    "(Tensor a, Tensor b, ScalarType? out_dtype, bool trans_b) -> Tensor"))
def _cgra_matmul_op(a, b, out_dtype, trans_b):
    """The block GEMM as a registered operator, so that a selective
    checkpoint policy (``models.model``'s ``remat_policy``) sees it, and can
    save its output, as it sees an ATen op."""
    return block_gemm(a, b, out_dtype=out_dtype, trans_b=trans_b)


def _cgra_matmul_setup(ctx, inputs, output):
    a, b, _, trans_b = inputs
    ctx.save_for_backward(a, b)
    ctx.trans_b = trans_b


def _cgra_matmul_backward(ctx, g):
    """The backward on the same kernel: the port of ``repro.kernels.ops.
    cgra_matmul``'s ``jax.custom_vjp`` (``_mm_fwd`` / ``_mm_bwd``).  With ``C
    = A @ B`` and the incoming ``g``:

    - ``ga = g.to(b.dtype) @ B^T``, cast to ``a.dtype``: B read in place as
      the transposed operand (``trans_b``), or, for a B stored [N, K], as
      it is;
    - ``gb = A^T @ g.to(a.dtype)``, cast to ``b.dtype``: A read in place as
      the transposed operand (``trans_a``); for a B stored [N, K] the
      gradient comes out in that layout as ``g^T @ A``.

    So a GEMM of the forward launches the kernel three times in a train
    step and no operand is copied transposed.  The f32 head's ``g`` is cast
    to the weight dtype first, as ``_mm_bwd`` does."""
    a, b = ctx.saved_tensors
    ga = gb = None
    if ctx.needs_input_grad[0]:
        ga = block_gemm(g.to(b.dtype).contiguous(), b, trans_b=not ctx.trans_b).to(a.dtype)
    if ctx.needs_input_grad[1]:
        gt = g.to(a.dtype).contiguous()
        gb = (block_gemm(gt, a, trans_a=True) if ctx.trans_b
              else block_gemm(a, gt, trans_a=True)).to(b.dtype)
    return ga, gb, None, None


@_cgra_matmul_op.register_fake
def _cgra_matmul_meta(a, b, out_dtype, trans_b):
    """The operator on meta tensors: the wrapper's own meta route, which
    inside a dry run allocates the output and reports the one call (the
    operator reaches a dispatch mode as one op, so the GEMM is counted here
    and nowhere else) and outside one raises as the wrapper does."""
    return block_gemm(a, b, out_dtype=out_dtype, trans_b=trans_b)


_cgra_matmul_op.register_autograd(_cgra_matmul_backward, setup_context=_cgra_matmul_setup)

#: the operator a selective checkpoint policy saves to keep GEMM outputs
CGRA_MATMUL = torch.ops.repro_torch.cgra_matmul.default


def cgra_matmul(a, b, out_dtype=None, trans_b: bool = False):
    """C = A @ B through the block-GEMM kernel; ``out_dtype`` is the
    epilogue's store dtype (the f32 accumulator is cast exactly once);
    ``trans_b``: b is stored [N, K].  Differentiable: when autograd records
    (grad mode on and an input requiring grad) the call goes through the
    registered operator :data:`CGRA_MATMUL`, whose backward runs the same
    kernel (or, on the CPU, the same plain version); otherwise straight to
    the kernel."""
    if _build.records(a, b):
        return CGRA_MATMUL(a, b, out_dtype, trans_b)
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
