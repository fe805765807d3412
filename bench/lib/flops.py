"""Operations and bytes of the work the tokens need, from the
configuration's widths: the yardstick of the roofline and MFU metrics.

A reference module names its projections (``PROJECTIONS``: leaf ->
contraction dims after the layer axis) and which of them decode absorbs
into attention (``ABSORBED_IN_DECODE``); the head is ``lm_head`` over the
real vocabulary.  Each GEMM call of M rows counts ``2 M K N`` operations
and its bytes once each: the weight (K N), the input (M K) and the output
(M N) in the served dtype, the head's output in float32.
"""
from __future__ import annotations

import math

from bench.lib import peaks


def projections(ref, c: dict, phase: str) -> list[tuple[int, int]]:
    """(K, N) of each per-layer projection that runs as a GEMM in ``phase``
    ("prefill", "decode" or "train")."""
    shapes = ref.weight_shapes(c, c["vocab_size"])
    skip = set(getattr(ref, "ABSORBED_IN_DECODE", ())) if phase == "decode" else set()
    out = []
    for name, kdims in ref.PROJECTIONS.items():
        if name in skip:
            continue
        shape = shapes[name][0][1:]  # drop the layer axis
        out.append((math.prod(shape[:kdims]), math.prod(shape[kdims:])))
    return out


def head(c: dict) -> tuple[int, int]:
    return c["hidden_size"], c["vocab_size"]


def layers(c: dict) -> int:
    return int(c["num_hidden_layers"])


def matmul_params(ref, c: dict) -> int:
    """Weights a token multiplies through: every projection of every layer
    and the head (the embedding is a lookup)."""
    K, N = head(c)
    return layers(c) * sum(k * n for k, n in projections(ref, c, "prefill")) + K * N


def gemm_cost(M: int, K: int, N: int, in_bytes: int = 2, out_bytes: int = 2):
    """(operations, bytes) of one GEMM of M rows."""
    return 2.0 * M * K * N, float(in_bytes * (K * N + M * K) + out_bytes * M * N)


def bound_s(ops: float, nbytes: float, peak_flops: float = peaks.PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the compute and
    the memory term."""
    return max(ops / peak_flops, nbytes / peaks.HBM_BW)


def forward_gemm_bound(ref, c: dict, phase: str, rows: int, head_rows: int) -> float:
    """Roofline seconds of one forward's GEMMs: every layer's projections at
    ``rows`` rows and the head at ``head_rows``."""
    if rows <= 0:
        return 0.0
    t = layers(c) * sum(bound_s(*gemm_cost(rows, k, n)) for k, n in projections(ref, c, phase))
    K, N = head(c)
    if head_rows > 0:
        t += bound_s(*gemm_cost(head_rows, K, N, out_bytes=4))
    return t


def train_gemm_bound(ref, c: dict, rows: int) -> float:
    """Roofline seconds of one training step's GEMMs at ``rows`` tokens:
    each projection and the head forward, then ``g @ W^T`` and ``A^T @ g``
    (each ``2 M K N`` operations; bytes: both operands read once, the output
    written once; the head's logits and their gradient in float32)."""
    def three(M, K, N, g_bytes):
        fwd = bound_s(2.0 * M * K * N, 2.0 * (M * K + K * N) + g_bytes * M * N)
        d_a = bound_s(2.0 * M * K * N, g_bytes * M * N + 2.0 * (K * N + M * K))
        d_w = bound_s(2.0 * M * K * N, 2.0 * M * K + g_bytes * M * N + 2.0 * K * N)
        return fwd + d_a + d_w
    t = layers(c) * sum(three(rows, k, n, 2) for k, n in projections(ref, c, "train"))
    K, N = head(c)
    return t + three(rows, K, N, 4)
