"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, the kernels' build from ``src/repro_torch/kernels/csrc``,
   and the registers and spills ptxas reported for the tensor-core kernels;
2. kernels: each of the six hand-written kernels against its plain PyTorch
   version on the card at its path's shapes, in f32 and bf16 (the int8
   GEMM exactly, on integer-valued cases, over all four of its routes;
   dense attention also at the tiles' edges; slot decode also repeated,
   bit for bit; both paged kernels at page sizes 8-128, G = 1, 2, 4, 8,
   d = 128 and 256, windows and key tiles across pages, frozen full and
   empty slots, and each slot of a batched call bit-equal to its call
   alone), with its time, the plain version's time, the library call's
   time where one exists (for the paged kernels SDPA on K/V gathered from
   the pages beforehand, the gather not timed) and the least time the card
   could take (bytes over 3.35 TB/s, operations over the peak rate of
   their type);
   the bf16 and int8 GEMMs' rows must be bit-identical across M; the
   per-row activation quantize kernel the port adds must equal its plain
   version bit for bit;
3. edge: the paper's int8 path on full-width gemma3-4b (34 layers, seeded
   random weights, ``quantize_params``): ``prefill`` of 2 x 1536 tokens
   into linear and ring caches, then 32 greedy decode steps replayed as a
   CUDA graph (``models.graph.DecodeGraph``, captured at step 0).  A
   prefill and a step launch the int8 GEMM once per w8a8 GEMM (239) and the
   quantize kernel once per distinct activation (137), slot flash-decode
   once per layer a step; dense flash attention must launch, the bf16 GEMM
   must not, and the traces must show one ``cudaGraphLaunch`` a step, no
   merge kernel and no per-GEMM PyTorch reduction.  The graph must replay
   bit-equal to its eager run, also after a larger eager call grew its
   stream's scratch, and count its captured launches per replay.  A reduced
   gemma3-4b must give the same logits on the card as on the CPU's plain
   versions (under w8a8, up to one-step int8 flips at rounding boundaries,
   which ``flip_witness`` finds and checks); the bf16 model's argmax
   agreement on the same tokens is printed;
4. engine: first ``paged_reference_check`` — reduced olmo-1b on the paged
   path, ``chunk_step`` + paged ``decode_step`` and then a small engine, on
   the card against the CPU (logits within 1e-4, equal greedy tokens; w8a8
   under the flip rule).  Then full-width, full-depth olmo-1b in bf16 with
   seeded random weights serves 8 greedy requests (four share a prefix, so
   radix hits and copy-on-write pages happen) through
   ``repro_torch.serving.Engine``, whose decode steps replay one CUDA graph
   (``decode_chunk`` replays a decode tick, one a mixed tick); every
   paged-path kernel's launch count must rise, the page pool must
   reconcile, the graph must pass the checks of phase 3, and two prompts
   served alone must give the same tokens.  A traced decode tick may launch
   the graph at most ``decode_chunk`` times and fewer than 300 other
   kernels.  A short ``EngineConfig(quant="w8a8")`` pass runs the int8 GEMM
   on the paged path (and its graph is checked).  Last, a chaos run:
   full-width olmo-1b (f32) under ``preemption="recompute"`` and a
   schedule of every fault point must give one FAULT, one DEADLINE, at
   least one preemption, the other requests' tokens equal to a run without
   chaos, and a pool that reconciles on ``close()``;
5. a JSON ``added_kernels`` line (the quantize kernel), a JSON ``kernels``
   line (the six ported TPU kernels), then the JSON result as the last
   line.

It needs CUDA: without a card it exits 2 before printing anything else.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,  # dense, per type
            torch.int8: 1979e12}


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class L2Flush:
    """Writes 128 MiB between timed launches so every launch finds the L2
    (50 MB) cold, as the serving path does for its 2.6 GB of weights."""

    def __init__(self):
        self.buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                               device="cuda")

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush: L2Flush, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches: device time
    only.  A ~2 ms GPU spin ahead of the start event keeps the card busy
    while the host enqueues all of ``fn``, so the host's launch latency (the
    Python wrapper, ~20-50 us) is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(4_000_000)  # clock cycles
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def check_close(name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    mx = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        fail(f"{name}: max_abs_err {mx:.3e} beyond atol {atol} + rtol {rtol}")
    return mx


BF16_ROW_RTOL = 2.0 ** -7


def check_rows(name, got, want, rtol=BF16_ROW_RTOL):
    """bf16 attention output [..., d]: every row (one query of one head) within
    ``rtol`` of the plain version in L2 norm, relative to that row's norm.

    Both versions round P to bf16 (at different points) and round the output
    to bf16: each rounding is <= 2^-9 relative, the P roundings are
    independent across keys, so a row's relative error stays near 2^-9
    whatever the number of keys, and 2^-7 (two bf16 ulps) bounds it.  A row
    the plain version gives as exactly 0 (nothing to attend to) must be 0.
    Returns (max abs error, max row relative error)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    diff = got - want
    num, den = diff.norm(dim=-1), want.norm(dim=-1)
    zero = den == 0
    if bool((num[zero] != 0).any()):
        fail(f"{name}: a row that is exactly 0 in the plain version is not")
    rel = num[~zero] / den[~zero]
    mx = float(rel.max()) if rel.numel() else 0.0
    if mx > rtol:
        fail(f"{name}: row relative error {mx:.3e} beyond {rtol:.3e}")
    return float(diff.abs().max()) if diff.numel() else 0.0, mx


def check_attn(name, got, want, dtype):
    """f32: elementwise atol 2e-5 (online vs two-pass softmax in f32);
    bf16: ``check_rows``.  Returns (max abs error, max row relative error)."""
    if dtype == torch.float32:
        return check_close(name, got, want, 2e-5, 0.0), 0.0
    return check_rows(name, got, want)


def _errs(err):
    """``{(dtype, case): (max abs, max row rel)}`` as one log fragment."""
    return "max_abs_err (bf16: / max row relative error) " + ", ".join(
        f"{str(dt)[6:]} {n} {a:.3e}" + (f" / {r:.3e}" if dt == torch.bfloat16 else "")
        for (dt, n), (a, r) in err.items())


def _bf16_max(err):
    return max(a for (dt, _), (a, _) in err.items() if dt == torch.bfloat16)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import block_gemm, gemm_splits
    # Tolerances.  f32: both sum K products in f32 in different orders, so
    # they differ by ~sqrt(K) * 2^-24 * |terms|; 1e-4 absolute bounds that
    # for O(1) outputs at K = 8192.  bf16 output: both round nearly equal
    # f32 accumulators to bf16, so they may differ by one bf16 ulp
    # (2^-8 relative).  f32 output of bf16 inputs: as f32.
    shapes = [(M, K, N) for M in (8, 64)
              for (K, N) in ((2048, 2048), (2048, 8192), (8192, 2048),
                             (2048, 50432))]
    shapes += [(1, 2048, 50432), (37, 1000, 777)]  # chunk LM head, ragged
    err_f32 = err_bf16 = 0.0
    for (M, K, N) in shapes:
        a = torch.randn(M, K, generator=gen, device="cuda")
        b = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
        err_f32 = max(err_f32, check_close(
            f"block_gemm f32 {M}x{K}x{N}", block_gemm(a, b), ref.block_gemm_ref(a, b),
            1e-4, 1e-5))
        ab, bb = a.bfloat16(), b.bfloat16()
        err_bf16 = max(err_bf16, check_close(
            f"block_gemm bf16 {M}x{K}x{N}", block_gemm(ab, bb),
            ref.block_gemm_ref(ab, bb), 1e-4, 2.0 ** -7))
        check_close(f"block_gemm bf16->f32 {M}x{K}x{N}",
                    block_gemm(ab, bb, out_dtype=torch.float32),
                    ref.block_gemm_ref(ab, bb, torch.float32), 1e-4, 1e-5)
    for (M, K, N) in ((2, 2560, 262144), (1, 2048, 50432), (37, 1000, 777)):
        # the tied LM head reads the [V, D] embedding as B^T: as bf16->f32
        a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        e = (torch.randn(N, K, generator=gen, device="cuda") / math.sqrt(K)).bfloat16()
        check_close(f"block_gemm bf16->f32 trans_b {M}x{K}x{N}",
                    block_gemm(a, e, torch.float32, trans_b=True),
                    ref.block_gemm_ref(a, e, torch.float32, trans_b=True), 1e-4, 1e-5)
        a, e = a.float(), e.float()  # f32 models (reduced configs) tie the head too
        check_close(f"block_gemm f32 trans_b {M}x{K}x{N}",
                    block_gemm(a, e, trans_b=True),
                    ref.block_gemm_ref(a, e, trans_b=True), 1e-4, 1e-5)
    torch.cuda.synchronize()
    log(f"block_gemm: {len(shapes)} shapes x (f32, bf16, bf16->f32) agree; "
        f"max_abs_err f32 {err_f32:.3e} bf16 {err_bf16:.3e}")
    gemm_row_invariance(gen)
    rows = []
    for (M, K, N, tb) in [(8, 2048, 2048, False), (8, 2048, 8192, False),
                          (8, 8192, 2048, False), (8, 2048, 50432, False),
                          (64, 2048, 2048, False), (64, 2048, 8192, False),
                          (64, 8192, 2048, False), (1, 2048, 50432, False),
                          (1, 2048, 50432, True)]:
        a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        b = (torch.randn(*((N, K) if tb else (K, N)), generator=gen, device="cuda")
             / math.sqrt(K)).bfloat16()
        out_dtype = torch.float32 if N == 50432 else torch.bfloat16
        ms = time_ms(lambda: block_gemm(a, b, out_dtype=out_dtype, trans_b=tb), flush)
        plain = time_ms(lambda: ref.block_gemm_ref(a, b, out_dtype, trans_b=tb), flush)
        lib = time_ms(lambda: torch.matmul(a, b.T if tb else b), flush)
        out_bytes = M * N * (4 if out_dtype == torch.float32 else 2)
        bms, by = bound_ms(2 * (M * K + K * N) + out_bytes, 2 * M * N * K,
                           torch.bfloat16)
        shape = f"{M}x{K}x{N}" + (" trans_b" if tb else "")
        rows.append(dict(shape=shape, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bms, bound_by=by))
        log(f"  block_gemm bf16 {shape} (K split {gemm_splits(K, N)}): kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, torch.matmul {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return max(err_bf16, err_f32), rows


def gemm_row_invariance(gen):
    """Every output row of the bf16 GEMM is the same f32 sum whatever M is:
    ``block_gemm(A[:M], B)`` equals the first M rows of ``block_gemm(A, B)``
    bit for bit, for M across both tilings (<= 16 and > 16) and past one
    64-row tile, at each engine (K, N) and for the [N, K] head; f32 and bf16
    out.  This is what makes a prompt served alone give the same greedy
    tokens as in a batch."""
    from repro_torch.kernels.block_gemm import block_gemm
    Ms = (1, 8, 16, 17, 33, 64, 72)
    cases = [(2048, 2048, False), (2048, 8192, False), (8192, 2048, False),
             (2048, 50432, True)]
    for K, N, tb in cases:
        a = torch.randn(max(Ms), K, generator=gen, device="cuda").bfloat16()
        b = (torch.randn(*((N, K) if tb else (K, N)), generator=gen, device="cuda")
             / math.sqrt(K)).bfloat16()
        for out_dtype in (torch.float32, torch.bfloat16):
            full = block_gemm(a, b, out_dtype=out_dtype, trans_b=tb)
            for M in Ms:
                part = block_gemm(a[:M].contiguous(), b, out_dtype=out_dtype, trans_b=tb)
                if not torch.equal(part, full[:M]):
                    n = int((part != full[:M]).sum())
                    fail(f"block_gemm rows differ between M={M} and M={max(Ms)} at "
                         f"K={K} N={N} trans_b={tb} {out_dtype}: {n} entries")
    torch.cuda.synchronize()
    log(f"block_gemm: rows bit-identical across M in {Ms} for (K, N) "
        f"{[(K, N) for K, N, _ in cases]} (the last as [N, K]), f32 and bf16 out")


# the (K, N) of every int8 GEMM of the w8a8 engine at olmo-1b's widths
OLMO_INT8_KN = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 50432))


def int8_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import block_gemm_int8, int8_route, int8_splits
    # Tolerance 0.  Integer case: unit scales and operands in [-7, 7] at
    # K = 10240 keep |acc| <= 501,760 < 2^24, so every output is the exact
    # integer product (the plain version sums in f64, exactly).  Scaled
    # case: both versions form the same exact int32 sum and the same two
    # f32 products in the same order, then the same round-to-nearest cast.
    # the edge path's projections at decode (M = 2) and prefill (M = 3072):
    # wq, wk / wv, wo, w_gate / w_up, w_down, and the tied head
    timed = [(2, 2560, 2048), (2, 2560, 10240), (2, 10240, 2560), (2, 2560, 262144),
             (3072, 2560, 2048), (3072, 2560, 10240), (3072, 10240, 2560)]
    shapes = timed + [(2, 2560, 1024), (2, 2048, 2560), (3072, 2560, 1024),
                      (3072, 2048, 2560), (37, 1000, 777), (2, 64, 64), (80, 64, 32),
                      (2, 128, 256)]
    # every route at the FFN shapes: decode rows (16-row tiles), the engine's
    # chunks (64-row tiles), prefill (wgmma); and the wgmma tiles' ragged
    # M, N and K edges (K a multiple of 16, not of the 128-byte k-tile; N
    # odd)
    shapes += [(M, K, N) for M in (1, 8, 16, 17, 33, 64, 72, 3072)
               for (K, N) in ((2560, 10240), (10240, 2560)) if (M, K, N) not in shapes]
    shapes += [(3000, 2000, 1000), (3000, 2000, 1001)]  # the second: element-wise stores
    # the w8a8 engine's olmo-1b GEMMs: decode ticks (M 1-8) and the 64-row
    # chunks of mixed ticks (M 64-67, where the 50432-column head turns to
    # the wgmma route), at wq / wk / wv / wo, w_gate / w_up, w_down and the head
    shapes += [(M, K, N) for M in (1, 4, 8, 64, 67)
               for (K, N) in OLMO_INT8_KN if (M, K, N) not in shapes]

    def operands(M, K, N, lim):
        a = torch.randint(-lim, lim + 1, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-lim, lim + 1, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        return a, b

    def scales(M, N):
        return (torch.rand(M, 1, generator=gen, device="cuda") * 0.01 + 1e-4,
                torch.rand(1, N, generator=gen, device="cuda") * 0.01 + 1e-4)

    routes = set()
    for (M, K, N) in shapes:
        routes.add(int8_route(M, N, tma_ok=K % 16 == 0))
        a, b = operands(M, K, N, 7)
        ones_m = torch.ones(M, 1, device="cuda")
        ones_n = torch.ones(1, N, device="cuda")
        exact = ref.block_gemm_int8_ref(a, b, ones_m, ones_n)
        check_close(f"block_gemm_int8 exact {M}x{K}x{N}",
                    block_gemm_int8(a, b, ones_m, ones_n), exact, 0.0, 0.0)
        a, b = operands(M, K, N, 127)
        sa, sb = scales(M, N)
        for dt in (torch.float32, torch.bfloat16):
            check_close(f"block_gemm_int8 scaled {dt} {M}x{K}x{N}",
                        block_gemm_int8(a, b, sa, sb, dt),
                        ref.block_gemm_int8_ref(a, b, sa, sb, dt), 0.0, 0.0)
    torch.cuda.synchronize()
    if routes != {0, 1, 2, 3}:
        fail(f"block_gemm_int8: the checked shapes took routes {sorted(routes)}, not all four")
    log(f"block_gemm_int8: {len(shapes)} shapes agree exactly (integer case and "
        f"scaled f32/bf16 out) over all four routes")
    int8_row_invariance(gen, operands, scales)
    rows = []
    for (M, K, N) in timed:
        a, b = operands(M, K, N, 127)
        sa, sb = scales(M, N)
        out_dtype = torch.float32 if N == 262144 else torch.bfloat16
        ms = time_ms(lambda: block_gemm_int8(a, b, sa, sb, out_dtype), flush)
        plain = time_ms(lambda: ref.block_gemm_int8_ref(a, b, sa, sb, out_dtype), flush,
                        reps=5)
        bt = b.T  # [K, N] column-major view: no copy
        if M > 16:  # torch._int_mm takes M > 16 only
            lib_label = "torch._int_mm+epilogue"
            lib = time_ms(lambda: (torch._int_mm(a, bt).float() * sa * sb).to(out_dtype),
                          flush)
        else:  # A zero-padded to 32 rows, then the M rows kept
            lib_label = "torch._int_mm+epilogue, padded to 32 rows"
            a32 = torch.zeros(32, K, dtype=torch.int8, device="cuda")
            a32[:M] = a
            lib = time_ms(lambda: (torch._int_mm(a32, bt)[:M].float() * sa * sb).to(
                out_dtype), flush)
        out_bytes = M * N * (4 if out_dtype == torch.float32 else 2)
        bms, by = bound_ms(M * K + N * K + 4 * (M + N) + out_bytes, 2 * M * N * K,
                           torch.int8)
        route = int8_route(M, N)
        rows.append(dict(shape=f"{M}x{K}x{N}", ms=ms, plain_ms=plain, library_ms=lib,
                         library=lib_label, bound_ms=bms, bound_by=by, route=route,
                         splits=int8_splits(K, N) if route < 2 else 1))
        log(f"  block_gemm_int8 M={M} K={K} N={N} ({str(out_dtype)[6:]} out, route {route}, "
            f"splits {rows[-1]['splits']}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"{lib_label} {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return 0.0, rows


def int8_row_invariance(gen, operands, scales):
    """Every output row of the int8 GEMM is the same whatever M is and
    whichever route takes it: ``block_gemm_int8(A[:M], B)`` equals the first
    M rows of the 3072-row product (the wgmma route) bit for bit for M in
    {1, ..., 72} (the two mma.sync routes), f32 and bf16 out, at gemma3-4b's
    and olmo-1b's widths; and each head's rows at M <= 72 against its 72-row
    product (the wgmma route from M = 67 on)."""
    from repro_torch.kernels.block_gemm import block_gemm_int8, int8_route
    Ms = (1, 4, 8, 16, 17, 33, 64, 67, 72)
    cases = [(2560, 2048, 3072), (2560, 10240, 3072), (10240, 2560, 3072),
             (2560, 262144, 72)]
    cases += [(K, N, 72 if N > 10240 else 3072) for K, N in OLMO_INT8_KN]
    for K, N, full_m in cases:
        a, b = operands(full_m, K, N, 127)
        sa, sb = scales(full_m, N)
        for out_dtype in (torch.float32, torch.bfloat16):
            full = block_gemm_int8(a, b, sa, sb, out_dtype)
            for M in Ms:
                part = block_gemm_int8(a[:M].contiguous(), b, sa[:M].contiguous(), sb,
                                       out_dtype)
                if not torch.equal(part, full[:M]):
                    n = int((part != full[:M]).sum())
                    fail(f"block_gemm_int8 rows differ between M={M} (route "
                         f"{int8_route(M, N)}) and M={full_m} (route "
                         f"{int8_route(full_m, N)}) at K={K} N={N} {out_dtype}: {n} entries")
    torch.cuda.synchronize()
    log(f"block_gemm_int8: rows bit-identical across M in {Ms} and 3072 (72 for the "
        f"heads) at (K, N) {[(K, N) for K, N, _ in cases]}, f32 and bf16 out")


def quantize_phase(flush, gen):
    """The per-row quantize kernel against its plain version, bit for bit
    (``torch.equal`` on q and scale), at every edge GEMM's shape (M = 2 and
    3072; K = 2048, 2560, 10240) and the w8a8 engine's at olmo-1b's widths
    (M = 4, 64 and 67; K = 2048 and 8192), bf16 and f32, with an all-zero row, a row
    whose amax is under 1e-8, and rows whose values land exactly on k + 0.5
    steps (amax 127 gives scale 1: 2.5 and -3.5 must round to even); and
    against ``core.quant.quantize(x, axis=0)`` on a CPU copy of the input,
    the arithmetic the CPU tests hold equal to JAX's."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import quantize_rows
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for M in (2, 4, 64, 67, 3072):
            for K in (2048, 2560, 8192, 10240):
                x = torch.randn(M, K, generator=gen, device="cuda").to(dt)
                x[0] = 0.0
                x[1] = 3e-9
                x[1, 5] = -7e-9
                if M > 2:
                    x[2] = 0.0
                    x[2, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -1.5, 126.5])
                q, scale = quantize_rows(x)
                qr, sr = ref.quantize_rows_ref(x)
                qc = quantize(x.cpu(), axis=0)
                if not (torch.equal(q, qr) and torch.equal(scale, sr)):
                    fail(f"quantize_rows {dt} {M}x{K}: {int((q != qr).sum())} values and "
                         f"{int((scale != sr).sum())} scales differ from the plain version")
                if not (torch.equal(q.cpu(), qc.q) and torch.equal(scale.cpu(), qc.scale)):
                    fail(f"quantize_rows {dt} {M}x{K}: differs from core.quant.quantize on "
                         f"the CPU")
                if M > 2 and q[2, :6].tolist() != [127, 2, -4, 0, -2, 126]:
                    fail(f"quantize_rows {dt}: ties rounded {q[2, :6].tolist()}")
                n += 1
    torch.cuda.synchronize()
    log(f"quantize_rows: {n} cases (M 2, 4, 64, 67, 3072 x K 2048, 2560, 8192, 10240 x "
        f"f32, bf16) "
        f"bit-identical to the plain version and to core.quant.quantize on the CPU, "
        f"zero, sub-1e-8 and tie rows included")
    rows = []
    for M, K in ((3072, 2560), (3072, 10240), (2, 2560), (2, 10240)):
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        ms = time_ms(lambda: quantize_rows(x), flush)
        plain = time_ms(lambda: ref.quantize_rows_ref(x), flush)
        bms, by = bound_ms(M * K * 2 + M * K + 4 * M, 0, torch.bfloat16)
        rows.append(dict(shape=f"{M}x{K} bf16", ms=ms, plain_ms=plain, library_ms=None,
                         bound_ms=bms, bound_by=by))
        log(f"  quantize_rows bf16 {M}x{K}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bms:.4f} ms ({by})")
    return 0.0, rows


def dense_attention_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    # Tolerances (``check_attn``): f32 2e-5 elementwise; bf16 2^-7 per row.
    cases = [  # name, B, Sq, Sk, causal, window, softcap (, H, K, d)
        ("global-causal", 2, 1536, 1536, True, 0, 0.0),
        ("local-window", 2, 1536, 1536, True, 1024, 0.0),
        ("suffix Sq<Sk", 1, 100, 1300, True, 1024, 0.0),
        ("softcap-ragged", 1, 77, 77, True, 0, 30.0),
        ("all-masked Sq>Sk", 1, 90, 40, True, 0, 0.0),
        ("bidirectional", 1, 200, 333, False, 0, 0.0),
        ("reduced d16", 2, 40, 40, True, 32, 0.0, 4, 2, 16),
        # the tiles' edges: lengths one past a 64-row query tile and a 64-row
        # key tile (32 at d = 256), G = H/K in {1, 2, 8}, windows crossing
        # tile boundaries, Sq < Sk and Sq > Sk (all-masked rows), and a d
        # that is no multiple of 8 (element-wise loads instead of cp.async)
        ("edge65 d64 G1", 1, 65, 65, True, 0, 0.0, 4, 4, 64),
        ("edge129 d128 G2", 2, 129, 129, True, 0, 0.0, 4, 2, 128),
        ("edge Sq65<Sk129 d256 G8", 1, 65, 129, True, 0, 0.0, 8, 1, 256),
        ("window70 d128 G8", 2, 300, 300, True, 70, 0.0, 8, 1, 128),
        ("window33 Sq129<Sk200 d64 G2", 1, 129, 200, True, 33, 0.0, 4, 2, 64),
        ("window97 d256 G2", 1, 257, 257, True, 97, 0.0, 4, 2, 256),
        ("all-masked Sq129>Sk65 d128 G2", 1, 129, 65, True, 0, 0.0, 4, 2, 128),
        ("all-masked Sq200>Sk129 window40 d64", 1, 200, 129, True, 40, 0.0, 2, 1, 64),
        ("bidirectional Sq65<Sk129 d256 G8", 1, 65, 129, False, 0, 0.0, 8, 1, 256),
        ("softcap d20 elementwise", 1, 70, 70, True, 0, 20.0, 4, 2, 20),
    ]
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, Sq, Sk, causal, win, cap, *hkd in cases:
            H, K, d = hkd or (8, 4, 256)
            # the layers' layout: [B, S, heads, d] transposed without a copy
            q = torch.randn(B, Sq, H, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
            k = torch.randn(B, Sk, K, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
            v = torch.randn(B, Sk, K, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
            got = flash_attention(q, k, v, causal=causal, window=win, softcap=cap)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=win, softcap=cap)
            err[(dtype, name)] = check_attn(f"flash_attention {dtype} {name}", got, want,
                                            dtype)
            if Sq > Sk and causal and float(got[:, :, : Sq - Sk].abs().max()) != 0.0:
                fail("flash_attention: all-masked rows are not exactly zero")
    torch.cuda.synchronize()
    log(f"flash_attention: {len(cases)} cases x (f32, bf16) agree; " + _errs(err))
    rows = []
    B, S, H, K, d = 2, 1536, 8, 4, 256
    q = torch.randn(B, H, S, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, K, S, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, K, S, d, generator=gen, device="cuda").bfloat16()
    for name, win in (("global", 0), ("local", 1024)):
        ms = time_ms(lambda: flash_attention(q, k, v, window=win), flush, reps=10)
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, window=win), flush, reps=5)
        i = torch.arange(S, device="cuda")  # the window as a boolean mask
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - win)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if win:
            lib_fn = lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)  # noqa: E731
        else:
            lib_fn = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
        lib = time_ms(lib_fn, flush)
        lib_rel = check_rows(f"SDPA yardstick {name}", lib_fn(),
                             ref.flash_attention_ref(q, k, v, window=win), rtol=math.inf)[1]
        pairs = sum(min(i + 1, win or i + 1) for i in range(S))
        bms, by = bound_ms(2 * (2 * B * H * S * d + 2 * B * K * S * d),
                           4 * B * H * pairs * d, torch.bfloat16)
        rows.append(dict(shape=f"{name} B{B} H{H} K{K} S{S} d{d}", ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bms, bound_by=by))
        log(f"  flash_attention bf16 {name} B={B} H={H} K={K} S={S} d={d}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA{'+window mask' if win else ''} "
            f"{lib:.4f} ms (row relative error vs plain {lib_rel:.3e}), bound "
            f"{bms:.4f} ms ({by})")
    return _bf16_max(err), rows


def _live_mask(pos, start, S, ring):
    j = torch.arange(S, device=pos.device)[None]
    if ring:
        a = pos[:, None] - torch.remainder(pos[:, None] - j, S)
        return (a >= 0) & (a >= start[:, None])
    return (j >= start[:, None]) & (j <= pos[:, None])


def slot_decode_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    # Tolerances (``check_attn``): f32 2e-5 elementwise; bf16 2^-7 per row.
    # Every slot with start > pos must be exactly 0, and a second identical
    # call must give the same bits (the kernel's ticket counters were reset).
    cases = [  # layout, S, pos, start (, H, K, d (, dv: v is k, read to dv)); B = len(pos)
        ("linear", 1600, [1567, 1600, 10, 5], [0, 0, 0, 9]),   # pos == S; start > pos
        ("ring", 1024, [1567, 1024, 500, 3000], [0, 0, 0, 3001]),
        ("linear", 64, [50, 64, 3, 7], [0, 0, 0, 8], 4, 2, 16),  # reduced widths
        # bf16 rows of 40 bytes: element-wise loads, a partial 16-byte piece
        ("ring", 100, [150, 100, 3, 70], [0, 0, 0, 71], 4, 2, 20),
        # v is k, read to dv = 32 of its 64 columns (MLA-style narrowing)
        ("linear", 200, [199, 130, 0, 60], [0, 0, 0, 61], 4, 2, 64, 32),
        ("ring", 32, [50, 32, 3, 60], [0, 0, 0, 61], 4, 2, 16),
        # 64 row blocks a slot, one slot and eight
        ("linear", 4096, [4000], [0]),
        ("ring", 4096, [9000], [0]),
        ("linear", 4096, [4095, 4096, 100, 3000, 64, 0, 2047, 10],
         [0, 0, 0, 2900, 65, 0, 0, 0]),
        ("ring", 4096, [5000, 4096, 63, 12000, 4000, 1, 8191, 300],
         [0, 0, 0, 11000, 4001, 0, 0, 0]),
    ]
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for layout, S, pos, start, *hkd in cases:
            H, K, d, dv = (*hkd, None)[:4] if hkd else (8, 4, 256, None)
            B = len(pos)
            q = torch.randn(B, H, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(B, S, K, d, generator=gen, device="cuda").to(dtype)
            v = k if dv else torch.randn(B, S, K, d, generator=gen, device="cuda").to(dtype)
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            st = torch.tensor(start, dtype=torch.int32, device="cuda")
            for cap in (0.0, 50.0):
                got = flash_decode(q, k, v, p, st, layout=layout, softcap=cap, dv=dv)
                again = flash_decode(q, k, v, p, st, layout=layout, softcap=cap, dv=dv)
                want = ref.flash_decode_ref(q, k, v, p, st, layout=layout, softcap=cap,
                                            dv=dv)
                name = f"{layout}{S} B{B} cap{cap:g}"
                err[(dtype, name)] = check_attn(f"flash_decode {dtype} {name}", got, want,
                                                dtype)
                if not torch.equal(got, again):
                    fail(f"flash_decode {dtype} {name}: a repeated call differs")
                for i in range(B):
                    if start[i] > pos[i] and float(got[i].abs().max()) != 0.0:
                        fail("flash_decode: a slot with start > pos is not exactly zero")
    torch.cuda.synchronize()
    log(f"flash_decode: {len(cases)} cases (linear and ring, B 1-8, S up to 4096) x "
        "(f32, bf16) x softcap agree, repeated calls bit-equal; " + _errs(err))
    rows = []
    B, H, K, d = 2, 8, 4, 256
    for layout, S, pos in (("linear", 1600, 1567), ("ring", 1024, 1567)):
        q = torch.randn(B, H, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, K, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, K, d, generator=gen, device="cuda").bfloat16()
        p = torch.full((B,), pos, dtype=torch.int32, device="cuda")
        st = torch.zeros(B, dtype=torch.int32, device="cuda")
        ms = time_ms(lambda: flash_decode(q, k, v, p, st, layout=layout), flush)
        plain = time_ms(lambda: ref.flash_decode_ref(q, k, v, p, st, layout=layout), flush)
        mask = _live_mask(p, st, S, layout == "ring")[:, None, None, :]
        kt, vt, q4 = k.transpose(1, 2), v.transpose(1, 2), q[:, :, None]
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        live = int(mask.sum())
        bms, by = bound_ms(2 * (2 * live * K * d + 2 * B * H * d) + 8 * B,
                           4 * live * H * d, torch.bfloat16)
        rows.append(dict(shape=f"{layout} B{B} H{H} K{K} S{S} d{d} live{live}", ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by))
        log(f"  flash_decode bf16 {layout} B={B} S={S} pos={pos} ({live} live rows): "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA+mask {lib:.4f} ms, "
            f"bound {bms:.4f} ms ({by})")
    return _bf16_max(err), rows


def _paged_pools(gen, P, ps, K, d, dtype):
    k = torch.randn(P, ps, K, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(P, ps, K, d, generator=gen, device="cuda").to(dtype)
    return k, v


def _tables(B, npp, P, seed):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(np.arange(1, P))[: B * npp]
    return torch.from_numpy(perm.reshape(B, npp).astype(np.int32)).cuda()


def _gathered(pool, pages):
    """Pool [P, ps, K, d] through tables [B, npp] -> contiguous [B, K, S, d]
    (the yardstick's operand; gathered outside its timed window)."""
    B, npp = pages.shape
    g = pool[pages.long()].reshape(B, npp * pool.shape[1], *pool.shape[2:])
    return g.transpose(1, 2).contiguous()


def _slot_invariance(name, call, B):
    """``call(slots)`` runs the kernel on the slots of a slice; each slot's
    output of the batched call must equal that slot's call alone, bit for
    bit (the engine's solo == batched greedy tokens rest on it)."""
    full = call(slice(0, B))
    for i in range(B):
        solo = call(slice(i, i + 1))
        if not torch.equal(solo[0], full[i]):
            n = int((solo[0] != full[i]).sum())
            fail(f"{name}: slot {i} alone differs from the batched call in {n} entries")


def decode_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode_paged
    # Tolerances (``check_attn``): f32 2e-5 elementwise; bf16 2^-7 per row
    # (the kernel rounds the unnormalized P to bf16 before PV, as the Pallas
    # kernel does, the plain version the normalized P).  Every slot with
    # start > pos must be exactly 0, and every slot of a batched call must
    # equal its call alone, bit for bit.
    # empty slot (start > pos), prefix-only, mid-page, window-like start,
    # page boundary, a full frozen slot (pos == npp * ps), a fresh slot
    pos8, start8 = [3, 100, 257, 511, 700, 1024, 63, 0], [5, 0, 0, 200, 0, 0, 0, 0]
    pos4, start4 = [1024, 517, 9, 40], [0, 3, 10, 33]  # frozen full, ..., empty
    cases = [  # name, H, K, d, ps, max_len, pos, start, softcap, dv (v is k, read to dv)
        ("mha", 16, 16, 128, 64, 1024, pos8, start8, 0.0, None),
        ("gqa-softcap", 16, 4, 128, 64, 1024, pos8, start8, 30.0, None),
        ("shared-kv-dv64", 16, 4, 128, 64, 1024, pos8, start8, 0.0, 64),
        # page sizes 8, 16, 128: a 64-row block spans 8 or 4 pages, or half a page
        ("ps8", 16, 4, 128, 8, 1024, pos4, start4, 0.0, None),
        ("ps16", 16, 16, 128, 16, 1024, pos4, start4, 0.0, None),
        ("ps128", 16, 4, 128, 128, 1024, pos4, start4, 0.0, None),
        ("G8 deepseek-67b", 64, 8, 128, 64, 1024, [1024, 700, 0, 6], [0, 0, 0, 7], 0.0,
         None),
        # gemma3-4b on the engine: d = 256, G = 2, 1024-row windows from mid-page
        ("d256 G2 window1024", 8, 4, 256, 64, 2048, [1500, 2047, 300, 1023],
         [477, 1024, 0, 0], 50.0, None),
        ("d256 shared-kv-dv128", 16, 1, 256, 64, 1024, [700, 1024, 2, 5], [0, 0, 0, 6], 0.0,
         128),
    ]
    err = {}
    for ci, (name, H, K, d, ps, max_len, pos, start, cap, dv) in enumerate(cases):
        B, npp = len(pos), max_len // ps
        P = B * npp + 1
        pages = _tables(B, npp, P, 10 + ci)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        st = torch.tensor(start, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            k, v = _paged_pools(gen, P, ps, K, d, dtype)
            if dv:
                v = k
            q = torch.randn(B, H, d, generator=gen, device="cuda").to(dtype)
            got = flash_decode_paged(q, k, v, p, st, pages, softcap=cap, dv=dv)
            want = ref.flash_decode_ref(q, k, v, p, st, pages=pages, softcap=cap, dv=dv)
            err[(dtype, name)] = check_attn(f"flash_decode_paged {dtype} {name}",
                                            got, want, dtype)
            for i in range(B):
                if start[i] > pos[i] and float(got[i].abs().max()) != 0.0:
                    fail(f"flash_decode_paged {name}: empty slot {i} is not exactly zero")
            _slot_invariance(f"flash_decode_paged {dtype} {name}", lambda sl: flash_decode_paged(
                q[sl], k, v, p[sl], st[sl], pages[sl], softcap=cap, dv=dv), B)
    torch.cuda.synchronize()
    log(f"flash_decode_paged: {len(cases)} cases x (f32, bf16) agree, empty slots exactly 0, "
        f"every slot alone == batched bit for bit; " + _errs(err))
    B, H, K, d, ps, max_len = 8, 16, 16, 128, 64, 1024
    npp, P = max_len // ps, B * (max_len // ps) + 1
    pos = torch.tensor(pos8, dtype=torch.int32, device="cuda")
    start = torch.tensor(start8, dtype=torch.int32, device="cuda")
    pages = _tables(B, npp, P, 1)
    k, v = _paged_pools(gen, P, ps, K, d, torch.bfloat16)
    q = torch.randn(B, H, d, generator=gen, device="cuda").bfloat16()
    ms = time_ms(lambda: flash_decode_paged(q, k, v, pos, start, pages), flush)
    plain = time_ms(lambda: ref.flash_decode_ref(q, k, v, pos, start, pages=pages),
                    flush)
    # yardstick: SDPA on K/V gathered from the pages beforehand (gather not
    # timed), live rows as a boolean mask
    kg, vg = _gathered(k, pages), _gathered(v, pages)
    mask = _live_mask(pos, start, npp * ps, False)[:, None, None, :]
    q4 = q[:, :, None]
    lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q4, kg, vg, attn_mask=mask, enable_gqa=True)
    lib = time_ms(lib_fn, flush)
    want = ref.flash_decode_ref(q, k, v, pos, start, pages=pages)
    live_slots = [i for i in range(B) if start8[i] <= pos8[i]]
    lib_rel = check_rows("SDPA yardstick paged decode", lib_fn()[live_slots, :, 0],
                         want[live_slots], rtol=math.inf)[1]
    live = sum(max(0, min(int(p), npp * ps - 1) - int(s) + 1)
               for p, s in zip(pos.tolist(), start.tolist()))
    n_bytes = 2 * (2 * live * K * d + 2 * B * H * d) + 4 * (B * npp + 2 * B)
    bms, by = bound_ms(n_bytes, 4 * live * (H // K) * K * d, torch.bfloat16)
    log(f"  flash_decode_paged bf16 B={B} H={H} d={d} ps={ps} live rows={live}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA on pre-gathered K/V + mask "
        f"{lib:.4f} ms (gather not timed; row relative error vs plain {lib_rel:.3e}), bound "
        f"{bms:.4f} ms ({by})")
    return _bf16_max(err), \
        dict(shape=f"B{B} H{H} d{d} ps{ps} live{live}", ms=ms, plain_ms=plain,
             library_ms=lib, bound_ms=bms, bound_by=by)


def chunk_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_paged
    # Tolerances (``check_attn``): f32 2e-5 elementwise; bf16 2^-7 per row,
    # over each slot's n valid rows (the rest are the caller's padding); a
    # slot with nothing to attend to (n = 0) is exactly 0; every slot alone ==
    # batched, bit for bit; q is the layers' transposed [B, C, H, d] view
    # (the first case also contiguous, bit-equal).
    cases = [  # name, H, K, d, ps, max_len, C, q_start, n valid rows, window, softcap
        ("first-chunk", 16, 16, 128, 64, 1024, 64, [0], [64], 0, 0.0),
        ("q_start>0", 16, 16, 128, 64, 1024, 64, [448], [64], 0, 0.0),
        ("partial-chunk", 16, 16, 128, 64, 1024, 64, [200], [40], 0, 0.0),
        ("two-slots-gqa", 16, 4, 128, 64, 1024, 64, [130, 700], [64, 64], 0, 0.0),
        ("window", 16, 16, 128, 64, 1024, 64, [300], [64], 100, 0.0),
        ("softcap", 16, 16, 128, 64, 1024, 64, [96], [64], 0, 30.0),
        # key tiles straddling pages (ps 8 and 16: a 64-row tile spans 8 or
        # 4 pages; ps 128: half a page), chunks starting mid-page
        ("ps8", 16, 4, 128, 8, 1024, 64, [203, 960, 0], [64, 64, 17], 0, 0.0),
        ("ps16", 16, 16, 128, 16, 1024, 64, [203, 0], [64, 50], 0, 0.0),
        ("ps128", 16, 4, 128, 128, 1024, 64, [203, 900], [64, 64], 0, 0.0),
        ("G8 deepseek-67b", 64, 8, 128, 64, 1024, 64, [320, 5], [64, 64], 0, 0.0),
        # gemma3-4b on the engine: d = 256, G = 2, a 1024-row window crossing pages
        ("d256 G2 window1024", 8, 4, 256, 64, 2048, 64, [1400, 300], [64, 64], 1024, 50.0),
        # n < C, C no multiple of 16, and a slot with nothing to attend to
        ("C40 n<C", 16, 4, 128, 64, 1024, 40, [77, 0, 500], [33, 40, 0], 0, 0.0),
        ("C100 two q-tiles", 16, 4, 128, 16, 1024, 100, [150, 0], [100, 70], 0, 0.0),
    ]
    err = {}
    for ci, (name, H, K, d, ps, max_len, C, qs, n, win, cap) in enumerate(cases):
        B, npp = len(qs), max_len // ps
        P = B * npp + 1
        pages = _tables(B, npp, P, 20 + ci)
        q_start = torch.tensor(qs, dtype=torch.int32, device="cuda")
        # k_len = q_start + n; 0 for a slot with n = 0 (no key at all)
        k_len = torch.tensor([a + b if b else 0 for a, b in zip(qs, n)], dtype=torch.int32,
                             device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            k, v = _paged_pools(gen, P, ps, K, d, dtype)
            q = torch.randn(B, C, H, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
            got = flash_attention_paged(q, k, v, pages, q_start, k_len,
                                        window=win, softcap=cap)
            want = ref.flash_attention_paged_ref(q, k, v, pages, q_start, k_len,
                                                 window=win, softcap=cap)
            if got.shape != q.shape:
                fail(f"flash_attention_paged {name}: shape {tuple(got.shape)}")
            e = [check_attn(f"flash_attention_paged {dtype} {name} slot {i}",
                            got[i, :, : n[i]], want[i, :, : n[i]], dtype)
                 for i in range(B) if n[i]]
            err[(dtype, name)] = (max(a for a, _ in e), max(r for _, r in e))
            for i in range(B):
                if n[i] == 0 and float(got[i].abs().max()) != 0.0:
                    fail(f"flash_attention_paged {name}: slot {i} with no key is not exactly 0")
            if ci == 0 and not torch.equal(got, flash_attention_paged(
                    q.contiguous(), k, v, pages, q_start, k_len, window=win, softcap=cap)):
                fail(f"flash_attention_paged {dtype}: a transposed q view differs from "
                     f"the contiguous q")
            _slot_invariance(f"flash_attention_paged {dtype} {name}",
                             lambda sl: flash_attention_paged(
                                 q[sl], k, v, pages[sl], q_start[sl], k_len[sl],
                                 window=win, softcap=cap), B)
    torch.cuda.synchronize()
    log(f"flash_attention_paged: {len(cases)} cases x (f32, bf16) agree, empty slots exactly 0, "
        f"q views == contiguous q, every slot alone == batched bit for bit; " + _errs(err))
    H, d, ps, max_len, C, qs, n = 16, 128, 64, 1024, 64, 448, 64
    npp, P = max_len // ps, 8 * (max_len // ps) + 1
    k, v = _paged_pools(gen, P, ps, H, d, torch.bfloat16)
    q = torch.randn(1, H, C, d, generator=gen, device="cuda").bfloat16()
    pages = _tables(1, npp, P, 3)
    q_start = torch.tensor([qs], dtype=torch.int32, device="cuda")
    k_len = q_start + n
    ms = time_ms(lambda: flash_attention_paged(q, k, v, pages, q_start, k_len), flush)
    plain = time_ms(lambda: ref.flash_attention_paged_ref(q, k, v, pages, q_start,
                                                          k_len), flush)
    # yardstick: SDPA on K/V gathered from the pages beforehand (gather not
    # timed), causal-at-offset and live rows as a boolean mask
    kg, vg = _gathered(k, pages), _gathered(v, pages)
    kpos = torch.arange(npp * ps, device="cuda")[None, :]
    qpos = qs + torch.arange(C, device="cuda")[:, None]
    mask = (kpos < qs + n) & (kpos <= qpos)
    lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, kg, vg, attn_mask=mask, enable_gqa=True)
    lib = time_ms(lib_fn, flush)
    lib_rel = check_rows("SDPA yardstick paged chunk", lib_fn(), ref.flash_attention_paged_ref(
        q, k, v, pages, q_start, k_len), rtol=math.inf)[1]
    keys = sum(min(qs + n, qs + i + 1) for i in range(C))  # causal pairs
    n_bytes = 2 * (2 * (qs + n) * H * d + 2 * H * C * d) + 4 * (npp + 2)
    bms, by = bound_ms(n_bytes, 4 * H * keys * d, torch.bfloat16)
    log(f"  flash_attention_paged bf16 C={C} H={H} d={d} q_start={qs} k_len={qs + n}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA on pre-gathered K/V + mask "
        f"{lib:.4f} ms (gather not timed; row relative error vs plain {lib_rel:.3e}), bound "
        f"{bms:.4f} ms ({by})")
    return _bf16_max(err), \
        dict(shape=f"C{C} H{H} d{d} q_start{qs} k_len{qs + n}", ms=ms, plain_ms=plain,
             library_ms=lib, bound_ms=bms, bound_by=by)


# ---------------------------------------------------------------------------
# phase 3: the int8 edge path at full width
# ---------------------------------------------------------------------------

def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    if isinstance(tree, tuple):  # QTensor
        return type(tree)(*(_to_cuda(v) for v in tree))
    return tree.cuda()


class _Int8Recorder:
    """Records every w8a8 GEMM of ``core.gemm`` by device, in call order: the
    float activation it reads, that activation's int8 row quantization
    (``quantize_rows``: the kernel on the card, its plain version on the
    CPU) and the GEMM's output.  One quantization feeds several GEMMs (wq /
    wk / wv, w_gate / w_up): each GEMM gets an entry of its own.  Eager
    calls only: a graph replay runs no Python."""

    def __init__(self):
        from repro_torch.core import gemm
        self.gemm, self.calls = gemm, {"cpu": [], "cuda": []}

    def __enter__(self):
        g = self.gemm
        self._quantize, self._matmul = g.quantize_rows, g.cgra_matmul_int8
        last = {}

        def quantize_rows(x):
            q, scale = self._quantize(x)
            last[x.device.type] = dict(x=x.float().cpu(), q=q.cpu(), scale=scale.cpu())
            return q, scale

        def matmul(*args, **kw):
            out = self._matmul(*args, **kw)
            dev = out.device.type
            self.calls[dev].append(dict(last[dev], out=out.float().cpu()))
            return out
        g.quantize_rows, g.cgra_matmul_int8 = quantize_rows, matmul
        return self

    def __exit__(self, *exc):
        self.gemm.quantize_rows, self.gemm.cgra_matmul_int8 = self._quantize, self._matmul


def flip_witness(rec) -> dict:
    """Where the card's w8a8 run leaves the CPU's: the first GEMM call whose
    int8 activations differ, with the count of differing entries, their
    largest step difference, and the float gap of the activations at that
    call (in int8 steps).  Every GEMM up to that call must agree at 1e-4 on
    the rows whose int8 activations are equal (no flip can reach them)."""
    cpu, gpu = rec.calls["cpu"], rec.calls["cuda"]
    if len(cpu) != len(gpu):
        fail(f"w8a8 witness: {len(cpu)} GEMM calls on the CPU, {len(gpu)} on the card")
    first, flips, entries, gemm_gap = None, 0, 0, 0.0
    for i, (c, g) in enumerate(zip(cpu, gpu)):
        d = (c["q"].int() - g["q"].int()).abs()
        flips, entries = flips + int((d > 0).sum()), entries + d.numel()
        if first is None:
            same = (d == 0).all(-1)
            gemm_gap = max(gemm_gap, float((c["out"][same] - g["out"][same]).abs().max())
                           if bool(same.any()) else 0.0)
            if bool((d > 0).any()):
                uc, ug = c["x"] / c["scale"], g["x"] / g["scale"]  # in int8 steps
                frac = uc.abs() - uc.abs().floor()
                first = dict(call=i, of_calls=len(cpu), entries=int((d > 0).sum()),
                             of_entries=d.numel(), max_step=int(d.max()),
                             input_gap_steps=float((uc - ug).abs().max()),
                             flip_boundary_dist_steps=float((frac - 0.5).abs()[d > 0].max()))
    return dict(first_flip=first, flips=flips, entries=entries,
                gemm_gap_before_flip=gemm_gap)


def _card_vs_cpu(name, quant, pairs, rec):
    """The gate of a reduced model on the card's kernels against the CPU's
    plain versions over ``pairs`` of (CPU, card) logits.

    Float weights: max logits gap <= 1e-4 (the kernels sum in another
    order: f32 rounding only).  w8a8: the same bound while no int8
    activation differs.  An activation that lies within that f32 rounding
    of an int8 rounding boundary takes the neighbouring step on one side;
    ``flip_witness`` finds the first such call and must show one-step flips
    of activations whose float values agree to 1e-2 of a step, and GEMM
    outputs equal to 1e-4 up to there.  From the flip on, one step (1/127 of
    a row's max) moves the logits by up to ~1e-2 here, so the gate is then
    5e-2 on the gap and 0.9 on the argmax agreement; all are printed."""
    gap = max(float((b - a).abs().max()) for a, b in pairs)
    agree = statistics.mean(float((a.argmax(-1) == b.argmax(-1)).float().mean())
                            for a, b in pairs)
    bound, witness = 1e-4, None
    if quant == "w8a8":
        witness = flip_witness(rec)
        first = witness["first_flip"]
        log(f"{name} w8a8 witness: {json.dumps(witness)}")
        if witness["gemm_gap_before_flip"] > 1e-4:
            fail(f"{name}: w8a8 GEMM outputs before the first flip differ by "
                 f"{witness['gemm_gap_before_flip']:.3e} (bound 1e-4)")
        if first is not None:
            if first["max_step"] > 1 or first["input_gap_steps"] > 1e-2:
                fail(f"{name}: w8a8 first flip is not a boundary rounding: {first}")
            bound = 5e-2
    if not math.isfinite(gap) or gap > bound or agree < 0.9:
        fail(f"{name} {quant}: card vs CPU gap {gap:.3e}, agreement {agree}")
    return dict(gap=gap, bound=bound, argmax_agreement=agree, witness=witness)


def small_reference_check():
    """Reduced gemma3-4b (f32 compute, window 32) on the card's kernels
    against the CPU's plain versions: prefill of a 40-token prompt, then 12
    decode steps past the window on the same tokens (gate: ``_card_vs_cpu``)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 40)).astype(np.int32))
    cfg = reduce_config(get_config("gemma3-4b"))
    out = {}
    for quant in ("none", "w8a8"):
        p_cpu = M.init(cfg, seed=0, device="cpu")
        if quant == "w8a8":
            p_cpu = M.quantize_params(cfg, p_cpu)
        p_gpu = _to_cuda(p_cpu)
        with _Int8Recorder() as rec:
            lc, cc = M.prefill(cfg, p_cpu, toks, cache_len=64)
            lg, cg = M.prefill(cfg, p_gpu, toks.cuda(), cache_len=64)
            pairs = [(lc, lg.cpu())]
            for i in range(12):
                tok = toks[:, i: i + 1]
                lc, cc = M.decode_step(cfg, p_cpu, cc, tok, 40 + i)
                lg, cg = M.decode_step(cfg, p_gpu, cg, tok.cuda(), 40 + i)
                pairs.append((lc, lg.cpu()))
        out[quant] = _card_vs_cpu("reduced gemma3-4b", quant, pairs, rec)
        log(f"reduced gemma3-4b {quant}, card kernels vs CPU plain versions: prefill + 12 "
            f"decode steps, max logits gap {out[quant]['gap']:.3e} (bound "
            f"{out[quant]['bound']:g}), argmax agreement {out[quant]['argmax_agreement']:.4f}")
    return out


def paged_reference_check():
    """Reduced olmo-1b (f32 compute, page size 16, two slots, seed-0
    weights) on the card's kernels against the CPU's plain versions on the
    paged path, in float and w8a8 weights.

    Part 1, the model steps: ``chunk_step`` over a 40-token prompt in 16-row
    chunks, then 12 paged ``decode_step``s, on the same page tables and
    tokens (gate: ``_card_vs_cpu``: 1e-4, or the flip rule in w8a8).
    Part 2, a small engine: ``EngineConfig(max_batch=4, max_len=128,
    page_size=16, chunk_tokens=16, decode_chunk=4)``, four prompts of which
    two share a 24-token prefix (a page by reference, half a page
    copy-on-write), 16 greedy tokens each, on the card (decode steps
    replayed as a CUDA graph) and on the CPU.  Gate: equal greedy tokens; in
    w8a8, once Part 1 has shown a one-step boundary flip, argmax agreement
    >= 0.9 (the flip rule)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, check_invariants
    cfg = reduce_config(get_config("olmo-1b"))
    V = cfg.vocab_size
    rng = np.random.RandomState(3)
    B, ps, npp, S, C, steps = 2, 16, 4, 40, 16, 12
    toks = torch.from_numpy(rng.randint(0, V, (B, S + steps)).astype(np.int32))
    pages = torch.from_numpy(rng.permutation(np.arange(1, B * npp + 1))
                             .reshape(B, npp).astype(np.int32))
    prefix = rng.randint(0, V, 24).tolist()
    prompts = [prefix + rng.randint(0, V, 10).tolist(), rng.randint(0, V, 30).tolist(),
               prefix + rng.randint(0, V, 5).tolist(), rng.randint(0, V, 45).tolist()]
    out = {}
    for quant in ("none", "w8a8"):
        p_cpu = M.init(cfg, seed=0, device="cpu")
        if quant == "w8a8":
            p_cpu = M.quantize_params(cfg, p_cpu)
        params = {"cpu": p_cpu, "cuda": _to_cuda(p_cpu)}
        caches = {d: M.init_paged_cache(cfg, B, B * npp + 1, ps, device=d) for d in params}
        pairs = []
        with _Int8Recorder() as rec:
            for past in range(0, S, C):
                n = min(C, S - past)
                buf = torch.zeros(B, C, dtype=torch.int32)
                buf[:, :n] = toks[:, past: past + n]
                lg = {d: M.chunk_step(cfg, params[d], caches[d], buf.to(d), pages.to(d),
                                      past, n)[0].cpu() for d in params}
                pairs.append((lg["cpu"], lg["cuda"]))
            for i in range(steps):
                pos = torch.full((B,), S + i, dtype=torch.int32)
                lg = {d: M.decode_step(cfg, params[d], caches[d], toks[:, S + i: S + i + 1].to(d),
                                       pos.to(d), pages=pages.to(d))[0].cpu() for d in params}
                pairs.append((lg["cpu"], lg["cuda"]))
        res = _card_vs_cpu("reduced olmo-1b paged", quant, pairs, rec)
        econf = EngineConfig(max_batch=4, max_len=128, page_size=ps, chunk_tokens=C,
                             decode_chunk=4, quant=None if quant == "none" else quant)
        gens = {}
        for d in params:
            eng = Engine(cfg, params[d], econf, device=d)
            rids = [eng.submit(p, max_new=16) for p in prompts]
            by = {r.rid: r for r in eng.run()}
            gens[d] = [by[r].generated for r in rids]
            if eng.stats.prefix_hit_tokens < 24 or check_invariants(
                    eng.pool, eng.radix, tables=eng.sched.owned):
                fail(f"reduced olmo-1b engine {quant} on {d}: no prefix hit or bad paging state")
            if d == "cuda" and eng.runner.graph.replays == 0:
                fail("reduced olmo-1b engine: the decode graph was never replayed")
        agree = statistics.mean(float(np.mean(np.array(a) == np.array(b)))
                                for a, b in zip(gens["cpu"], gens["cuda"]))
        flipped = res["witness"] is not None and res["witness"]["first_flip"] is not None
        if (agree < 1.0 and not flipped) or agree < 0.9:
            fail(f"reduced olmo-1b engine {quant}: card and CPU greedy tokens agree at "
                 f"{agree:.4f} (flip shown: {flipped})")
        res["engine_token_agreement"] = agree
        out[quant] = res
        log(f"reduced olmo-1b paged {quant}, card kernels vs CPU plain versions: 3 chunks + "
            f"{steps} paged decode steps, max logits gap {res['gap']:.3e} (bound "
            f"{res['bound']:g}), argmax agreement {res['argmax_agreement']:.4f}; engine "
            f"(4 requests x 16 tokens, radix hits, decode graph on the card) greedy tokens "
            f"card == CPU at {agree:.4f} of positions")
    return out


def graph_check(name, g, load, gen):
    """Hold a ``DecodeGraph`` ``g`` (inputs filled by ``load()``) to its
    eager run: the replay equals ``g.eager()`` bit for bit (NaN rows of the
    poisoned slot included); the eager run launches exactly what the graph
    adds to the counters per replay; a larger eager decode call on the
    graph's own stream (growing its scratch entry) and on the current stream
    between two replays leaves the replay bit-equal; and a replay adds
    ``per_replay`` to every counter and nothing else.  Under w8a8 every int8
    GEMM of the step must take an ``mma.sync`` route (no TMA descriptor in
    the graph).  Returns {counter: launches a replay}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_gemm import int8_route
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.ops import LAUNCH_COUNTERS
    B = g.cur.numel()
    widths = sorted({t.q.shape[-2] for t in _qtensors(g.params)})
    if any(int8_route(B, n) >= 2 for n in widths):
        fail(f"{name}: an int8 GEMM of the graph would take the TMA route")

    def same(a, b):
        return all(torch.allclose(x, y, rtol=0, atol=0, equal_nan=True) for x, y in zip(a, b))

    load()
    first = tuple(t.clone() for t in g.run())
    before = {c: c.launches for c in LAUNCH_COUNTERS}
    eager = g.eager()
    eager_n = {c.__name__: c.launches - before[c] for c in LAUNCH_COUNTERS
               if c.launches != before[c]}
    per_replay = {c.__name__: n for c, n in g.per_replay.items()}
    if not same(eager, first):
        fail(f"{name}: graph replay differs from the eager step")
    if eager_n != per_replay:
        fail(f"{name}: eager step launches {eager_n}, a replay counts {per_replay}")
    held = [p.data_ptr() for p, _ in _build.stream_scratch(g.stream.cuda_stream)]
    q = torch.randn(16, 16, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(16, 4096, 16, 128, generator=gen, device="cuda").bfloat16()
    pos = torch.full((16,), 4095, dtype=torch.int32, device="cuda")
    g.stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(g.stream):
        flash_decode(q, k, k, pos, None)
    flash_decode(q, k, k, pos, None)
    torch.cuda.synchronize()
    grown = [p.data_ptr() for p, _ in _build.stream_scratch(g.stream.cuda_stream)]
    del q, k
    if grown == held:
        fail(f"{name}: the larger call did not grow the graph stream's scratch")
    before = {c: c.launches for c in LAUNCH_COUNTERS}
    load()
    again = g.run()
    delta = {c.__name__: c.launches - before[c] for c in LAUNCH_COUNTERS
             if c.launches != before[c]}
    if not same(again, first):
        fail(f"{name}: a replay after a larger eager call differs")
    if delta != per_replay:
        fail(f"{name}: a replay counted {delta}, not {per_replay}")
    torch.cuda.synchronize()
    log(f"{name} decode graph: replay == eager bit for bit (poisoned slot NaN), again "
        f"after a larger eager call that grew its stream's scratch; per replay "
        f"{json.dumps(per_replay)} launches; capture {g.capture_s * 1e3:.1f} ms")
    return per_replay


def _qtensors(tree):
    from repro_torch.core.quant import QTensor
    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qtensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _qtensors(v)


def edge_phase(counters, gen):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.graph import DecodeGraph
    names = {c.__name__: c for c in counters}
    small_gap = small_reference_check()
    cfg = get_config("gemma3-4b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    t1 = time.time()
    params_q = M.quantize_params(cfg, params)
    torch.cuda.synchronize()
    int8_gb = sum(t.numel() for t in _leaves(params_q) if t.dtype == torch.int8) / 1e9
    log(f"gemma3-4b: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} B parameters in bf16 (init "
        f"{t1 - t0:.2f} s), {int8_gb:.3f} GB of int8 weights incl. the head "
        f"(quantize_params {time.time() - t1:.2f} s)")
    B, S, cache_len, steps = 2, 1536, 1600, 32
    V = cfg.vocab_size
    prompts = torch.from_numpy(np.random.RandomState(1).randint(
        0, V, (B, S)).astype(np.int32)).cuda()

    def run(c, p, forced=None, n=steps):
        """prefill -> ``n`` greedy decode steps (or the ``forced`` tokens)
        through a ``DecodeGraph`` on the slot caches the prefill returns:
        step 0 captures it (timed apart), steps 1.. replay it.  Returns
        (per-step logits, tokens, prefill s, s a replayed step, the graph)."""
        torch.cuda.synchronize()
        t0 = time.time()
        logits, caches = M.prefill(c, p, prompts, cache_len=cache_len)
        torch.cuda.synchronize()
        t_pre = time.time() - t0
        g = DecodeGraph(c, p, caches, B)
        outs, toks = [logits[:, -1, :V]], []
        for i in range(n):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.time()
            tok = (forced[i] if forced is not None
                   else torch.argmax(outs[-1], -1).to(torch.int32))
            toks.append(tok)
            g.cur.copy_(tok)
            g.pos.fill_(S + i)
            outs.append(g.run()[0].clone())
        torch.cuda.synchronize()
        return outs, toks, t_pre, (time.time() - t0) / max(n - 1, 1), g

    run(cfg, params_q, n=2)  # warm-up: first launches, allocator
    for c in counters:
        c.launches = 0
    outs, toks, t_pre, t_step, graph = run(cfg, params_q)
    launches = {n: c.launches for n, c in names.items()}
    for n in ("block_gemm_int8", "quantize_rows", "flash_attention", "flash_decode"):
        if launches[n] <= 0:
            fail(f"{n} was not launched during the edge phase")
    if launches["block_gemm"] != 0:
        fail("the bf16 block_gemm was launched under w8a8")
    for i, lg in enumerate(outs):
        if lg.shape != (B, V) or not bool(torch.isfinite(lg).all()):
            fail(f"edge logits {i}: shape {tuple(lg.shape)} or non-finite values")
    for n in names:  # per prefill, from one more counted prefill
        names[n].launches = 0
    M.prefill(cfg, params_q, prompts, cache_len=cache_len)
    per_prefill = {n: c.launches for n, c in names.items()}
    per_step = {n: graph.per_replay.get(c, 0) for n, c in names.items()}
    # every w8a8 GEMM (7 projections a layer and the tied head) is one int8
    # GEMM launch; one quantize launch serves each distinct activation (q/k/v
    # share one, gate/up one, then wo, w_down and the head); slot decode is
    # one launch a layer.  The main run = a prefill, the warm-up step before
    # the capture, and one replay a step.
    n_gemm, n_quant = 7 * cfg.num_layers + 1, 4 * cfg.num_layers + 1
    for n, want in (("block_gemm_int8", n_gemm), ("quantize_rows", n_quant)):
        if per_prefill[n] != want or per_step[n] != want:
            fail(f"edge {n}: {per_prefill[n]} launches per prefill and {per_step[n]} per "
                 f"decode step, not {want}")
    if per_step["flash_decode"] != cfg.num_layers:
        fail(f"edge flash_decode: {per_step['flash_decode']} launches per decode step, "
             f"not {cfg.num_layers}")
    for n in names:
        if launches[n] != per_prefill[n] + (steps + 1) * per_step[n]:
            fail(f"edge {n}: {launches[n]} launches in the run, not a prefill + "
                 f"{steps + 1} steps' worth")
    if graph.replays != steps:
        fail(f"edge decode graph replayed {graph.replays} times for {steps} steps")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens_per_s = B / t_step
    log(f"edge w8a8: prefill {B}x{S} in {t_pre * 1e3:.1f} ms; decode step as a CUDA graph "
        f"(captured in {graph.capture_s * 1e3:.1f} ms at step 0), {steps - 1} replayed steps at "
        f"{t_step * 1e3:.3f} ms ({tokens_per_s:.1f} tokens/s at batch {B}); peak "
        f"device memory {peak:.2f} GiB")
    log(f"edge launches: total {json.dumps(launches)}; per prefill "
        f"{json.dumps(per_prefill)}; per decode step (one replay) {json.dumps(per_step)}")
    graph_launches = graph_check("edge gemma3-4b w8a8 slot caches", graph, lambda: (
        graph.load(toks[-1], torch.full((B,), S + steps, dtype=torch.int32),
                   nanmask=torch.tensor([False, True]))), gen)
    trace = trace_edge(cfg, params_q, prompts, cache_len, t_pre, t_step, graph, n_gemm)
    del graph
    # bf16 on the same tokens: argmax agreement (information, not a gate)
    outs_bf, _, t_pre_bf, t_step_bf, _ = run(cfg, params, forced=toks)
    agree = float(torch.mean(torch.stack([
        (torch.argmax(a, -1) == torch.argmax(b, -1)).float()
        for a, b in zip(outs, outs_bf)])))
    log(f"edge bf16 on the same tokens: prefill {t_pre_bf * 1e3:.1f} ms, "
        f"{t_step_bf * 1e3:.3f} ms per replayed step; w8a8 vs bf16 argmax agreement "
        f"{agree:.4f} over {len(outs) * B} positions")
    return launches, dict(prefill_ms=t_pre * 1e3, decode_step_ms=t_step * 1e3,
                          tokens_per_s=tokens_per_s, peak_gib=peak,
                          per_prefill=per_prefill, per_step=per_step,
                          graph_per_replay=graph_launches,
                          argmax_agreement=agree, small_gap=small_gap,
                          bf16_prefill_ms=t_pre_bf * 1e3,
                          bf16_decode_step_ms=t_step_bf * 1e3, trace=trace)


def _traced(fn):
    """Device time by kernel of ``fn`` under torch.profiler: (total ms, the
    top 8 {name xcount: ms}, every kernel's (name, launches), (CUDA graph
    launches, other kernel launches))."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if _device_us(e) > 0 and not e.key.startswith("aten::")]
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    return (sum(_device_us(e) for e in kernels) / 1e3,
            {f"{e.key[:60]} x{e.count}": _device_us(e) / 1e3 for e in top},
            [(e.key, e.count) for e in kernels], _launch_counts(events))


def _launch_counts(events) -> tuple[int, int]:
    """(CUDA graph launches, other kernel launches) among a trace's host
    runtime calls."""
    graphs = sum(e.count for e in events if e.key.startswith("cudaGraphLaunch"))
    kernels = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel",
                                                                "cuLaunchKernel")))
    return graphs, kernels


def trace_edge(cfg, params, prompts, cache_len, prefill_s, step_s, graph, n_gemm):
    """Traced prefill and decode step (one replay of ``graph`` and the next
    token's argmax) of the edge path, set against the untraced times: idle
    share = 1 - device time / untraced time.  Neither may show slot decode's
    old merge kernel, nor a PyTorch reduction that runs once per w8a8 GEMM
    (``n_gemm`` times or more: the eager activation quantization's amax)."""
    from repro_torch.models import model as M
    box = {}

    def pre():
        box["lc"] = M.prefill(cfg, params, prompts, cache_len=cache_len)
    out = {}
    dev, top, every, _ = _traced(pre)
    out["prefill"] = dict(device_ms=dev, untraced_ms=prefill_s * 1e3, top=top,
                          idle_share=1 - dev / (prefill_s * 1e3) if dev else None)
    del box

    def step():
        lf, _ = graph.run()
        graph.cur.copy_(torch.argmax(lf, -1).to(torch.int32))
    dev, top, every_step, (n_graph, n_kernel) = _traced(step)
    out["decode"] = dict(device_ms=dev, untraced_ms=step_s * 1e3, top=top,
                         idle_share=1 - dev / (step_s * 1e3) if dev else None,
                         graph_launches=n_graph, kernel_launches=n_kernel)
    if n_graph != 1:
        fail(f"traced edge decode step: {n_graph} CUDA graph launches, not 1")
    for kind, kernels in (("prefill", every), ("decode", every_step)):
        for name, count in kernels:
            if "merge_kernel" in name or ("reduce_kernel" in name and count >= n_gemm):
                fail(f"traced edge {kind}: {name[:80]} x{count} is still launched")
    for kind, o in out.items():
        log(f"traced edge {kind}: device {o['device_ms']:.3f} ms of an untraced "
            f"{o['untraced_ms']:.3f} ms; top kernels (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in o["top"].items())
            if o["device_ms"] else f"traced edge {kind}: the profiler saw no device "
            "time (not measured)")
    log(f"traced edge decode step: {n_graph} cudaGraphLaunch, {n_kernel} other kernel "
        f"launches")
    return out


# ---------------------------------------------------------------------------
# phase 4: the engine at full width
# ---------------------------------------------------------------------------

def engine_phase(counters, paged_path, gen):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, FinishReason, check_invariants
    paged_ref = paged_reference_check()
    cfg = get_config("olmo-1b")
    t0 = time.time()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"olmo-1b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters in bf16, init {time.time() - t0:.1f} s")
    econf = EngineConfig(max_batch=8, max_len=1024, page_size=64,
                         chunk_tokens=64, decode_chunk=8)
    rng = np.random.RandomState(0)
    V = cfg.vocab_size
    # a 288-token shared prefix: 4 full pages + half a page, so followers
    # share 4 pages by reference and the 5th copy-on-write (256 would end
    # on a page boundary and leave no partial page to copy)
    prefix = rng.randint(0, V, 288).tolist()
    shared = [prefix + rng.randint(0, V, n).tolist() for n in (212, 20, 97, 150)]
    other = [rng.randint(0, V, n).tolist() for n in (120, 333, 480, 205)]
    prompts = [shared[0], other[0], shared[1], other[1], shared[2], other[2],
               shared[3], other[3]]
    max_new = 32

    for c in counters:
        c.launches = 0
    eng = Engine(cfg, params, econf)
    t0 = time.time()
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    results = {r.rid: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {c.__name__: c.launches for c in counters}
    for rid, p in zip(rids, prompts):
        r = results[rid]
        if r.finish_reason != FinishReason.LENGTH or len(r.generated) != max_new:
            fail(f"rid {rid}: {r.finish_reason} with {len(r.generated)} tokens")
        if not all(0 <= t < V for t in r.generated):
            fail(f"rid {rid}: token outside the vocabulary")
    if eng.stats.prefix_hit_rate <= 0:
        fail("no radix prefix hit")
    for name in paged_path:
        if launches[name] <= 0:
            fail(f"{name} was not launched during the engine phase")
    bad = check_invariants(eng.pool, eng.radix, tables=eng.sched.owned)
    if bad:
        fail("paging invariants: " + "; ".join(bad))
    st = eng.stats
    graph = eng.runner.graph
    if graph.replays != st.chunks * econf.decode_chunk + st.mixed_steps:
        fail(f"engine decode graph: {graph.replays} replays for {st.chunks} decode ticks "
             f"and {st.mixed_steps} mixed ticks")
    ttft = sorted(r.ttft_s for r in results.values())
    ticks = st.mixed_steps + st.chunks
    # the first tick (a mixed one) captured the graph: its capture is
    # reported apart, not spread over the mixed ticks
    mixed_ms = (st.prefill_s - graph.capture_s) / max(st.mixed_steps, 1) * 1e3
    log(f"engine: {len(prompts)} requests, {st.tokens_out} tokens in {wall:.3f} s "
        f"({st.tokens_out / wall:.2f} tokens/s end to end), TTFT p50 "
        f"{statistics.median(ttft) * 1e3:.1f} ms, {ticks} ticks ({st.mixed_steps} "
        f"mixed at {mixed_ms:.2f} ms without the capture, "
        f"{st.chunks} decode-only x{econf.decode_chunk} steps at "
        f"{st.decode_s / max(st.chunks, 1) * 1e3:.2f} ms), prefix hit rate "
        f"{st.prefix_hit_rate:.4f} ({st.prefix_hit_tokens} tokens)")
    log(f"engine launches: {json.dumps(launches)}; decode graph: captured in "
        f"{graph.capture_s * 1e3:.1f} ms, {graph.replays} replays over {ticks} ticks "
        f"({econf.decode_chunk} a decode tick, 1 a mixed tick), "
        f"{json.dumps({c.__name__: n for c, n in graph.per_replay.items()})} launches a replay")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"peak device memory {peak:.2f} GiB")
    batched = {tuple(p): results[rid].generated for rid, p in zip(rids, prompts)}
    capture_ms = graph.capture_s * 1e3
    B, npp = econf.max_batch, econf.cache_spec().pages_per_seq
    table = torch.from_numpy(rng.permutation(np.arange(1, econf.n_pages))[: B * npp]
                             .reshape(B, npp).astype(np.int32))
    poison = torch.zeros(B, dtype=torch.bool)
    poison[3] = True
    cur = torch.from_numpy(rng.randint(0, V, B).astype(np.int32))
    graphs = {"bf16": graph_check("engine olmo-1b bf16 pools", graph, lambda: graph.load(
        cur, torch.tensor([0, 63, 64, 300, 511, 700, 1000, 1023], dtype=torch.int32),
        table, poison), gen)}
    del eng, graph
    for p in (shared[2], other[1]):
        solo = Engine(cfg, params, econf)
        solo.submit(p, max_new=max_new)
        got = solo.run()[0].generated
        if got != batched[tuple(p)]:
            fail(f"solo greedy tokens differ from batched for a {len(p)}-token prompt")
        del solo
    log("solo == batched greedy tokens for 2 prompts")
    summary = dict(tokens_per_s=st.tokens_out / wall, wall_s=wall,
                   ttft_p50_ms=statistics.median(ttft) * 1e3,
                   mixed_tick_ms=mixed_ms,
                   decode_tick_ms=st.decode_s / max(st.chunks, 1) * 1e3,
                   capture_ms=capture_ms, paged_reference=paged_ref)
    summary["trace"] = trace_ticks(Engine(cfg, params, econf), prompts, max_new,
                                   summary, counters)
    # w8a8 through the paged engine: the int8 GEMM on the paged path
    qconf = EngineConfig(max_batch=4, max_len=1024, page_size=64, chunk_tokens=64,
                         decode_chunk=8, quant="w8a8")
    qeng = Engine(cfg, params, qconf)
    for c in counters:
        c.launches = 0
    t0 = time.time()
    qrids = [qeng.submit(p, max_new=16) for p in prompts[:4]]
    qres = {r.rid: r for r in qeng.run()}
    torch.cuda.synchronize()
    qwall = time.time() - t0
    qlaunch = {c.__name__: c.launches for c in counters}
    for rid in qrids:
        if len(qres[rid].generated) != 16 or not all(0 <= t < V for t in qres[rid].generated):
            fail(f"w8a8 engine rid {rid}: bad output {qres[rid].generated}")
    # a forward pass (a chunk or a decode step) is 7 int8 GEMMs a layer and
    # the head's, after 4 quantize launches a layer and the head's
    n_gemm, n_quant = 7 * cfg.num_layers + 1, 4 * cfg.num_layers + 1
    if qlaunch["block_gemm_int8"] <= 0 or qlaunch["block_gemm"] != 0 \
            or qlaunch["quantize_rows"] * n_gemm != qlaunch["block_gemm_int8"] * n_quant:
        fail(f"w8a8 engine launches {qlaunch}: the int8 GEMM must carry every GEMM, "
             f"{n_quant} quantize launches for every {n_gemm} GEMMs")
    agree = statistics.mean(
        sum(a == b for a, b in zip(qres[q].generated, batched[tuple(p)])) / 16
        for q, p in zip(qrids, prompts[:4]))
    log(f"engine w8a8: 4 requests x 16 tokens in {qwall:.3f} s; launches "
        f"{json.dumps(qlaunch)}; greedy tokens equal to bf16's at {agree:.4f} of positions")
    qg = qeng.runner.graph
    qB = qconf.max_batch
    qtable = torch.from_numpy(rng.permutation(np.arange(1, qconf.n_pages))[: qB * npp]
                              .reshape(qB, npp).astype(np.int32))
    graphs["w8a8"] = graph_check("engine olmo-1b w8a8 pools", qg, lambda: qg.load(
        cur[:qB], torch.tensor([5, 64, 400, 1023], dtype=torch.int32), qtable,
        poison[:qB]), gen)
    del qeng, qg
    summary["w8a8"] = dict(wall_s=qwall, launches=qlaunch, token_agreement=agree)
    summary["graph_per_replay"] = graphs
    summary["chaos"] = chaos_run(cfg)
    return launches, summary


def chaos_run(cfg):
    """Full-width olmo-1b through the engine under a chaos schedule against
    the same requests without chaos.  f32 compute: the preempted requests
    re-prefill their tokens through chunk attention, whose rounding is not
    the decode kernel's, and f32 keeps that from flipping a greedy token, so
    equality tests the engine's bookkeeping and not bf16 rounding.

    Six requests on four slots, ``preemption="recompute"`` with 10 usable
    pages against the 12 four finishing requests need, so decode growth
    preempts.  The schedule fires ``clock.skew`` (+1000 s) at the second
    tick, past the 100 s deadline of the last request (queued), ``runner
    .mixed`` twice, ``pool.alloc`` twice (both during the first four
    admissions) and ``logits.nan`` once.
    Gates: exactly one FAULT (tokens a prefix of the reference's) and one
    DEADLINE, every other request LENGTH with the reference's tokens, at
    least one preemption, counters equal to those exits, every fault point
    fired as scheduled, and ``close()`` reconciling the pool
    (``check_invariants``)."""
    from repro_torch.models import model as M
    from repro_torch.serving import ChaosInjector, Engine, EngineConfig, FinishReason
    fcfg = cfg.with_(compute_dtype=torch.float32)
    params = M.init(fcfg, seed=0, device="cuda")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (100, 110, 120, 125, 115, 105)]
    max_new = 48
    base = dict(max_batch=4, max_len=256, page_size=64, chunk_tokens=64, decode_chunk=8)
    ref = Engine(fcfg, params, EngineConfig(**base))
    rr = [ref.submit(p, max_new=max_new) for p in prompts]
    by = {r.rid: r for r in ref.run()}
    want = [by[r].generated for r in rr]
    del ref
    chaos = ChaosInjector(schedule={"clock.skew": {1}, "runner.mixed": {2, 5},
                                    "pool.alloc": {3, 8}, "logits.nan": {6}},
                          skew_s=1000.0)
    t0 = time.time()
    eng = Engine(fcfg, params, EngineConfig(**base, n_pages=11, preemption="recompute"),
                 chaos=chaos)
    rids = [eng.submit(p, max_new=max_new, deadline_s=100.0 if i == 5 else None)
            for i, p in enumerate(prompts)]
    results = {}
    while eng.num_queued or eng.num_active:
        results.update((r.rid, r) for r in eng.step())
    wall = time.time() - t0
    got = [results[r] for r in rids]
    reasons = [r.finish_reason for r in got]
    st = eng.stats
    counts = {p: chaos.count(p) for p in ("clock.skew", "runner.mixed", "pool.alloc",
                                          "logits.nan")}
    if sorted(results) != sorted(rids):
        fail(f"chaos run: results for {sorted(results)}, submitted {rids}")
    if reasons.count(FinishReason.FAULT) != 1 or reasons[5] != FinishReason.DEADLINE \
            or reasons.count(FinishReason.DEADLINE) != 1:
        fail(f"chaos run: finish reasons {[r.value for r in reasons]}")
    for r, w, reason in zip(got, want, reasons):
        if reason == FinishReason.LENGTH and r.generated != w:
            fail(f"chaos run: rid {r.rid} ({len(r.generated)} tokens) differs from the "
                 f"run without chaos")
        if r.generated != w[: len(r.generated)]:
            fail(f"chaos run: rid {r.rid} ({reason.value}) is no prefix of the run "
                 f"without chaos")
        if reason not in (FinishReason.LENGTH, FinishReason.FAULT, FinishReason.DEADLINE):
            fail(f"chaos run: rid {r.rid} finished {reason.value}")
    if (st.faults_isolated, st.deadline_expired, st.cancelled, st.rejected) != (1, 1, 0, 0) \
            or st.preempted < 1:
        fail(f"chaos run: counters preempted {st.preempted}, faults {st.faults_isolated}, "
             f"deadline {st.deadline_expired}, cancelled {st.cancelled}, rejected {st.rejected}")
    if counts != {"clock.skew": 1, "runner.mixed": 2, "pool.alloc": 2, "logits.nan": 1}:
        fail(f"chaos run: fault points fired {counts}")
    if eng.close() != []:
        fail("chaos run: close() found requests left")
    out = dict(wall_s=wall, reasons=[r.value for r in reasons], preempted=st.preempted,
               events=[list(e) for e in chaos.events], fired=counts,
               graph_replays=eng.runner.graph.replays, ticks=st.mixed_steps + st.chunks)
    log(f"chaos run (olmo-1b f32, 6 requests, 4 slots, 10 usable pages): reasons "
        f"{out['reasons']}, {st.preempted} preemptions, fault points fired "
        f"{json.dumps(counts)}; healthy tokens == the run without chaos, pool reconciled "
        f"after close(); {out['ticks']} ticks, {out['graph_replays']} graph replays, "
        f"{wall:.2f} s")
    return out


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def trace_ticks(eng, prompts, max_new, summary, counters):
    """Device time of one mixed tick and one decode-only tick under
    torch.profiler, by kernel, set against the untraced tick times of the
    main run: idle share = 1 - device time / untraced tick time.  The
    decode tick may launch the decode graph at most ``decode_chunk`` times
    and fewer than 300 other kernels; each tick's graph replays and kernel
    launches (by wrapper, and on the host) are printed."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.submit(p, max_new=max_new)
    out = {}
    for kind in ("mixed", "decode"):
        if kind == "mixed":
            for _ in range(12):  # mid-run: a prompt streams, others decode
                eng.step()
            assert eng.sched.next_chunk() is not None and eng.num_active > 1
        else:  # every prompt admitted and prefilled: the next tick decodes
            while eng.sched.queue or eng.sched.next_chunk() is not None:
                eng.step()
            assert eng.num_active > 0
        torch.cuda.synchronize()
        before = {c.__name__: c.launches for c in counters}
        replays = eng.runner.graph.replays
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        wrapped = {c.__name__: c.launches - before[c.__name__] for c in counters
                   if c.launches != before[c.__name__]}
        replays = eng.runner.graph.replays - replays
        events = prof.key_averages()
        n_graph, n_kernel = _launch_counts(events)
        # device activity only: an aten:: op's device time repeats that of
        # the kernels it launched
        kernels = [e for e in events
                   if _device_us(e) > 0 and not e.key.startswith("aten::")]
        dev_ms = sum(_device_us(e) for e in kernels) / 1e3
        tick_ms = summary[f"{kind}_tick_ms"]
        top = sorted(kernels, key=_device_us, reverse=True)[:6]
        host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
        out[kind] = dict(device_ms=dev_ms, untraced_tick_ms=tick_ms,
                         idle_share=(1 - dev_ms / tick_ms) if dev_ms else None,
                         graph_launches=n_graph, kernel_launches=n_kernel,
                         graph_replays=replays, wrapper_launches=wrapped,
                         top={e.key[:60]: _device_us(e) / 1e3 for e in top},
                         host_top={f"{e.key[:50]} x{e.count}":
                                   e.self_cpu_time_total / 1e3 for e in host})
        log(f"traced {kind} tick: {replays} graph replays, {n_graph} cudaGraphLaunch, "
            f"{n_kernel} other kernel launches; wrapper launches {json.dumps(wrapped)}")
        log(f"traced {kind} tick host self time (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in out[kind]["host_top"].items()))
        log(f"traced {kind} tick: device {dev_ms:.3f} ms of an untraced "
            f"{tick_ms:.3f} ms tick; top kernels (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in out[kind]["top"].items())
            if dev_ms else f"traced {kind} tick: the profiler saw no device "
            "time (not measured)")
    dec = out["decode"]
    chunk = eng.config.decode_chunk
    if not (1 <= dec["graph_launches"] <= chunk) or dec["kernel_launches"] >= 300:
        fail(f"traced decode tick: {dec['graph_launches']} cudaGraphLaunch (at most "
             f"{chunk}) and {dec['kernel_launches']} other kernel launches (fewer than 300)")
    eng.run()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):  # a QTensor is a (q, scale) tuple
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import LAUNCH_COUNTERS
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.build_all()
    log(f"kernels built in {_build.BUILD_SECONDS:.1f} s "
        f"({time.time() - t0:.1f} s with loading checks)")
    resources = {k: v for n in ("flash_attention", "block_gemm", "block_gemm_int8",
                                "decode_attention", "quantize")
                 for k, v in _build.resources(n).items()
                 if any(t in k for t in ("dense_tc", "paged_tc", "gemm_bf16", "gemm_int8",
                                         "slot", "quantize", "dense_kernel"))}
    for k, v in resources.items():  # the redesigned kernels, from ptxas -v
        log(f"  ptxas {k[:90]}: {v.get('registers')} registers, spill stores "
            f"{v.get('spill_stores')} B, spill loads {v.get('spill_loads')} B, static "
            f"shared memory {v.get('smem')} B")

    flush = L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    counters = LAUNCH_COUNTERS
    rows, errs, launches, report = {}, {}, {}, {"ptxas": resources}
    errs["block_gemm"], rows["block_gemm"] = gemm_phase(flush, gen)
    errs["block_gemm_int8"], rows["block_gemm_int8"] = int8_phase(flush, gen)
    errs["quantize_rows"], rows["quantize_rows"] = quantize_phase(flush, gen)
    errs["flash_attention"], rows["flash_attention"] = dense_attention_phase(flush, gen)
    errs["flash_decode"], rows["flash_decode"] = slot_decode_phase(flush, gen)
    errs["flash_decode_paged"], rows["flash_decode_paged"] = decode_phase(flush, gen)
    errs["flash_attention_paged"], rows["flash_attention_paged"] = chunk_phase(flush, gen)
    del flush
    edge_launch, report["edge"] = edge_phase(counters, gen)
    for n in ("block_gemm_int8", "quantize_rows", "flash_attention", "flash_decode"):
        launches[n] = edge_launch[n]
    eng_launch, report["engine"] = engine_phase(
        counters, ["block_gemm", "flash_decode_paged", "flash_attention_paged"], gen)
    for n in ("block_gemm", "flash_decode_paged", "flash_attention_paged"):
        launches[n] = eng_launch[n]

    def pick(name, shape):  # the row's contract keys
        row = next(r for r in rows[name] if r["shape"] == shape)
        return {k: row[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by")}

    # each kernel's row at a shape of its main path; launches from that path
    # (the engine phase for the paged kernels and the bf16 GEMM, the edge
    # phase for the int8 GEMM, dense attention and slot decode)
    main_rows = {
        "block_gemm": pick("block_gemm", "8x2048x8192"),
        "block_gemm_int8": pick("block_gemm_int8", "3072x2560x10240"),
        "flash_attention": pick("flash_attention", "global B2 H8 K4 S1536 d256"),
        "flash_decode": rows["flash_decode"][0],
        "flash_decode_paged": rows["flash_decode_paged"],
        "flash_attention_paged": rows["flash_attention_paged"],
    }
    sources = {
        "block_gemm": ("block_gemm.cu", "src/repro/kernels/block_gemm.py:74"),
        "block_gemm_int8": ("block_gemm_int8.cu", "src/repro/kernels/block_gemm.py:129"),
        "flash_attention_paged": ("flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:172"),
        "flash_attention": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:117"),
        "flash_decode_paged": ("decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:234"),
        "flash_decode": ("decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:170"),
    }
    kernels = [dict(name=n, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
                    replaces=rep_, launches=launches[n], max_abs_err=errs[n],
                    **main_rows[n])
               for n, (src, rep_) in sources.items()]
    # the kernel the port adds (no TPU kernel: XLA fuses the JAX quantize)
    # at the prefill shape of the FFN up projections
    quant = dict(name="quantize_rows", route="cuda",
                 source="src/repro_torch/kernels/csrc/quantize.cu",
                 replaces="src/repro/core/quant.py:18 (no pallas_call)",
                 launches=launches["quantize_rows"], max_abs_err=errs["quantize_rows"],
                 **pick("quantize_rows", "3072x2560 bf16"))
    report["quantize_rows"] = quant
    log(json.dumps({"kernel_shapes": rows, **report}))
    log(json.dumps({"added_kernels": [quant]}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
