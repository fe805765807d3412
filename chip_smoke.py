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
   version bit for bit; the row-parallel w8a8 GEMM's four entries at
   olmo-1b's K halves (``rowpar_kernel_phase``: the int32 partials of two
   halves sum exactly to the whole-K accumulator on every route, their
   epilogue equals the fused int8 GEMM, the row max and the given-max
   quantize equal the row quantize, each timed beside ``torch._int_mm``);
   and at minicpm3-4b's shapes: slot and paged
   flash-decode at the latent call (B = 8, 40 query heads over one kv-head,
   dq 288, dv 256, v is k; a linear slot cache and pools of page size 16
   and 64; f32 and bf16; empty and frozen full slots; each slot alone ==
   batched) timed beside SDPA on gathered K/V, the bf16 GEMM at its eight
   (K, N) pairs for M in {1, 8, 64, 500} (rows bit-identical across M) and
   the int8 GEMM exactly at its six w8a8 pairs on every route the MLA path
   takes; and at qwen3-moe-30b-a3b's shapes: the bf16 GEMM at its four
   (K, N) pairs for M in {1, 8, 64, 600} (rows bit-identical across M),
   the int8 GEMM exactly at the same pairs for M in {1, 4, 8, 64, 67}
   (rows bit-identical across M), paged flash-decode and chunk attention,
   slot decode and dense attention at its heads (32 over 4, d = 128), the
   bf16 GEMM and paged attention timed beside the plain version, the
   library call and the bound;
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
   chaos, and a pool that reconciles on ``close()``.  Then the serving
   driver (``serve_phase``): ``repro_torch.launch.serve.run`` in-process on
   full olmo-1b at temperature 0.7 -- Poisson arrivals with whole-suffix
   prefill, with ``--chunk-tokens 64`` and with w8a8 (every request ``ok``
   with 32 tokens, the pool reconciled after ``close()``, each run's path
   kernels launched and no other), a closed batch of 16 whose every sampled
   request equals itself served alone with its seed, the decode tick at
   temperature 0.7 against greedy, and reduced olmo-1b under
   ``preemption="recompute"`` whose sampled tokens equal those of a run that
   never preempts.  Then the mesh phase (``mesh_phase``): two ranks of the
   port's mesh-sharded engine on this one card over gloo (NCCL refuses two
   ranks on one device; every collective goes through host memory and the
   decode step runs eagerly, by rule), each holding its shard: (a) full
   olmo-1b at ``MeshSpec(1, 2)`` in bf16 and in f32, 8 requests of 100-500
   tokens, 32 greedy new, against the single-rank engine on the same seed-0
   weights -- both ranks the same tokens, each of the three path kernels
   launched on every rank at the shard's shapes (printed), and every token
   equal to the single rank's or its first difference a witnessed near-tie
   (``mesh_flip_witness``; the logits there within 1e-2 in f32, the bf16
   gap printed); (b) qwen3-moe-30b-a3b at full width over 8 of its 48
   layers, expert-parallel (64 of 128 experts a rank): f32 prefill logits
   within 1e-4 of the single rank's (bf16 printed), 4 requests' greedy
   tokens under the same flip rule; (c) the four ring schedules of
   ``core/torus.py`` at olmo-1b's FFN shapes (512 tokens, D 2048, F 8192, tp
   2) against the dense product in f32 (1e-5) and bf16 (2^-7), timed beside
   the single rank's dense GEMMs; (d) ``python -m repro_torch.launch.serve
   --no-reduced --mesh 1x2 --backend gloo --requests 8 --max-new 16``, every
   request ok; (e) full olmo-1b w8a8 at 1x2 (wo and w_down row-parallel on
   the int8 GEMM's int32-partial and epilogue entries and the quantize's
   row-max and given-max entries: the whole row's scale, an exact int32
   sum), (f) full mamba2-130m head-parallel at 1x2 and over the data group
   at 2x1, bf16 and f32, and a w8a8 pass, (g) reduced jamba at 1x2 in f32,
   each against its single-rank engine under the same flip rule; (h) (b)'s
   model on three ranks at 1x3, where 128 experts do not divide and each
   rank holds 256 of every expert's 768 FFN columns, against (b)'s single
   rank (f32 logits within 1e-4, bf16 tokens under the flip rule).  The
   row-parallel entries are checked exactly in phase 2
   (``rowpar_kernel_phase``: olmo-1b's K halves, M 1-512, every route).
   Its times are two ranks sharing one card, not multi-GPU scaling numbers;
5. MLA: first ``mla_reference_check`` -- reduced minicpm3-4b on the card
   against the CPU (whole prefill, 12 paged ``decode_step``s, then a small
   engine; logits within 1e-4, equal greedy tokens; w8a8 under the flip
   rule).  Then full-width, full-depth minicpm3-4b (bf16, seeded random
   weights) serves 8 greedy requests through the engine: each prompt
   prefills whole at admission, every tick is a decode tick replaying the
   decode graph over the fused [latent | k_rope] pools; only the bf16 GEMM
   and paged flash-decode may launch, paged decode once a layer a replay;
   the pool reconciles, the graph passes ``graph_check``, two prompts
   served alone give the same tokens, and a traced decode tick is held as
   in phase 4.  A short w8a8 pass and the direct ``prefill(cache_len=...)``
   -> 8 ``decode_step``s on linear slot caches follow;
6. MoE: first ``moe_reference_check`` -- reduced qwen3-moe on the card
   against the CPU (``chunk_step`` + 12 paged ``decode_step``s, then a
   small chunked engine with radix hits; logits within 1e-4, every layer's
   top-k experts and kept masks equal, equal greedy tokens; w8a8 under the
   flip rule) -- and ``moe_layer_check`` -- one full-width MoE layer (d 2048,
   128 experts top-8 of width 768) in f32 on the card against the CPU at
   T = 8, 64 and 600: routing equal but at near-ties (each printed), outputs
   within 1e-5 x their max, the dropped share printed.  Then, with every
   earlier model freed, full-width, full-depth qwen3-moe-30b-a3b (61 GB of
   bf16 weights drawn on the card) serves 8 greedy requests through the
   chunked engine (four share a 288-token prefix: radix hits and a
   copy-on-write page); only the bf16 GEMM and the two paged attention
   kernels launch, paged decode once a layer a replay; the pool
   reconciles, the graph passes ``graph_check``, and a traced decode tick
   is held as in phase 4.  There is no solo == batched gate: capacity is
   shared by every row of a call, so by the reference's own semantics a
   request's tokens depend on its neighbours whenever an expert
   overflows; the card-vs-CPU checks stand in for it.  A short w8a8 pass
   (the experts and routers stay the float tensors) and the direct
   ``prefill(cache_len=512)`` -> 8 ``decode_step``s (B = 2 x 300) follow;
7. SSD (after the MoE model is freed): first the kernels of the SSM paths
   (in phase 2: the bf16 GEMM at mamba2-130m's head, 768 x 50432 f32 out,
   its w_out, 1536 x 768, and at jamba's six (K, N), rows bit-identical
   across M; the int8 head
   exactly; paged flash-decode and dense attention at jamba's 32 heads over
   8), then ``ssm_reference_check`` -- reduced mamba2-130m and reduced
   jamba on the card against the CPU (a whole prefill of a prime length,
   12 paged ``decode_step``s, then a small engine; logits within 1e-4,
   jamba's routing equal, equal greedy tokens; w8a8 under the flip rule).
   Then full-width, full-depth mamba2-130m (bf16, seeded random weights)
   serves 8 greedy requests (prompts 100-500 tokens, one of prime length
   499, one of 256) through the whole-prefill engine with the prefix
   cache asked for: no radix tree, every tick a decode tick replaying the
   decode graph, only the bf16 GEMM launched (the head and the 24 w_out
   projections, once a prefill, once a replay), ``graph_check`` holding the
   SSD state too, the pool reconciled, two prompts alone == batched, a
   traced decode tick; a short w8a8 pass (the int8 head; w_out stays a bf16
   GEMM) and the direct ``prefill(cache_len=512)``
   -> 8 ``decode_step``s.  Last, full-width jamba over one layer period (8
   layers, 26.5 GB of bf16 weights; the whole 32 layers, ~103 GB, exceed the
   card, and the cut is printed with that reason) serves the same 8
   requests: dense flash attention once a whole prefill, paged
   flash-decode once a replay, ``graph_check``, the pool reconciled, a
   traced decode tick;
8. VLM and encoder (after jamba is freed): first the kernels at their
   shapes (in phase 2: dense attention bidirectional at hubert's head dim
   80 and llama-3.2-vision's cross-attention at Sq = 1 and 500 over 1601
   image keys, also among the dense gates; slot decode at G = 4, d = 128;
   the bf16 GEMM at llama's decode widths, the image K/V (3202 rows) and
   hubert's MLP (4000 rows); the int8 GEMM exactly and the row quantize bit
   for bit at the w8a8 passes' shapes), then reduced llama-3.2-vision and
   reduced hubert on the card against the CPU (``vlm_reference_check``,
   ``encoder_reference_check``; w8a8 under the flip rule).  Full-width,
   full-depth llama-3.2-vision-11b (10.1 B parameters, gates 0.5): B = 2
   prompts of 500 tokens with 1601 patch embeddings each, ``prefill(images,
   cache_len=1024)`` and 32 greedy steps replayed as a CUDA graph, in bf16
   and w8a8, the launches per prefill and per replay checked exactly,
   ``graph_check`` with the image K/V among the graph's state, a traced
   step.  Full-width, full-depth hubert-xlarge: the bidirectional forward
   over 4 x 1000 frames and every frame's logits, bf16 and w8a8, launches
   per forward checked, a traced forward;
9. training (after hubert is freed): first the bf16 GEMM at full olmo-1b's
   training shapes (in phase 2: T = 8 x 512 = 4096 rows; each forward
   product, its data gradient ``g @ W^T`` (``trans_b``) and its weight
   gradient ``A^T @ g`` (``trans_a``, A read in place as [T, K]) against the
   plain version, timed beside ``torch.matmul`` and the bound; ``trans_a``
   also in f32 and ragged; rows bit-identical across M), then
   ``train_reference_check`` -- reduced olmo-1b and reduced qwen3-moe take
   one f32 train step on the card and on the CPU (loss within 1e-5, every
   gradient leaf within 1e-4 of its max, the block GEMM launched exactly 3
   times per forward GEMM and no attention kernel: training attention is
   the plain version by rule), and a ``TrainRunner`` run on the card with an
   injected failure resumes the exact loss stream.  Full-width olmo-1b
   (16 layers, bf16, seeded weights) takes 10 steps of ``make_train_step``
   on ``SyntheticLM`` batches of 8 x 512 tokens (f32 moments;
   ``remat_policy="none"``): every loss finite, the last below the first,
   exact GEMM launches, step ms, tokens/s, peak memory, a traced step; then
   a step each with bf16 and int8 moments.  Then the reference's training
   options (``train_options_phase``): 3 steps under each ``remat_policy``
   with equal losses, 3 GEMM launches per layer GEMM (4 under ``full``),
   the head 3, ``full``'s forward + backward peak below ``none``'s;
   ``full`` at 2 x 4096 tokens for 10 steps with its model-FLOP share
   (``launch/roofline.py``);
   ``attn_chunk`` equal to the unchunked loss, and an eval step on the
   dense flash kernel.  Then training over a mesh (``mesh_train_phase``):
   two gloo ranks on the one card train full olmo-1b through
   ``make_train_step(mesh=...)`` at 1x2 (tensor parallel), 2x1 (FSDP,
   ``remat_policy="full"``) and pod=2 (the int8 pod mean), each step's loss
   equal on both ranks and within a stated bound of the single rank's, the
   block GEMM launched forward and with ``trans_a`` on both ranks; at 2
   layers in f32 every layout's gathered gradients against the single
   rank's; every other family at full width; qwen3-moe-30b-a3b at 2 layers
   on three ranks of their own, 1x2 ``parallel_mode="fsdp"`` (one dispatch
   group over both ranks, capacity dropping choices) and 1x3 (each expert's
   FFN cut), against the single rank, and in f32 their gradients; the GEMM
   at the shards' training shapes;
10. the pod-scale dry run (``dryrun_phase``: meta tensors on a dry mesh,
   nothing allocated on the card) against what the script measured: the
   training phase's cell (its peak within 10 %, its GEMM launches a step
   exactly), the mesh training phase's collectives and bytes a step at
   (a) and (e) exactly, the VLM's bf16 decode step's launches a replay
   exactly; then eight production cells of the 16x16 mesh printed, and
   qwen3-moe ``train_4k`` under ``parallel_mode="fsdp"`` with its dispatch
   groups' count all-gathers;
11. the static analysis (``analysis_phase``): a seeded host read that the
   card's J003 checks must find, then ``repro_torch.analysis.run_analysis(
   modes=("cuda",))`` over every config x quant -- the served entries under
   ``torch.cuda.set_sync_debug_mode``, each engine tick's one device -> host
   copy, the bounds proofs of every kernel through the host build of
   ``kernels/csrc/index.cuh``, the mesh entries, paging, resilience on the
   card -- with no finding; then ``sentinel_phase``: slot decode linear and
   ring, paged decode at the engine's and MLA's shapes, paged chunk split
   (bf16) and f32, dense attention with a window, each at hostile scalars
   with every row the prover says is unread set to NaN, every output finite
   and within ``check_attn`` of the plain version on the clean inputs;
12. a JSON ``added_kernels`` line (the quantize kernels and the int8
   GEMM's row-parallel entries), a JSON
   ``mla_kernels`` line (both decode kernels at the latent shape), a JSON
   ``moe`` line (the MoE phase's summary and its rows), a JSON ``ssm`` line
   (the SSD phases' summaries and the rows at their shapes), a JSON
   ``vlm_encoder`` line (phase 8's summaries) and a ``vlm_encoder_kernels``
   line (its kernel rows), a JSON ``train`` line (phase 9's summary) and a
   ``train_kernels`` line (the GEMM's rows at the training shapes), a JSON
   ``serve`` line (``launch.serve``'s runs), a ``mesh`` line (the mesh
   phase), a ``train_options`` line, a ``mesh_train`` line (the mesh
   training phase), a ``mesh_train_kernels`` line (the GEMM's rows at
   the shards' training shapes) and a ``dryrun`` line (phase 10),
   the script's wall time, a JSON ``analysis`` line (phase 11), a JSON
   ``kernels`` line
   (the six ported TPU kernels, the row quantize and the four row-parallel
   entries), then the JSON result as the last line.

It needs CUDA: without a card it exits 2 before printing anything else.

``python3 chip_smoke.py --kernel-rows TREE [TREE ...]`` instead runs phase
2's kernel rows of each checkout (a tree with its own ``chip_smoke.py`` and
``src/``) in a process of its own, in the order given, and prints each
row's ratio to the first tree's and every ptxas entry that differs: a
change beside its parent in one call (parent, change, change, parent).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

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


def gemm_row_invariance(gen, cases=None):
    """Every output row of the bf16 GEMM is the same f32 sum whatever M is:
    ``block_gemm(A[:M], B)`` equals the first M rows of ``block_gemm(A, B)``
    bit for bit, for M across both tilings (<= 16 and > 16) and past one
    64-row tile, at each engine (K, N) and for the [N, K] head (or at
    ``cases``, (K, N, trans_b) triples); f32 and bf16 out.  This is what
    makes a prompt served alone give the same greedy tokens as in a
    batch."""
    from repro_torch.kernels.block_gemm import block_gemm
    Ms = (1, 8, 16, 17, 33, 64, 72)
    cases = cases or [(2048, 2048, False), (2048, 8192, False), (8192, 2048, False),
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


def _int8_operands(gen, M, K, N, lim):
    a = torch.randint(-lim, lim + 1, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-lim, lim + 1, (N, K), generator=gen, device="cuda", dtype=torch.int8)
    return a, b


def _int8_scales(gen, M, N):
    return (torch.rand(M, 1, generator=gen, device="cuda") * 0.01 + 1e-4,
            torch.rand(1, N, generator=gen, device="cuda") * 0.01 + 1e-4)


def int8_exact(gen, M, K, N):
    """``int8_phase``'s two checks of one shape, tolerance 0: the integer
    case (operands in [-7, 7], unit scales) and the scaled case (full-range
    operands, f32 and bf16 out)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import block_gemm_int8
    a, b = _int8_operands(gen, M, K, N, 7)
    ones_m = torch.ones(M, 1, device="cuda")
    ones_n = torch.ones(1, N, device="cuda")
    check_close(f"block_gemm_int8 exact {M}x{K}x{N}", block_gemm_int8(a, b, ones_m, ones_n),
                ref.block_gemm_int8_ref(a, b, ones_m, ones_n), 0.0, 0.0)
    a, b = _int8_operands(gen, M, K, N, 127)
    sa, sb = _int8_scales(gen, M, N)
    for dt in (torch.float32, torch.bfloat16):
        check_close(f"block_gemm_int8 scaled {dt} {M}x{K}x{N}",
                    block_gemm_int8(a, b, sa, sb, dt),
                    ref.block_gemm_int8_ref(a, b, sa, sb, dt), 0.0, 0.0)


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

    routes = set()
    for (M, K, N) in shapes:
        routes.add(int8_route(M, N, tma_ok=K % 16 == 0))
        int8_exact(gen, M, K, N)
    torch.cuda.synchronize()
    if routes != {0, 1, 2, 3}:
        fail(f"block_gemm_int8: the checked shapes took routes {sorted(routes)}, not all four")
    log(f"block_gemm_int8: {len(shapes)} shapes agree exactly (integer case and "
        f"scaled f32/bf16 out) over all four routes")
    int8_row_invariance(gen)
    rows = []
    for (M, K, N) in timed:
        a, b = _int8_operands(gen, M, K, N, 127)
        sa, sb = _int8_scales(gen, M, N)
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


def int8_row_invariance(gen, cases=None, Ms=(1, 4, 8, 16, 17, 33, 64, 67, 72)):
    """Every output row of the int8 GEMM is the same whatever M is and
    whichever route takes it: ``block_gemm_int8(A[:M], B)`` equals the first
    M rows of the 3072-row product (the wgmma route) bit for bit for M in
    {1, ..., 72} (the two mma.sync routes), f32 and bf16 out, at gemma3-4b's
    and olmo-1b's widths; and each head's rows at M <= 72 against its 72-row
    product (the wgmma route from M = 67 on).  ``cases``: other (K, N,
    full M) triples instead."""
    from repro_torch.kernels.block_gemm import block_gemm_int8, int8_route
    if cases is None:
        cases = [(2560, 2048, 3072), (2560, 10240, 3072), (10240, 2560, 3072),
                 (2560, 262144, 72)]
        cases += [(K, N, 72 if N > 10240 else 3072) for K, N in OLMO_INT8_KN]
    for K, N, full_m in cases:
        a, b = _int8_operands(gen, full_m, K, N, 127)
        sa, sb = _int8_scales(gen, full_m, N)
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
    log(f"block_gemm_int8: rows bit-identical across M in {Ms} and the full M at (K, N, "
        f"full M) {cases}, f32 and bf16 out")


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


# the row-parallel w8a8 GEMM's shapes on a mesh of 2 (olmo-1b): a rank's K
# half of wo (1024 of 2048) and of w_down (4096 of 8192), N = d_model; M: a
# decode step's rows, the decode batch, a chunk, a whole prompt
ROWPAR_KN = ((1024, 2048), (4096, 2048))
ROWPAR_M = (1, 8, 64, 512)
ROWPAR_MAIN = (64, 4096, 2048)  # the kernels line's row: w_down's half at a 64-row chunk
# the int32 partial on every route of int8_route (M, K, N): 16 x 32 tiles
# unsplit, 16-row tiles with K split, 64-row tiles, wgmma 128 x 128 and
# 128 x 256 tiles, and the wgmma tiles' ragged edges with element-wise stores
ROWPAR_ROUTES = ((2, 2048, 50432), (2, 2560, 2048), (64, 4096, 2048), (3072, 2560, 2048),
                 (3072, 2560, 10240), (3000, 2000, 1001))


def _pad32(a):
    """``a`` [M, K] int8 with rows of zeros to 32 when M <= 16 (the least
    M ``torch._int_mm`` takes) and the count of its own rows."""
    M = a.shape[0]
    return (torch.cat([a, a.new_zeros(32 - M, a.shape[1])]) if M <= 16 else a), M


def rowpar_kernel_phase(flush, gen):
    """The entries of the row-parallel int8 GEMM (``core.gemm.
    cgra_gemm_w8a8_row``) at olmo-1b's shard shapes (``ROWPAR_M`` x
    ``ROWPAR_KN``), tolerance 0: the int32 partials of the two K halves
    (``block_gemm_int8_acc``, on the route and split ``int8_route`` /
    ``int8_splits`` pick; first exact on all four routes at
    ``ROWPAR_ROUTES``) sum to the whole-K accumulator and to the plain
    version's; ``int8_epilogue`` of that sum equals the fused
    ``block_gemm_int8`` of the whole K bit for bit, f32 and bf16 out; the
    halves' ``row_amax`` joined by a max, then ``quantize_rows_given`` of
    each half, equal ``quantize_rows`` of the whole row (q and scale, f32
    and bf16 in, with a zero row and exact ties).  Each entry timed beside
    its plain version, the bound and a library call: ``torch._int_mm`` for
    the int32 partial (A padded to 32 rows at M <= 16), ``torch.linalg.
    vector_norm(ord=inf)`` for the row max, none for the epilogue and the
    quantize (no single PyTorch call); ``torch._int_mm`` of the half is
    printed beside every row.  Returns {kernel name: rows}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import (block_gemm_int8, block_gemm_int8_acc,
                                                int8_epilogue, int8_route, int8_splits)
    from repro_torch.kernels.quantize import quantize_rows, quantize_rows_given, row_amax
    routes = set()
    for M, K, N in ROWPAR_ROUTES:
        routes.add(int8_route(M, N, tma_ok=K % 16 == 0))
        a, b = _int8_operands(gen, M, K, N, 127)
        sa, sb = _int8_scales(gen, M, N)
        acc = block_gemm_int8_acc(a, b)
        if not torch.equal(acc, ref.block_gemm_int8_acc_ref(a, b)):
            fail(f"block_gemm_int8_acc {M}x{K}x{N}: differs from the plain version")
        for dt in (torch.float32, torch.bfloat16):
            if not torch.equal(int8_epilogue(acc, sa, sb, dt), block_gemm_int8(a, b, sa, sb, dt)):
                fail(f"int8_epilogue {M}x{K}x{N} {dt}: differs from the fused block_gemm_int8")
    if routes != {0, 1, 2, 3}:
        fail(f"block_gemm_int8_acc: the checked shapes took routes {sorted(routes)}, not all four")
    n = 0
    for M in ROWPAR_M:
        for Kh, N in ROWPAR_KN:
            K = 2 * Kh
            a, b = _int8_operands(gen, M, K, N, 127)
            a[0], b[0] = 127, 127  # an accumulator of K * 127^2, past 2^24
            halves = [(a[:, i * Kh:(i + 1) * Kh].contiguous(),
                       b[:, i * Kh:(i + 1) * Kh].contiguous()) for i in range(2)]
            parts = [block_gemm_int8_acc(x, w) for x, w in halves]
            whole = block_gemm_int8_acc(a, b)
            want = ref.block_gemm_int8_acc_ref(a, b)
            if not (torch.equal(parts[0] + parts[1], want) and torch.equal(whole, want)
                    and torch.equal(parts[0], ref.block_gemm_int8_acc_ref(*halves[0]))):
                fail(f"block_gemm_int8_acc {M}x{K}x{N}: the halves' int32 partials do not "
                     f"sum exactly to the whole-K accumulator")
            sa, sb = _int8_scales(gen, M, N)
            for dt in (torch.float32, torch.bfloat16):
                got = int8_epilogue(parts[0] + parts[1], sa, sb, dt)
                if not (torch.equal(got, block_gemm_int8(a, b, sa, sb, dt))
                        and torch.equal(got, ref.int8_epilogue_ref(want, sa, sb, dt))):
                    fail(f"int8_epilogue {M}x{K}x{N} {dt}: differs from the fused "
                         f"block_gemm_int8 of the whole K")
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(M, K, generator=gen, device="cuda").to(dt)
                if M > 2:
                    x[1] = 0.0
                    x[2, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -1.5, 126.5])
                xs = [x[:, :Kh].contiguous(), x[:, Kh:].contiguous()]
                amaxes = [row_amax(h) for h in xs]
                if not all(torch.equal(m, ref.row_amax_ref(h)) for m, h in zip(amaxes, xs)):
                    fail(f"row_amax {M}x{Kh} {dt}: differs from the plain version")
                amax = torch.maximum(*amaxes)
                qs = [quantize_rows_given(h, amax) for h in xs]
                q, scale = quantize_rows(x)
                if not (torch.equal(torch.cat([qs[0][0], qs[1][0]], 1), q)
                        and all(torch.equal(sc, scale) for _, sc in qs)
                        and all(torch.equal(g[0], r[0]) and torch.equal(g[1], r[1])
                                for g, r in zip(qs, (ref.quantize_rows_given_ref(h, amax)
                                                     for h in xs)))):
                    fail(f"quantize_rows_given {M}x{Kh} {dt}: the halves quantized with the "
                         f"joined row max differ from quantize_rows of the whole row")
            n += 1
    torch.cuda.synchronize()
    log(f"row-parallel int8 entries: the int32 partial exact and its epilogue equal to the "
        f"fused product on all four routes at {ROWPAR_ROUTES}; "
        f"{n} shapes (M {ROWPAR_M} x (K half, N) {ROWPAR_KN}) -- "
        f"the int32 partials sum exactly to the whole-K accumulator, the epilogue of the sum "
        f"equals the fused block_gemm_int8 (f32 and bf16 out), row_amax + "
        f"quantize_rows_given of the halves equal quantize_rows (f32 and bf16 in)")
    rows = {"block_gemm_int8_acc": [], "int8_epilogue": [], "row_amax": [],
            "quantize_rows_given": []}
    for M in ROWPAR_M:
        for K, N in ROWPAR_KN:
            a, b = _int8_operands(gen, M, K, N, 127)
            sa, sb = _int8_scales(gen, M, N)
            ap, m_own = _pad32(a)
            bt = b.T
            lib_mm = time_ms(lambda: torch._int_mm(ap, bt), flush)
            acc = block_gemm_int8_acc(a, b)
            route = int8_route(M, N)
            shape = f"{M}x{K}x{N}"
            ms = time_ms(lambda: block_gemm_int8_acc(a, b), flush)
            plain = time_ms(lambda: ref.block_gemm_int8_acc_ref(a, b), flush, reps=5)
            bms, by = bound_ms(M * K + N * K + 4 * M * N, 2 * M * N * K, torch.int8)
            rows["block_gemm_int8_acc"].append(dict(
                shape=shape, ms=ms, plain_ms=plain, library_ms=lib_mm,
                library="torch._int_mm" + (", A padded to 32 rows" if M <= 16 else ""),
                bound_ms=bms, bound_by=by, route=route,
                splits=int8_splits(K, N) if route < 2 else 1))
            # the epilogue does not read K: one row an (M, N)
            e_ms = time_ms(lambda: int8_epilogue(acc, sa, sb, torch.bfloat16), flush)
            e_plain = time_ms(lambda: ref.int8_epilogue_ref(acc, sa, sb, torch.bfloat16), flush)
            e_bms, e_by = bound_ms(4 * M * N + 4 * (M + N) + 2 * M * N, 2 * M * N,
                                   torch.float32)
            if K == ROWPAR_MAIN[1]:
                rows["int8_epilogue"].append(dict(shape=f"{M}x{N} bf16 out", ms=e_ms,
                                                  plain_ms=e_plain, library_ms=None,
                                                  bound_ms=e_bms, bound_by=e_by))
            x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            amax = row_amax(x)
            m_ms = time_ms(lambda: row_amax(x), flush)
            m_plain = time_ms(lambda: ref.row_amax_ref(x), flush)
            m_lib = time_ms(lambda: torch.linalg.vector_norm(
                x, float("inf"), dim=1, keepdim=True, dtype=torch.float32), flush)
            m_bms, m_by = bound_ms(M * K * 2 + 4 * M, 0, torch.bfloat16)
            rows["row_amax"].append(dict(shape=f"{M}x{K} bf16", ms=m_ms, plain_ms=m_plain,
                                         library_ms=m_lib, bound_ms=m_bms, bound_by=m_by))
            g_ms = time_ms(lambda: quantize_rows_given(x, amax), flush)
            g_plain = time_ms(lambda: ref.quantize_rows_given_ref(x, amax), flush)
            g_bms, g_by = bound_ms(M * K * 2 + 4 * M + M * K + 4 * M, 0, torch.bfloat16)
            rows["quantize_rows_given"].append(dict(shape=f"{M}x{K} bf16", ms=g_ms,
                                                    plain_ms=g_plain, library_ms=None,
                                                    bound_ms=g_bms, bound_by=g_by))
            log(f"  row-parallel M={M} K={K} N={N}: int32 partial {ms:.4f} ms (route {route}, "
                f"plain {plain:.4f}, bound {bms:.4f} {by}), epilogue bf16 {e_ms:.4f} ms "
                f"(plain {e_plain:.4f}, bound {e_bms:.4f} {e_by}), row_amax {m_ms:.4f} ms "
                f"(plain {m_plain:.4f}, vector_norm {m_lib:.4f}, bound {m_bms:.4f}), "
                f"quantize_rows_given {g_ms:.4f} ms (plain {g_plain:.4f}, bound {g_bms:.4f}); "
                f"torch._int_mm of the half {lib_mm:.4f} ms"
                + (f" (A padded from {m_own} to 32 rows)" if M <= 16 else ""))
    return rows


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
        # hubert-xlarge: bidirectional at head dim 80 (padded to 128 on the
        # tensor cores: columns 80-127 of every tile must be zero), G = 1;
        # llama-3.2-vision-11b's cross-attention: one query row (decode) and
        # a prompt over the image's 1601 keys, G = 4
        ("bidirectional d80 G1 S65", 2, 65, 65, False, 0, 0.0, 16, 16, 80),
        ("bidirectional d80 G1 S1000", 1, 1000, 1000, False, 0, 0.0, 16, 16, 80),
        ("cross Sq1 Sk1601 d128 G4", 2, 1, 1601, False, 0, 0.0, 32, 8, 128),
        ("cross Sq500 Sk1601 d128 G4", 1, 500, 1601, False, 0, 0.0, 32, 8, 128),
        # olmo-1b's eval step at the reference's training length (the
        # training-options phase): causal, G = 1, the whole query block
        ("olmo eval S4096 d128 G1", 2, 4096, 4096, True, 0, 0.0, 16, 16, 128),
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
    return _bf16_max(err), _paged_decode_row(flush, gen, 16, 16, pos8, start8, 1)


def _paged_decode_row(flush, gen, H, K, pos, start, seed):
    """One bf16 paged flash-decode call (``len(pos)`` slots, H query heads
    over K kv-heads of 128, 1024-row tables of page size 64) timed beside
    its plain version, SDPA on K/V gathered from the pages beforehand (live
    rows as a boolean mask; the gather not timed) and the bound.  Returns
    the row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode_paged
    d, ps = 128, 64
    B, npp = len(pos), 1024 // ps
    P = B * npp + 1
    pos_l, start_l = pos, start
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    start = torch.tensor(start_l, dtype=torch.int32, device="cuda")
    pages = _tables(B, npp, P, seed)
    k, v = _paged_pools(gen, P, ps, K, d, torch.bfloat16)
    q = torch.randn(B, H, d, generator=gen, device="cuda").bfloat16()
    ms = time_ms(lambda: flash_decode_paged(q, k, v, pos, start, pages), flush)
    plain = time_ms(lambda: ref.flash_decode_ref(q, k, v, pos, start, pages=pages),
                    flush)
    kg, vg = _gathered(k, pages), _gathered(v, pages)
    mask = _live_mask(pos, start, npp * ps, False)[:, None, None, :]
    q4 = q[:, :, None]
    lib_fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q4, kg, vg, attn_mask=mask, enable_gqa=True)
    lib = time_ms(lib_fn, flush)
    want = ref.flash_decode_ref(q, k, v, pos, start, pages=pages)
    live_slots = [i for i in range(B) if start_l[i] <= pos_l[i]]
    lib_rel = check_rows("SDPA yardstick paged decode", lib_fn()[live_slots, :, 0],
                         want[live_slots], rtol=math.inf)[1]
    live = sum(max(0, min(p, npp * ps - 1) - s + 1) for p, s in zip(pos_l, start_l))
    n_bytes = 2 * (2 * live * K * d + 2 * B * H * d) + 4 * (B * npp + 2 * B)
    bms, by = bound_ms(n_bytes, 4 * live * H * d, torch.bfloat16)
    log(f"  flash_decode_paged bf16 B={B} H={H} K={K} d={d} ps={ps} live rows={live}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA on pre-gathered K/V + mask "
        f"{lib:.4f} ms (gather not timed; row relative error vs plain {lib_rel:.3e}), bound "
        f"{bms:.4f} ms ({by})")
    kv = f" K{K}" if K != H else ""  # earlier rows (K = H) keep their names
    return dict(shape=f"B{B} H{H}{kv} d{d} ps{ps} live{live}", ms=ms, plain_ms=plain,
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
    return _bf16_max(err), _paged_chunk_row(flush, gen, 16, 16, 3)


def _paged_chunk_row(flush, gen, H, K, seed):
    """One bf16 paged chunk-attention call (one slot, a 64-row chunk at
    q_start 448 with every row valid, H query heads over K kv-heads of 128,
    a 1024-row table of page size 64) timed beside its plain version, SDPA
    on K/V gathered from the pages beforehand (causal-at-offset and live
    rows as a boolean mask; the gather not timed) and the bound.  Returns
    the row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_paged
    d, ps, C, qs, n = 128, 64, 64, 448, 64
    npp, P = 1024 // ps, 8 * (1024 // ps) + 1
    k, v = _paged_pools(gen, P, ps, K, d, torch.bfloat16)
    q = torch.randn(1, H, C, d, generator=gen, device="cuda").bfloat16()
    pages = _tables(1, npp, P, seed)
    q_start = torch.tensor([qs], dtype=torch.int32, device="cuda")
    k_len = q_start + n
    ms = time_ms(lambda: flash_attention_paged(q, k, v, pages, q_start, k_len), flush)
    plain = time_ms(lambda: ref.flash_attention_paged_ref(q, k, v, pages, q_start,
                                                          k_len), flush)
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
    n_bytes = 2 * (2 * (qs + n) * K * d + 2 * H * C * d) + 4 * (npp + 2)
    bms, by = bound_ms(n_bytes, 4 * H * keys * d, torch.bfloat16)
    log(f"  flash_attention_paged bf16 C={C} H={H} K={K} d={d} q_start={qs} k_len={qs + n}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA on pre-gathered K/V + mask "
        f"{lib:.4f} ms (gather not timed; row relative error vs plain {lib_rel:.3e}), bound "
        f"{bms:.4f} ms ({by})")
    kv = f" K{K}" if K != H else ""  # earlier rows (K = H) keep their names
    return dict(shape=f"C{C} H{H}{kv} d{d} q_start{qs} k_len{qs + n}", ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


# ---------------------------------------------------------------------------
# phase 2, MLA (minicpm3-4b): the latent decode shape and the new GEMM shapes
# ---------------------------------------------------------------------------

# minicpm3-4b's latent decode call: 40 query heads over one kv-head, q and
# the fused [latent | k_rope] cache 256 + 32 wide, v the cache's first 256
# columns, scale (qk_nope 64 + qk_rope 32)^-0.5
MLA_H, MLA_DQ, MLA_DV, MLA_SCALE = 40, 288, 256, 96 ** -0.5
# an engine decode state of the full-width phase (prompts 100-500, 16 tokens in)
MLA_POS = [136, 349, 496, 221, 116, 276, 431, 516]


def _mla_decode_row(name, fn, plain, lib_fn, want, flush, pos, start, table_bytes):
    """Time one latent-shape decode call beside its plain version and SDPA,
    with the bound; the SDPA output's row error against the plain version
    is printed (no gate: it is the yardstick)."""
    ms, plain_ms, lib = time_ms(fn, flush), time_ms(plain, flush), time_ms(lib_fn, flush)
    lib_rel = check_rows(f"SDPA yardstick {name}", lib_fn()[:, :, 0], want, rtol=math.inf)[1]
    B = len(pos)
    live = sum(max(0, min(p, 1023) - s + 1) for p, s in zip(pos, start))
    # q, the live cache rows (k and v are one tensor: read once), out, pos/start
    n_bytes = 2 * (B * MLA_H * MLA_DQ + live * MLA_DQ + B * MLA_H * MLA_DV) + 8 * B \
        + table_bytes
    bms, by = bound_ms(n_bytes, 2 * live * MLA_H * (MLA_DQ + MLA_DV), torch.bfloat16)
    log(f"  {name} bf16 B={B} H={MLA_H} Kh=1 dq={MLA_DQ} dv={MLA_DV} ({live} live rows): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA (GQA, Ev != E, live-row mask) "
        f"{lib:.4f} ms (row relative error vs plain {lib_rel:.3e}), bound {bms:.4f} ms ({by})")
    return dict(shape=f"B{B} H{MLA_H} Kh1 dq{MLA_DQ} dv{MLA_DV} live{live}", ms=ms,
                plain_ms=plain_ms, library_ms=lib, bound_ms=bms, bound_by=by)


def mla_decode_phase(flush, gen):
    """Slot and paged flash-decode at minicpm3-4b's latent call: B = 8, H =
    40 over Kh = 1 (five head groups of 8), dq = 288, dv = 256, v is k,
    f32 and bf16, on a linear slot cache of 1024 rows and on pools of page
    size 16 and 64 (1024-row tables).  Tolerances (``check_attn``): f32
    2e-5 elementwise, bf16 2^-7 per row; the empty slot (start > pos) is
    exactly 0, a frozen full slot (pos = 1024) reads all its rows, every
    slot of a batched call equals its call alone bit for bit, and a repeated
    slot-cache call gives the same bits.  Then each layout timed in bf16 at
    an engine decode state beside its plain version, SDPA on K/V gathered
    from the cache (GQA over the one kv-head, Ev 256 != E 288; the gather
    not timed) and the bound.  Returns (max bf16 error, {layout: row})."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (flash_decode, flash_decode_paged,
                                                      head_groups)
    B, S = 8, 1024
    pos, start = [3, 100, 257, 511, 700, 1024, 63, 5], [0, 0, 0, 200, 0, 0, 0, 6]
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    st = torch.tensor(start, dtype=torch.int32, device="cuda")
    kw = dict(scale=MLA_SCALE, dv=MLA_DV)
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, MLA_H, MLA_DQ, generator=gen, device="cuda").to(dtype)
        kv = torch.randn(B, S, 1, MLA_DQ, generator=gen, device="cuda").to(dtype)
        cases = [("linear1024", lambda sl: flash_decode(q[sl], kv[sl], kv[sl], p[sl], st[sl], **kw),
                  ref.flash_decode_ref(q, kv, kv, p, st, **kw))]
        for ps in (16, 64):
            npp = S // ps
            P = B * npp + 1
            pages = _tables(B, npp, P, 40 + ps)
            pool = torch.randn(P, ps, 1, MLA_DQ, generator=gen, device="cuda").to(dtype)
            cases.append((f"pool ps{ps}", lambda sl, pool=pool, pages=pages: flash_decode_paged(
                q[sl], pool, pool, p[sl], st[sl], pages[sl], **kw),
                ref.flash_decode_ref(q, pool, pool, p, st, pages=pages, **kw)))
        for name, call, want in cases:
            got = call(slice(0, B))
            err[(dtype, name)] = check_attn(f"MLA flash-decode {dtype} {name}", got, want, dtype)
            if float(got[7].abs().max()) != 0.0:
                fail(f"MLA flash-decode {dtype} {name}: the empty slot is not exactly 0")
            if name.startswith("linear") and not torch.equal(got, call(slice(0, B))):
                fail(f"MLA flash-decode {dtype} {name}: a repeated call differs")
            _slot_invariance(f"MLA flash-decode {dtype} {name}", call, B)
    torch.cuda.synchronize()
    log(f"MLA flash-decode (G = {MLA_H}, {head_groups(MLA_H, MLA_DQ)} head groups, dq {MLA_DQ}, "
        f"dv {MLA_DV}, v is k): linear slot cache and pools of page size 16 and 64 x "
        f"(f32, bf16) agree, empty slot exactly 0, every slot alone == batched, repeated "
        f"slot calls bit-equal; " + _errs(err))
    rows = {}
    p = torch.tensor(MLA_POS, dtype=torch.int32, device="cuda")
    st = torch.zeros(B, dtype=torch.int32, device="cuda")
    q = torch.randn(B, MLA_H, MLA_DQ, generator=gen, device="cuda").bfloat16()
    mask = _live_mask(p, st, S, False)[:, None, None, :]
    q4 = q[:, :, None]
    kv = torch.randn(B, S, 1, MLA_DQ, generator=gen, device="cuda").bfloat16()
    kt = kv.transpose(1, 2).contiguous()
    vt = kt[..., :MLA_DV].contiguous()
    rows["slot"] = _mla_decode_row(
        "MLA flash_decode linear S1024", lambda: flash_decode(q, kv, kv, p, st, **kw),
        lambda: ref.flash_decode_ref(q, kv, kv, p, st, **kw),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True, scale=MLA_SCALE),
        ref.flash_decode_ref(q, kv, kv, p, st, **kw), flush, MLA_POS, [0] * B, 0)
    del kv, kt, vt
    ps = 64
    npp, P = S // ps, B * (S // ps) + 1
    pages = _tables(B, npp, P, 7)
    pool = torch.randn(P, ps, 1, MLA_DQ, generator=gen, device="cuda").bfloat16()
    kg = _gathered(pool, pages)
    vg = kg[..., :MLA_DV].contiguous()
    rows["paged"] = _mla_decode_row(
        "MLA flash_decode_paged ps64",
        lambda: flash_decode_paged(q, pool, pool, p, st, pages, **kw),
        lambda: ref.flash_decode_ref(q, pool, pool, p, st, pages=pages, **kw),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True, scale=MLA_SCALE),
        ref.flash_decode_ref(q, pool, pool, p, st, pages=pages, **kw), flush, MLA_POS,
        [0] * B, 4 * B * npp)
    return _bf16_max(err), rows


# every bf16 GEMM of minicpm3-4b (K, N): wq_a, wq_b, wkv_a, wkv_b (prefill's
# latent expansion), wo, w_gate / w_up, w_down, the head
MINICPM_BF16_KN = ((2560, 768), (768, 3840), (2560, 288), (256, 5120), (2560, 2560),
                   (2560, 6400), (6400, 2560), (2560, 73472))
# its w8a8 GEMMs: wq_a, wkv_a, wo, w_gate / w_up, w_down, the head (wq_b and
# wkv_b stay float)
MINICPM_INT8_KN = ((2560, 768), (2560, 288), (2560, 2560), (2560, 6400), (6400, 2560),
                   (2560, 73472))
# the M the int8 GEMM meets on the MLA path: decode batches, and whole
# prefills of 100-500 rows (the head's prefill M is 1: the last row)
MINICPM_INT8_M = (1, 4, 8, 67, 100, 120, 205, 333, 480, 500)


def mla_gemm_phase(flush, gen):
    """The GEMMs at minicpm3-4b's (K, N) pairs.  bf16 GEMM, M in {1, 8, 64,
    500}, against the plain version with ``gemm_phase``'s tolerances (bf16
    out: 1e-4 + 2^-7 relative; bf16 -> f32 and f32: 1e-4 + 1e-5), rows
    bit-identical across M (``gemm_row_invariance``); int8 GEMM exactly
    (``int8_phase``'s integer and scaled cases, tolerance 0) at every w8a8
    pair for the M of ``MINICPM_INT8_M``, over every route ``int8_route``
    picks for them.  Each pair timed at M = 8 (decode) and M = 500 (prefill)
    beside the plain version, the library call and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import (block_gemm, block_gemm_int8, gemm_splits,
                                                int8_route)
    n = 0
    for K, N in MINICPM_BF16_KN:
        for M in (1, 8, 64, 500):
            a = torch.randn(M, K, generator=gen, device="cuda")
            b = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
            check_close(f"block_gemm f32 {M}x{K}x{N}", block_gemm(a, b),
                        ref.block_gemm_ref(a, b), 1e-4, 1e-5)
            ab, bb = a.bfloat16(), b.bfloat16()
            check_close(f"block_gemm bf16 {M}x{K}x{N}", block_gemm(ab, bb),
                        ref.block_gemm_ref(ab, bb), 1e-4, 2.0 ** -7)
            check_close(f"block_gemm bf16->f32 {M}x{K}x{N}",
                        block_gemm(ab, bb, out_dtype=torch.float32),
                        ref.block_gemm_ref(ab, bb, torch.float32), 1e-4, 1e-5)
            n += 1
    torch.cuda.synchronize()
    log(f"block_gemm at minicpm3-4b's (K, N): {n} shapes x (f32, bf16, bf16->f32) agree")
    gemm_row_invariance(gen, [(K, N, False) for K, N in MINICPM_BF16_KN])
    routes, n = set(), 0
    for K, N in MINICPM_INT8_KN:
        for M in MINICPM_INT8_M:
            routes.add(int8_route(M, N, tma_ok=K % 16 == 0))
            int8_exact(gen, M, K, N)
            n += 1
    torch.cuda.synchronize()
    log(f"block_gemm_int8 at minicpm3-4b's w8a8 (K, N): {n} shapes exact (integer and scaled, "
        f"f32 and bf16 out) over routes {sorted(routes)}, every route int8_route picks for "
        f"M in {MINICPM_INT8_M}")
    rows = {"bf16": [], "int8": []}
    for K, N in MINICPM_BF16_KN:
        for M in (8, 500):
            a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            b = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)).bfloat16()
            out_dtype = torch.float32 if N == 73472 else torch.bfloat16
            ms = time_ms(lambda: block_gemm(a, b, out_dtype=out_dtype), flush)
            plain = time_ms(lambda: ref.block_gemm_ref(a, b, out_dtype), flush)
            lib = time_ms(lambda: torch.matmul(a, b), flush)
            out_bytes = M * N * (4 if out_dtype == torch.float32 else 2)
            bms, by = bound_ms(2 * (M * K + K * N) + out_bytes, 2 * M * N * K, torch.bfloat16)
            rows["bf16"].append(dict(shape=f"{M}x{K}x{N}", ms=ms, plain_ms=plain,
                                     library_ms=lib, bound_ms=bms, bound_by=by))
            log(f"  block_gemm bf16 {M}x{K}x{N} (K split {gemm_splits(K, N)}): kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, torch.matmul {lib:.4f} ms, bound "
                f"{bms:.4f} ms ({by})")
    for K, N in MINICPM_INT8_KN:
        for M in (8, 500):
            a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
            b = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
            sa = torch.rand(M, 1, generator=gen, device="cuda") * 0.01 + 1e-4
            sb = torch.rand(1, N, generator=gen, device="cuda") * 0.01 + 1e-4
            out_dtype = torch.float32 if N == 73472 else torch.bfloat16
            ms = time_ms(lambda: block_gemm_int8(a, b, sa, sb, out_dtype), flush)
            plain = time_ms(lambda: ref.block_gemm_int8_ref(a, b, sa, sb, out_dtype), flush,
                            reps=5)
            bt = b.T
            a32 = a if M > 16 else torch.cat([a, a.new_zeros(32 - M, K)])
            lib = time_ms(lambda: (torch._int_mm(a32, bt)[:M].float() * sa * sb).to(
                out_dtype), flush)
            out_bytes = M * N * (4 if out_dtype == torch.float32 else 2)
            bms, by = bound_ms(M * K + N * K + 4 * (M + N) + out_bytes, 2 * M * N * K,
                               torch.int8)
            route = int8_route(M, N)
            rows["int8"].append(dict(shape=f"{M}x{K}x{N}", ms=ms, plain_ms=plain,
                                     library_ms=lib, bound_ms=bms, bound_by=by, route=route))
            log(f"  block_gemm_int8 M={M} K={K} N={N} (route {route}): kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, torch._int_mm+epilogue{' (A padded to 32 rows)' if M <= 16 else ''} "
                f"{lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


# ---------------------------------------------------------------------------
# phase 2, MoE (qwen3-moe-30b-a3b): the GEMM and attention shapes of its path
# ---------------------------------------------------------------------------

# every bf16 GEMM of qwen3-moe-30b-a3b (K, N): wq, wk / wv, wo and the untied
# head (f32 out); the routers and the experts are the reference's einsums
# (an f32 matmul, batched matmuls), no kernel
QWEN_BF16_KN = ((2048, 4096), (2048, 512), (4096, 2048), (2048, 152064))
# the M they meet: one slot, the decode batch, a chunk buffer, the direct
# prefill (2 x 300 rows)
QWEN_M = (1, 8, 64, 600)
# the M the w8a8 engine's int8 GEMMs meet: decode ticks (1-8) and chunks
# (64-67, where the 152064-column head turns to the wgmma route)
QWEN_INT8_M = (1, 4, 8, 64, 67)
# qwen3's attention: 32 query heads over 4 kv-heads of 128; an engine decode
# state of the full-width phase (prompts 100-500, 16 tokens in)
QWEN_H, QWEN_K, QWEN_D = 32, 4, 128
QWEN_POS = [516, 136, 324, 349, 401, 496, 454, 221]


def moe_kernel_phase(flush, gen):
    """The kernels of the MoE path at qwen3-moe-30b-a3b's shapes.  bf16
    GEMM at its four (K, N) for M in ``QWEN_M`` against the plain version
    (``gemm_phase``'s tolerances: bf16 out 1e-4 + 2^-7 relative, f32 out
    1e-4 + 1e-5), rows bit-identical across M.  int8 GEMM at the same four
    (K, N) for M in ``QWEN_INT8_M`` exactly (``int8_exact``: the integer
    and the scaled case, tolerance 0) over every route ``int8_route`` picks
    for them, rows bit-identical across those M and M = 600.  Paged
    flash-decode (B = 8, 32 heads over 4, d = 128, page size 64, an empty
    slot and a frozen full one) and paged chunk attention (C = 64, three
    slots: a first chunk, one at q_start 448, a partial one); slot
    flash-decode on the direct loop's linear caches (B = 2, S = 512, both
    slots live, then one empty; a repeated call bit-equal); dense causal
    flash attention at the direct prefill (B = 2, S = 300): each in f32 and
    bf16 against its plain version (``check_attn``), empty slots exactly 0,
    every paged or slot call's slot alone == batched bit for bit.  Every
    bf16 GEMM row and both paged attention calls in bf16 timed beside the
    plain version, the library call (``torch.matmul``; SDPA on K/V
    gathered from the pages beforehand, the gather not timed) and the
    bound.  Returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import block_gemm, gemm_splits, int8_route
    from repro_torch.kernels.decode_attention import flash_decode, flash_decode_paged
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_paged
    rows = {"gemm": []}
    Mx = max(QWEN_M)
    for K, N in QWEN_BF16_KN:
        out_dtype = torch.float32 if N == 152064 else torch.bfloat16
        a = torch.randn(Mx, K, generator=gen, device="cuda").bfloat16()
        b = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)).bfloat16()
        full = block_gemm(a, b, out_dtype=out_dtype)
        check_close(f"block_gemm bf16 {Mx}x{K}x{N}", full, ref.block_gemm_ref(a, b, out_dtype),
                    1e-4, 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5)
        for M in QWEN_M:
            am = a[:M].contiguous()
            if not torch.equal(block_gemm(am, b, out_dtype=out_dtype), full[:M]):
                fail(f"block_gemm bf16 rows differ between M={M} and M={Mx} at K={K} N={N}")
            ms = time_ms(lambda: block_gemm(am, b, out_dtype=out_dtype), flush)
            plain = time_ms(lambda: ref.block_gemm_ref(am, b, out_dtype), flush)
            lib = time_ms(lambda: torch.matmul(am, b), flush)
            out_bytes = M * N * (4 if out_dtype == torch.float32 else 2)
            bms, by = bound_ms(2 * (M * K + K * N) + out_bytes, 2 * M * N * K, torch.bfloat16)
            rows["gemm"].append(dict(shape=f"{M}x{K}x{N}", ms=ms, plain_ms=plain,
                                     library_ms=lib, bound_ms=bms, bound_by=by))
            log(f"  block_gemm bf16 {M}x{K}x{N} (K split {gemm_splits(K, N)}): kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, torch.matmul {lib:.4f} ms, bound "
                f"{bms:.4f} ms ({by})")
    torch.cuda.synchronize()
    log(f"block_gemm at qwen3-moe's (K, N) {list(QWEN_BF16_KN)}: agree at M = {Mx}, rows "
        f"bit-identical for M in {QWEN_M}")
    routes = set()
    for K, N in QWEN_BF16_KN:
        for M in QWEN_INT8_M + (Mx,):
            routes.add(int8_route(M, N, tma_ok=K % 16 == 0))
            if M != Mx:
                int8_exact(gen, M, K, N)
    torch.cuda.synchronize()
    log(f"block_gemm_int8 at qwen3-moe's w8a8 (K, N): {len(QWEN_BF16_KN) * len(QWEN_INT8_M)} "
        f"shapes exact (integer and scaled, f32 and bf16 out) for M in {QWEN_INT8_M}; routes "
        f"{sorted(routes)} with M = {Mx}")
    int8_row_invariance(gen, [(K, N, Mx) for K, N in QWEN_BF16_KN], QWEN_INT8_M)

    H, K, d, ps, max_len = QWEN_H, QWEN_K, QWEN_D, 64, 1024
    B, npp = len(QWEN_POS), max_len // ps
    P = B * npp + 1
    pages = _tables(B, npp, P, 60)
    err = {}
    # decode: the engine state, with an empty slot (start > pos) and a frozen
    # full one (pos = npp * ps) in place of two of its slots
    pos = torch.tensor(QWEN_POS[:6] + [1024, 9], dtype=torch.int32, device="cuda")
    start = torch.tensor([0] * 7 + [10], dtype=torch.int32, device="cuda")
    # chunk: a first chunk, a chunk at q_start 448, a partial one
    qs, n = [0, 448, 200], [64, 64, 40]
    q_start = torch.tensor(qs, dtype=torch.int32, device="cuda")
    k_len = q_start + torch.tensor(n, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        k, v = _paged_pools(gen, P, ps, K, d, dtype)
        q = torch.randn(B, H, d, generator=gen, device="cuda").to(dtype)
        got = flash_decode_paged(q, k, v, pos, start, pages)
        err[(dtype, "decode")] = check_attn(f"flash_decode_paged qwen3 {dtype}", got,
                                            ref.flash_decode_ref(q, k, v, pos, start,
                                                                 pages=pages), dtype)
        if float(got[7].abs().max()) != 0.0:
            fail(f"flash_decode_paged qwen3 {dtype}: the empty slot is not exactly 0")
        _slot_invariance(f"flash_decode_paged qwen3 {dtype}", lambda sl: flash_decode_paged(
            q[sl], k, v, pos[sl], start[sl], pages[sl]), B)
        qc = torch.randn(3, 64, H, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        got = flash_attention_paged(qc, k, v, pages[:3], q_start, k_len)
        want = ref.flash_attention_paged_ref(qc, k, v, pages[:3], q_start, k_len)
        e = [check_attn(f"flash_attention_paged qwen3 {dtype} slot {i}", got[i, :, : n[i]],
                        want[i, :, : n[i]], dtype) for i in range(3)]
        err[(dtype, "chunk")] = (max(a for a, _ in e), max(r for _, r in e))
        _slot_invariance(f"flash_attention_paged qwen3 {dtype}", lambda sl: flash_attention_paged(
            qc[sl], k, v, pages[sl], q_start[sl], k_len[sl]), 3)
    # the direct loop: slot caches of 512 rows, prompts of 300 plus decode
    # steps; then one slot empty (start > pos)
    S = 512
    slot_cases = (([307, 511], [0, 0]), ([300, 4], [0, 5]))
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (pl, sl) in enumerate(slot_cases):
            q = torch.randn(2, H, d, generator=gen, device="cuda").to(dtype)
            ks = torch.randn(2, S, K, d, generator=gen, device="cuda").to(dtype)
            vs = torch.randn(2, S, K, d, generator=gen, device="cuda").to(dtype)
            p = torch.tensor(pl, dtype=torch.int32, device="cuda")
            st = torch.tensor(sl, dtype=torch.int32, device="cuda")
            got = flash_decode(q, ks, vs, p, st)
            err[(dtype, f"slot{ci}")] = check_attn(f"flash_decode qwen3 {dtype} case {ci}", got,
                                                   ref.flash_decode_ref(q, ks, vs, p, st), dtype)
            if not torch.equal(got, flash_decode(q, ks, vs, p, st)):
                fail(f"flash_decode qwen3 {dtype} case {ci}: a repeated call differs")
            for i in range(2):
                if sl[i] > pl[i] and float(got[i].abs().max()) != 0.0:
                    fail(f"flash_decode qwen3 {dtype}: the empty slot is not exactly 0")
            _slot_invariance(f"flash_decode qwen3 {dtype} case {ci}", lambda b: flash_decode(
                q[b], ks[b], vs[b], p[b], st[b]), 2)
        # the direct prefill: [B, S, heads, d] transposed, as the layers pass it
        qd, kd, vd = (torch.randn(2, 300, h, d, generator=gen, device="cuda").to(dtype)
                      .transpose(1, 2) for h in (H, K, K))
        err[(dtype, "dense")] = check_attn(f"flash_attention qwen3 {dtype}",
                                           flash_attention(qd, kd, vd),
                                           ref.flash_attention_ref(qd, kd, vd), dtype)
    torch.cuda.synchronize()
    log(f"paged decode and chunk attention, slot decode and dense attention at qwen3's heads "
        f"(H {H} over K {K}, d {d}, ps {ps}) x (f32, bf16) agree, empty slots exactly 0, every "
        f"slot alone == batched, repeated slot calls bit-equal; " + _errs(err))
    rows["attn_max_abs_err_bf16"] = _bf16_max(err)
    rows["decode"] = _paged_decode_row(flush, gen, H, K, QWEN_POS, [0] * B, 61)
    rows["chunk"] = _paged_chunk_row(flush, gen, H, K, 62)
    return rows


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
    the graph).  A step advances SSD state (``g.state``) in place: each run
    starts from the same saved state, and the state a replay leaves must
    equal the eager run's bit for bit too; the saved state is put back at
    the end.  Returns {counter: launches a replay}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_gemm import int8_route
    from repro_torch.kernels.decode_attention import decode_scratch, flash_decode
    from repro_torch.kernels.ops import LAUNCH_COUNTERS
    B = g.cur.numel()
    widths = sorted({t.q.shape[-2] for t in _qtensors(g.params)})
    if any(int8_route(B, n) >= 2 for n in widths):
        fail(f"{name}: an int8 GEMM of the graph would take the TMA route")

    def same(a, b):
        return all(torch.allclose(x, y, rtol=0, atol=0, equal_nan=True) for x, y in zip(a, b))

    saved = [t.clone() for t in g.state]

    def reset():
        for t, old in zip(g.state, saved):
            t.copy_(old)

    load()
    first = tuple(t.clone() for t in g.run())
    first_state = [t.clone() for t in g.state]
    reset()
    before = {c: c.launches for c in LAUNCH_COUNTERS}
    eager = g.eager()
    eager_n = {c.__name__: c.launches - before[c] for c in LAUNCH_COUNTERS
               if c.launches != before[c]}
    per_replay = {c.__name__: n for c, n in g.per_replay.items()}
    if not same(eager, first) or not same(g.state, first_state):
        fail(f"{name}: graph replay differs from the eager step (outputs or state)")
    if eager_n != per_replay:
        fail(f"{name}: eager step launches {eager_n}, a replay counts {per_replay}")
    held = [p.data_ptr() for p, _ in _build.stream_scratch(g.stream.cuda_stream)]
    # streams come from PyTorch's pool: an earlier graph's check may have
    # grown this stream's entry already, so the call outgrows what it holds
    have = max((p.numel() for p, _ in _build.stream_scratch(g.stream.cuda_stream)), default=0)
    S = 4096
    while decode_scratch(16, 16, 16, S, 128)[0] <= have:
        S *= 2
    q = torch.randn(16, 16, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(16, S, 16, 128, generator=gen, device="cuda").bfloat16()
    pos = torch.full((16,), S - 1, dtype=torch.int32, device="cuda")
    g.stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(g.stream):
        flash_decode(q, k, k, pos, None)
    flash_decode(q, k, k, pos, None)
    torch.cuda.synchronize()
    grown = [p.data_ptr() for p, _ in _build.stream_scratch(g.stream.cuda_stream)]
    del q, k
    if grown == held:
        fail(f"{name}: the larger call did not grow the graph stream's scratch")
    reset()
    before = {c: c.launches for c in LAUNCH_COUNTERS}
    load()
    again = g.run()
    delta = {c.__name__: c.launches - before[c] for c in LAUNCH_COUNTERS
             if c.launches != before[c]}
    if not same(again, first) or not same(g.state, first_state):
        fail(f"{name}: a replay after a larger eager call differs (outputs or state)")
    reset()
    if delta != per_replay:
        fail(f"{name}: a replay counted {delta}, not {per_replay}")
    torch.cuda.synchronize()
    log(f"{name} decode graph: replay == eager bit for bit (poisoned slot NaN"
        f"{', state leaves' if g.state else ''}), again "
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
        return _greedy_run(c, p, prompts, cache_len, n, forced)

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


def _greedy_run(cfg, params, prompts, cache_len, n, forced=None, images=None):
    """``prefill(cache_len=...)`` of ``prompts`` [B, S] (with ``images`` for a
    cross model) -> ``n`` greedy decode steps (or the ``forced`` tokens)
    through a ``DecodeGraph`` on the slot caches the prefill returns: step 0
    captures it (timed apart), steps 1.. replay it.  Returns (per-step
    logits, tokens, prefill s, s a replayed step, the graph)."""
    from repro_torch.models import model as M
    from repro_torch.models.graph import DecodeGraph
    B, S = prompts.shape
    V = cfg.vocab_size
    torch.cuda.synchronize()
    t0 = time.time()
    logits, caches = M.prefill(cfg, params, prompts, images=images, cache_len=cache_len)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    g = DecodeGraph(cfg, params, caches, B)
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


# ---------------------------------------------------------------------------
# phase 5: MLA (minicpm3-4b) through the engine's whole-prompt prefill
# ---------------------------------------------------------------------------

def _scatter_prefill(cfg, pools, small, pages, n: int, ps: int):
    """Write a prefill's cache (``small``: [R, B, n, ...] a ``kv_seq`` leaf,
    [R, B, ...] a state leaf) for each slot b, as the engine's whole prefill
    does for one slot: rows to logical rows [0, n) of the slot's pages,
    state to row b of the slot-indexed leaf."""
    from repro_torch.models import model as M
    j = torch.arange(n, device=pages.device)
    for spec, pool, new in M.cache_leaves(M.cache_specs(cfg, 1, 1), pools, small):
        for b in range(pages.shape[0]):
            if "kv_seq" in spec.axes:
                pool[:, pages[b, j // ps].long(), j % ps] = new[:, b].to(pool.dtype)
            else:
                pool[:, b] = new[:, b].to(pool.dtype)


def mla_reference_check():
    """Reduced minicpm3-4b (f32 compute; MLA ranks q 32, kv 16, rope 8, nope
    8, v 16; seed-0 weights) on the card's kernels against the CPU's plain
    versions, in float and w8a8 weights.

    Part 1, the model steps: a whole prefill of two 40-token prompts, its
    fused kv rows written into pools of page size 16 through permuted
    tables, then 12 paged ``decode_step``s on the same tokens (gate:
    ``_card_vs_cpu``: logits within 1e-4, or the flip rule in w8a8).  Part
    2, a small engine, ``EngineConfig(max_batch=4, max_len=128, page_size=16,
    decode_chunk=4)``: four prompts, 16 greedy tokens each, prefilled whole
    at admission, decode steps replayed as a CUDA graph on the card; the
    same on the CPU.  Gate: equal greedy tokens (w8a8: unless Part 1 showed
    a boundary flip, then >= 0.9)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, check_invariants
    cfg = reduce_config(get_config("minicpm3-4b"))
    V = cfg.vocab_size
    rng = np.random.RandomState(6)
    B, ps, npp, S, steps = 2, 16, 4, 40, 12
    toks = torch.from_numpy(rng.randint(0, V, (B, S + steps)).astype(np.int32))
    pages = torch.from_numpy(rng.permutation(np.arange(1, B * npp + 1))
                             .reshape(B, npp).astype(np.int32))
    prompts = [rng.randint(0, V, n).tolist() for n in (34, 30, 39, 45)]
    out = {}
    for quant in ("none", "w8a8"):
        p_cpu = M.init(cfg, seed=0, device="cpu")
        if quant == "w8a8":
            p_cpu = M.quantize_params(cfg, p_cpu)
        params = {"cpu": p_cpu, "cuda": _to_cuda(p_cpu)}
        caches = {d: M.init_paged_cache(cfg, B, B * npp + 1, ps, device=d) for d in params}
        pairs = []
        with _Int8Recorder() as rec:
            lg = {}
            for d in params:
                lg[d], small = M.prefill(cfg, params[d], toks[:, :S].to(d))
                _scatter_prefill(cfg, caches[d], small, pages.to(d), S, ps)
            pairs.append((lg["cpu"], lg["cuda"].cpu()))
            for i in range(steps):
                pos = torch.full((B,), S + i, dtype=torch.int32)
                lg = {d: M.decode_step(cfg, params[d], caches[d], toks[:, S + i: S + i + 1].to(d),
                                       pos.to(d), pages=pages.to(d))[0].cpu() for d in params}
                pairs.append((lg["cpu"], lg["cuda"]))
        res = _card_vs_cpu("reduced minicpm3-4b paged", quant, pairs, rec)
        econf = EngineConfig(max_batch=4, max_len=128, page_size=ps, decode_chunk=4,
                             quant=None if quant == "none" else quant)
        gens = {}
        for d in params:
            eng = Engine(cfg, params[d], econf, device=d)
            rids = [eng.submit(p, max_new=16) for p in prompts]
            by = {r.rid: r for r in eng.run()}
            gens[d] = [by[r].generated for r in rids]
            if eng.radix is not None or eng.stats.mixed_steps or eng.stats.prefills != 4 \
                    or check_invariants(eng.pool, eng.radix, tables=eng.sched.owned):
                fail(f"reduced minicpm3-4b engine {quant} on {d}: a radix tree, a mixed tick, "
                     f"{eng.stats.prefills} prefills or a bad paging state")
            if d == "cuda" and eng.runner.graph.replays == 0:
                fail("reduced minicpm3-4b engine: the decode graph was never replayed")
        agree = statistics.mean(float(np.mean(np.array(a) == np.array(b)))
                                for a, b in zip(gens["cpu"], gens["cuda"]))
        flipped = res["witness"] is not None and res["witness"]["first_flip"] is not None
        if (agree < 1.0 and not flipped) or agree < 0.9:
            fail(f"reduced minicpm3-4b engine {quant}: card and CPU greedy tokens agree at "
                 f"{agree:.4f} (flip shown: {flipped})")
        res["engine_token_agreement"] = agree
        out[quant] = res
        log(f"reduced minicpm3-4b {quant}, card kernels vs CPU plain versions: whole prefill + "
            f"{steps} paged decode steps, max logits gap {res['gap']:.3e} (bound "
            f"{res['bound']:g}), argmax agreement {res['argmax_agreement']:.4f}; engine "
            f"(4 requests x 16 tokens, whole prefills, decode graph on the card) greedy tokens "
            f"card == CPU at {agree:.4f} of positions")
    return out


# the kernels of the MLA engine path: the bf16 GEMM (every projection and
# the head) and paged flash-decode at the latent shape; prefill attention is
# plain PyTorch
MLA_PATH = ("block_gemm", "flash_decode_paged")


def mla_engine_phase(counters, gen):
    """Full-width minicpm3-4b (62 layers, seeded random bf16 weights)
    through ``repro_torch.serving.Engine``: 8 greedy requests (prompts
    100-500 tokens, 32 new), ``EngineConfig(max_batch=8, max_len=1024,
    page_size=64, decode_chunk=8)``.  Each prompt prefills whole at
    admission; every tick is a decode tick replaying the decode graph over
    the fused [latent | k_rope] pools.  Gates: every request LENGTH with 32
    in-vocabulary tokens; no radix tree and no mixed tick; the bf16 GEMM and
    paged flash-decode launched and no other kernel (prefill attention is
    plain), paged decode once a layer a replay and in all (replays + 1) x
    62 times (the one eager warm-up before capture); the pool reconciles
    (every page free after the run); ``graph_check``; two prompts served
    alone give the batched tokens; a traced decode tick as
    ``trace_ticks``.  Then a short w8a8 pass (4 requests x 16 tokens: the
    int8 GEMM carries wq_a, wkv_a, wo, the FFN and the head, 4 quantize
    launches for every 6 int8 GEMMs a layer; its graph checked), and the
    direct ``prefill(cache_len=...)`` -> 8 greedy ``decode_step``s on the
    linear slot caches (slot flash-decode once a layer a step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, FinishReason, check_invariants
    names = {c.__name__: c for c in counters}
    ref_check = mla_reference_check()
    cfg = get_config("minicpm3-4b")
    t0 = time.time()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"minicpm3-4b: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads, "
        f"MLA ranks q {cfg.q_lora_rank} kv {cfg.kv_lora_rank} (rope {cfg.qk_rope_dim}, nope "
        f"{cfg.qk_nope_dim}, v {cfg.v_head_dim}), vocab {cfg.vocab_size} -> "
        f"{cfg.padded_vocab}, {n_params / 1e9:.3f} B parameters in bf16, init "
        f"{time.time() - t0:.1f} s")
    econf = EngineConfig(max_batch=8, max_len=1024, page_size=64, decode_chunk=8)
    rng = np.random.RandomState(5)
    V, L = cfg.vocab_size, cfg.num_layers
    prompts = [rng.randint(0, V, n).tolist() for n in (120, 333, 480, 205, 100, 260, 415, 500)]
    max_new = 32
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    eng = Engine(cfg, params, econf)
    t0 = time.time()
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    results = {r.rid: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {c.__name__: c.launches for c in counters}
    for rid in rids:
        r = results[rid]
        if r.finish_reason != FinishReason.LENGTH or len(r.generated) != max_new \
                or not all(0 <= t < V for t in r.generated):
            fail(f"minicpm3-4b rid {rid}: {r.finish_reason} with {len(r.generated)} tokens")
    st, graph = eng.stats, eng.runner.graph
    if eng.radix is not None or st.mixed_steps or st.prefills != len(prompts):
        fail(f"minicpm3-4b engine: radix {eng.radix}, {st.mixed_steps} mixed ticks, "
             f"{st.prefills} prefills")
    for n, c in launches.items():
        if (n in MLA_PATH) != (c > 0):
            fail(f"minicpm3-4b engine: {n} launched {c} times (the path: {MLA_PATH})")
    per_replay = {c.__name__: n for c, n in graph.per_replay.items()}
    if graph.replays != st.chunks * econf.decode_chunk \
            or per_replay.get("flash_decode_paged") != L \
            or launches["flash_decode_paged"] != (graph.replays + 1) * L:
        fail(f"minicpm3-4b engine: {graph.replays} replays for {st.chunks} decode ticks, "
             f"{per_replay} launches a replay, {launches['flash_decode_paged']} paged decode "
             f"launches in all")
    bad = check_invariants(eng.pool, eng.radix, tables=eng.sched.owned)
    if bad or eng.pool.num_free != eng.pool.n_pages - 1:
        fail("minicpm3-4b paging state: " + "; ".join(bad) + f"; {eng.pool.num_free} free")
    ttft = sorted(r.ttft_s for r in results.values())
    # the first decode tick captured the graph: its capture is reported
    # apart, not spread over the ticks
    summary = dict(tokens_per_s=st.tokens_out / wall, wall_s=wall,
                   ttft_p50_ms=statistics.median(ttft) * 1e3,
                   prefill_ms=st.prefill_s / st.prefills * 1e3,
                   decode_tick_ms=(st.decode_s - graph.capture_s) / max(st.chunks, 1) * 1e3,
                   capture_ms=graph.capture_s * 1e3, launches=launches,
                   per_replay=per_replay, reference=ref_check)
    log(f"minicpm3-4b engine: {len(prompts)} requests, {st.tokens_out} tokens in {wall:.3f} s "
        f"({summary['tokens_per_s']:.2f} tokens/s end to end), TTFT p50 "
        f"{summary['ttft_p50_ms']:.1f} ms, {st.prefills} whole prefills at "
        f"{summary['prefill_ms']:.2f} ms, {st.chunks} decode ticks x{econf.decode_chunk} at "
        f"{summary['decode_tick_ms']:.2f} ms without the graph's capture ("
        f"{summary['capture_ms']:.1f} ms); launches {json.dumps(launches)}; "
        f"{json.dumps(per_replay)} a replay")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    batched = {tuple(p): results[rid].generated for rid, p in zip(rids, prompts)}
    B, npp = econf.max_batch, econf.cache_spec().pages_per_seq
    table = torch.from_numpy(rng.permutation(np.arange(1, econf.n_pages))[: B * npp]
                             .reshape(B, npp).astype(np.int32))
    poison = torch.zeros(B, dtype=torch.bool)
    poison[2] = True
    cur = torch.from_numpy(rng.randint(0, V, B).astype(np.int32))
    graphs = {"bf16": graph_check("engine minicpm3-4b bf16 pools", graph, lambda: graph.load(
        cur, torch.tensor([0, 63, 64, 300, 511, 700, 1000, 1023], dtype=torch.int32),
        table, poison), gen)}
    del eng, graph
    for p in (prompts[2], prompts[5]):
        solo = Engine(cfg, params, econf)
        solo.submit(p, max_new=max_new)
        if solo.run()[0].generated != batched[tuple(p)]:
            fail(f"minicpm3-4b: solo greedy tokens differ from batched for a {len(p)}-token "
                 f"prompt")
        del solo
    log("minicpm3-4b: solo == batched greedy tokens for 2 prompts")
    summary["trace"] = trace_ticks(Engine(cfg, params, econf), prompts, max_new, summary,
                                   counters, kinds=("decode",))
    qconf = EngineConfig(max_batch=4, max_len=1024, page_size=64, decode_chunk=8,
                         quant="w8a8")
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
            fail(f"minicpm3-4b w8a8 engine rid {rid}: bad output {qres[rid].generated}")
    # a forward pass (a whole prefill or a decode step): 6 int8 GEMMs a layer
    # and the head's, after 4 quantize launches a layer and the head's; wq_b
    # and wkv_b stay on the bf16 GEMM
    n_gemm, n_quant = 6 * L + 1, 4 * L + 1
    if qlaunch["block_gemm_int8"] <= 0 or qlaunch["block_gemm"] <= 0 \
            or qlaunch["flash_decode_paged"] <= 0 \
            or qlaunch["quantize_rows"] * n_gemm != qlaunch["block_gemm_int8"] * n_quant:
        fail(f"minicpm3-4b w8a8 engine launches {qlaunch}: {n_quant} quantize launches for "
             f"every {n_gemm} int8 GEMMs, the bf16 GEMM for wq_b / wkv_b")
    agree = statistics.mean(
        sum(a == b for a, b in zip(qres[q].generated, batched[tuple(p)])) / 16
        for q, p in zip(qrids, prompts[:4]))
    log(f"minicpm3-4b engine w8a8: 4 requests x 16 tokens in {qwall:.3f} s; launches "
        f"{json.dumps(qlaunch)}; greedy tokens equal to bf16's at {agree:.4f} of positions")
    qg, qB = qeng.runner.graph, qconf.max_batch
    qtable = torch.from_numpy(rng.permutation(np.arange(1, qconf.n_pages))[: qB * npp]
                              .reshape(qB, npp).astype(np.int32))
    graphs["w8a8"] = graph_check("engine minicpm3-4b w8a8 pools", qg, lambda: qg.load(
        cur[:qB], torch.tensor([5, 64, 400, 1023], dtype=torch.int32), qtable,
        poison[:qB]), gen)
    del qeng, qg
    summary["w8a8"] = dict(wall_s=qwall, launches=qlaunch, token_agreement=agree)
    summary["graph_per_replay"] = graphs
    # the direct loop on linear slot caches: prefill(cache_len) -> 8 steps
    Bd, Sd, steps, cache_len = 2, 300, 8, 512
    toks = torch.from_numpy(rng.randint(0, V, (Bd, Sd)).astype(np.int32)).cuda()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    logits, caches = M.prefill(cfg, params, toks, cache_len=cache_len)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    pre = {n: c.launches for n, c in names.items()}
    t0 = time.time()
    for i in range(steps):
        tok = torch.argmax(logits[:, -1, :V], -1).to(torch.int32)[:, None]
        logits, caches = M.decode_step(cfg, params, caches, tok, Sd + i)
        if logits.shape != (Bd, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"minicpm3-4b direct decode step {i}: shape {tuple(logits.shape)} or "
                 f"non-finite logits")
    torch.cuda.synchronize()
    t_step = (time.time() - t0) / steps
    direct = {n: c.launches for n, c in names.items()}
    kv = caches[0]["0"]["kv"]
    if tuple(kv.shape) != (L, Bd, cache_len, cfg.kv_lora_rank + cfg.qk_rope_dim) \
            or direct["flash_decode"] != steps * L or pre["flash_decode"] != 0 \
            or direct["flash_decode_paged"] != 0 or pre["block_gemm"] <= 0:
        fail(f"minicpm3-4b direct loop: cache {tuple(kv.shape)}, launches after the prefill "
             f"{pre}, after {steps} steps {direct}")
    summary["direct"] = dict(prefill_ms=t_pre * 1e3, eager_step_ms=t_step * 1e3,
                             launches=direct)
    log(f"minicpm3-4b direct loop: prefill {Bd}x{Sd} (cache_len {cache_len}) in "
        f"{t_pre * 1e3:.1f} ms, {steps} eager decode steps on the slot caches at "
        f"{t_step * 1e3:.2f} ms; launches {json.dumps(direct)}")
    return launches, summary


# ---------------------------------------------------------------------------
# phase 6: capacity-routed MoE (qwen3-moe-30b-a3b) through the chunked engine
# ---------------------------------------------------------------------------

class _MoeRecorder:
    """Records every eager MoE routing (``layers.moe_route``) by device, in
    call order: the top-k experts, the kept masks, the capacity, each
    token's gap between its k-th and (k+1)-th probability and (on the CPU)
    the probabilities.  Eager calls only: a graph replay runs no Python
    (and a capture must not sync)."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.calls = layers, {"cpu": [], "cuda": []}

    def __enter__(self):
        route = self._route = self.layers.moe_route

        def moe_route(cfg, p, xt, span=None):
            r = route(cfg, p, xt, span)
            k = cfg.experts_per_token
            top = torch.topk(r.probs, k + 1, -1).values
            self.calls[xt.device.type].append(dict(
                topi=r.topi.cpu(), kept=r.kept.cpu(), C=r.C,
                gap=(top[..., k - 1] - top[..., k]).cpu(),
                probs=r.probs.float().cpu() if xt.device.type == "cpu" else None))
            return r
        self.layers.moe_route = moe_route
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self._route


MOE_TIE = 1e-6  # a gap between two experts' probabilities under which f32 rounding may flip


def routing_check(name, rec, strict=True):
    """The card's MoE routing against the CPU's, call by call.  Top-k
    experts (in order) must be equal, except at a token where each position
    the two devices fill differently holds two experts whose probabilities
    (on the CPU) lie within ``MOE_TIE``: a k-th / (k+1)-th near-tie that
    swaps an expert in or out, or a near-tie inside the top k that swaps
    two choices' order (their priority for capacity).  Each such token is
    printed as a witness.  Kept masks must be equal on every choice of an
    expert no witness touches (a flipped choice moves the slots of both its
    experts).  ``strict=False`` (w8a8 after an int8 flip upstream) prints
    the agreement instead of failing.  Returns the witnesses, the calls,
    the agreement and, per call, the share of dropped choices."""
    cpu, gpu = rec.calls["cpu"], rec.calls["cuda"]
    if len(cpu) != len(gpu):
        fail(f"{name}: {len(cpu)} MoE calls on the CPU, {len(gpu)} on the card")
    witnesses, same, total, dropped, bad = [], 0, 0, [], None
    for i, (c, g) in enumerate(zip(cpu, gpu)):
        flip = (c["topi"] != g["topi"]).any(-1)  # [G, T]
        touched = torch.zeros(c["topi"].shape[0], int(max(c["topi"].max(), g["topi"].max())) + 1,
                              dtype=torch.bool)
        for gi, t in flip.nonzero().tolist():
            ci, gc = c["topi"][gi, t], g["topi"][gi, t]
            pc, d = c["probs"][gi, t], ci != gc
            w = dict(call=i, group=gi, token=t, gap=float((pc[ci[d]] - pc[gc[d]]).abs().max()),
                     kth_gap=float(c["gap"][gi, t]), cpu=ci.tolist(), card=gc.tolist())
            if w["gap"] > MOE_TIE and bad is None:
                bad = w
            witnesses.append(w)
            touched[gi, c["topi"][gi, t]] = True
            touched[gi, g["topi"][gi, t]] = True
        ok = ~torch.gather(touched, 1, c["topi"].flatten(1)).reshape(c["topi"].shape)
        ok &= c["topi"] == g["topi"]
        kept_same = bool((c["kept"][ok] == g["kept"][ok]).all())
        if not kept_same and bad is None:
            bad = dict(call=i, kept="differs on an untouched expert")
        same += int((c["topi"] == g["topi"]).all(-1).sum())
        total += flip.numel()
        dropped.append(float((~c["kept"]).float().mean()))
    agree = same / max(total, 1)
    for w in witnesses[:8]:
        log(f"{name} routing witness: {json.dumps(w)}")
    if bad is not None and strict:
        fail(f"{name}: card and CPU routing differ away from a near-tie: {bad}")
    return dict(calls=len(cpu), witnesses=len(witnesses), token_agreement=agree,
                dropped_share=dropped, worst=bad)


def moe_reference_check():
    """Reduced qwen3-moe (f32 compute; 4 experts top-2 of width 32, d_model
    64; seed-0 weights) on the card's kernels against the CPU's plain
    versions, in float and w8a8 weights.

    Part 1, the model steps: ``chunk_step`` over a 40-token prompt in 16-row
    chunks (two slots; the last chunk's zero tail takes capacity), then 12
    paged ``decode_step``s (gate: ``_card_vs_cpu``: logits within 1e-4, or
    the flip rule in w8a8; every layer's routing equal by
    ``routing_check``, in w8a8 once no int8 flip was shown).  Part 2, a small
    engine, ``EngineConfig(max_batch=4, max_len=128, page_size=16,
    chunk_tokens=16, decode_chunk=4)``: four prompts of which two share a
    24-token prefix, 16 greedy tokens each, on the card (decode steps
    replayed as a CUDA graph) and on the CPU.  Gate: equal greedy tokens
    (w8a8: the flip rule)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, check_invariants
    cfg = reduce_config(get_config("qwen3-moe-30b-a3b"))
    V = cfg.vocab_size
    rng = np.random.RandomState(7)
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
        with _Int8Recorder() as rec, _MoeRecorder() as mrec:
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
        res = _card_vs_cpu("reduced qwen3-moe paged", quant, pairs, rec)
        flipped = res["witness"] is not None and res["witness"]["first_flip"] is not None
        res["routing"] = routing_check(f"reduced qwen3-moe {quant}", mrec, strict=not flipped)
        econf = EngineConfig(max_batch=4, max_len=128, page_size=ps, chunk_tokens=C,
                             decode_chunk=4, quant=None if quant == "none" else quant)
        gens = {}
        for d in params:
            eng = Engine(cfg, params[d], econf, device=d)
            rids = [eng.submit(p, max_new=16) for p in prompts]
            by = {r.rid: r for r in eng.run()}
            gens[d] = [by[r].generated for r in rids]
            if eng.stats.prefix_hit_tokens < 16 or check_invariants(
                    eng.pool, eng.radix, tables=eng.sched.owned):
                fail(f"reduced qwen3-moe engine {quant} on {d}: no prefix hit or bad paging "
                     f"state")
            if d == "cuda" and eng.runner.graph.replays == 0:
                fail("reduced qwen3-moe engine: the decode graph was never replayed")
        agree = statistics.mean(float(np.mean(np.array(a) == np.array(b)))
                                for a, b in zip(gens["cpu"], gens["cuda"]))
        if (agree < 1.0 and not flipped) or agree < 0.9:
            fail(f"reduced qwen3-moe engine {quant}: card and CPU greedy tokens agree at "
                 f"{agree:.4f} (flip shown: {flipped})")
        res["engine_token_agreement"] = agree
        out[quant] = res
        log(f"reduced qwen3-moe paged {quant}, card kernels vs CPU plain versions: 3 chunks + "
            f"{steps} paged decode steps, max logits gap {res['gap']:.3e} (bound "
            f"{res['bound']:g}), argmax agreement {res['argmax_agreement']:.4f}, routing of "
            f"{res['routing']['calls']} MoE calls equal at {res['routing']['token_agreement']:.4f} "
            f"of tokens ({res['routing']['witnesses']} near-tie witnesses); engine (4 requests "
            f"x 16 tokens, radix hits, decode graph on the card) greedy tokens card == CPU at "
            f"{agree:.4f} of positions")
    return out


def moe_layer_check(gen):
    """One full-width MoE layer (qwen3-moe-30b-a3b's: d_model 2048, 128
    experts top-8 of width 768; weights from seed 11 by the model's init
    rules) in f32 on the card and on the CPU, at T = 8 (a decode batch), 64
    (a chunk buffer) and 600 (the direct prefill, 2 x 300), inputs of unit
    RMS like the normed hidden state.  Gates: routing by ``routing_check``
    (top-k experts and kept masks equal but at near-ties, each printed);
    outputs within 1e-5 x the output's max abs (f32 sums in other orders),
    over the tokens no near-tie witness touches.  Prints the share of
    dropped (token, choice) pairs at each T."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params
    cfg = get_config("qwen3-moe-30b-a3b").with_(compute_dtype=torch.float32)
    p = {"cuda": init_params(L.moe_specs(cfg), torch.Generator(device="cuda").manual_seed(11),
                             torch.float32)}
    p["cpu"] = {k: v.cpu() for k, v in p["cuda"].items()}
    out = {}
    for name, (B, S) in (("decode", (8, 1)), ("chunk", (1, 64)), ("prefill", (2, 300))):
        x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda")
        with _MoeRecorder() as rec:
            y = {d: L.moe_forward(cfg, p[d], x.to(d))[0].cpu() for d in ("cpu", "cuda")}
        route = routing_check(f"qwen3-moe layer T={B * S}", rec)
        c = rec.calls["cpu"][0]
        ok = torch.ones(B * S, dtype=torch.bool)
        if route["witnesses"]:  # leave out every token routed to a flipped expert
            g = rec.calls["cuda"][0]
            hit = set()
            for t in ((c["topi"] != g["topi"]).any(-1))[0].nonzero().flatten().tolist():
                hit |= set(c["topi"][0, t].tolist()) | set(g["topi"][0, t].tolist())
            ok = ~torch.isin(c["topi"][0], torch.tensor(sorted(hit))).any(-1)
        ref_, got = y["cpu"].reshape(B * S, -1)[ok], y["cuda"].reshape(B * S, -1)[ok]
        scale = float(y["cpu"].abs().max())
        gap = float((got - ref_).abs().max())
        if not bool(torch.isfinite(y["cuda"]).all()) or gap > 1e-5 * scale:
            fail(f"qwen3-moe layer T={B * S}: card vs CPU output gap {gap:.3e} over "
                 f"1e-5 x max abs {scale:.3e}")
        out[name] = dict(T=B * S, C=c["C"], dropped_share=route["dropped_share"][0],
                         gap=gap, max_abs=scale, witnesses=route["witnesses"],
                         min_tie_gap=float(c["gap"].min()))
        log(f"qwen3-moe layer, card vs CPU (f32) at T = {B * S} (C = {c['C']}): routing equal"
            f" ({route['witnesses']} near-tie witnesses; smallest k-th / (k+1)-th gap "
            f"{out[name]['min_tie_gap']:.3e}), output gap {gap:.3e} (bound 1e-5 x {scale:.3e}); "
            f"dropped (token, choice) pairs {out[name]['dropped_share']:.4f}")
    return out


# the kernels of the MoE engine path: the bf16 GEMM (attention projections
# and the head) and both paged attention kernels; the routers and the
# experts are matmuls (the reference's einsums)
MOE_PATH = ("block_gemm", "flash_attention_paged", "flash_decode_paged")


def moe_engine_phase(counters, gen):
    """Full-width, full-depth qwen3-moe-30b-a3b (48 layers, 128 experts
    top-8, seeded random bf16 weights drawn on the card) through
    ``repro_torch.serving.Engine``, after ``moe_reference_check`` and
    ``moe_layer_check``: 8 greedy requests (prompts 308-500 tokens, four
    sharing a 288-token prefix: radix hits and a copy-on-write page), 32
    new, ``EngineConfig(max_batch=8, max_len=1024, page_size=64,
    chunk_tokens=64, decode_chunk=8)``.  Gates: every request LENGTH with 32
    in-vocabulary tokens; a prefix hit and a page copy; the bf16 GEMM and
    both paged attention kernels launched and no other kernel, paged decode
    once a layer a replay; one replay a mixed tick and ``decode_chunk`` a
    decode tick; the pool reconciles; ``graph_check``; a traced decode tick
    as ``trace_ticks``.

    No solo == batched gate: MoE capacity is shared by every row of a call
    (the reference's semantics), so a request's tokens depend on its
    neighbours whenever an expert overflows.  The card-vs-CPU checks above
    stand in for it.

    Then a short w8a8 pass (4 requests x 16 tokens: the int8 GEMM carries
    wq, wk, wv, wo and the head, 2 quantize launches for every 4 int8 GEMMs
    a layer; the router (f32) and the experts (bf16) stay the tensors they were;
    its graph checked) and the direct ``prefill(cache_len=512)`` -> 8
    greedy ``decode_step``s (B = 2 x 300 tokens: dense flash attention and
    slot decode once a layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, FinishReason, check_invariants
    names = {c.__name__: c for c in counters}
    summary = dict(reference=moe_reference_check(), layer=moe_layer_check(gen))
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen3-moe-30b-a3b")
    t0 = time.time()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    summary["memory"] = dict(free_before_init_gib=free / 2 ** 30, total_gib=total / 2 ** 30,
                             weights_gib=w_bytes / 2 ** 30, init_s=init_s)
    log(f"qwen3-moe-30b-a3b: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads over {cfg.num_kv_heads}, {cfg.num_experts} experts top-{cfg.experts_per_token} "
        f"of width {cfg.moe_d_ff}, vocab {cfg.vocab_size} -> {cfg.padded_vocab}; "
        f"{n_params / 1e9:.3f} B parameters, {w_bytes / 1e9:.2f} GB (bf16, routers f32), "
        f"init {init_s:.1f} s; device memory free before init {free / 2 ** 30:.2f} of "
        f"{total / 2 ** 30:.2f} GiB")
    econf = EngineConfig(max_batch=8, max_len=1024, page_size=64, chunk_tokens=64,
                         decode_chunk=8)
    rng = np.random.RandomState(8)
    V, L = cfg.vocab_size, cfg.num_layers
    prefix = rng.randint(0, V, 288).tolist()  # 4 pages + half a page (copy-on-write)
    shared = [prefix + rng.randint(0, V, n).tolist() for n in (212, 20, 97, 150)]
    other = [rng.randint(0, V, n).tolist() for n in (120, 333, 480, 205)]
    prompts = [x for pair in zip(shared, other) for x in pair]
    max_new = 32
    for c in counters:
        c.launches = 0
    eng = Engine(cfg, params, econf)
    copies = []
    copy_page = eng.runner.copy_page
    eng.runner.copy_page = lambda src, dst: (copies.append((src, dst)), copy_page(src, dst))
    t0 = time.time()
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    results = {r.rid: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {c.__name__: c.launches for c in counters}
    for rid in rids:
        r = results[rid]
        if r.finish_reason != FinishReason.LENGTH or len(r.generated) != max_new \
                or not all(0 <= t < V for t in r.generated):
            fail(f"qwen3-moe rid {rid}: {r.finish_reason} with {len(r.generated)} tokens")
    st, graph = eng.stats, eng.runner.graph
    if st.prefix_hit_tokens <= 0 or not copies:
        fail(f"qwen3-moe engine: {st.prefix_hit_tokens} prefix-hit tokens, {len(copies)} page "
             f"copies")
    for n, c in launches.items():
        if (n in MOE_PATH) != (c > 0):
            fail(f"qwen3-moe engine: {n} launched {c} times (the path: {MOE_PATH})")
    per_replay = {c.__name__: n for c, n in graph.per_replay.items()}
    if graph.replays != st.chunks * econf.decode_chunk + st.mixed_steps \
            or per_replay.get("flash_decode_paged") != L:
        fail(f"qwen3-moe engine: {graph.replays} replays for {st.chunks} decode ticks and "
             f"{st.mixed_steps} mixed ticks, {per_replay} launches a replay")
    bad = check_invariants(eng.pool, eng.radix, tables=eng.sched.owned)
    if bad:
        fail("qwen3-moe paging state: " + "; ".join(bad))
    ttft = sorted(r.ttft_s for r in results.values())
    # the first tick (a mixed one) captured the graph: its capture is
    # reported apart, not spread over the mixed ticks
    summary.update(
        tokens_per_s=st.tokens_out / wall, wall_s=wall,
        ttft_p50_ms=statistics.median(ttft) * 1e3,
        mixed_tick_ms=(st.prefill_s - graph.capture_s) / max(st.mixed_steps, 1) * 1e3,
        decode_tick_ms=st.decode_s / max(st.chunks, 1) * 1e3, mixed_ticks=st.mixed_steps,
        decode_ticks=st.chunks, capture_ms=graph.capture_s * 1e3,
        prefix_hit_tokens=st.prefix_hit_tokens, page_copies=len(copies),
        launches=launches, per_replay=per_replay, peak_gib=peak / 2 ** 30)
    log(f"qwen3-moe engine: {len(prompts)} requests, {st.tokens_out} tokens in {wall:.3f} s "
        f"({summary['tokens_per_s']:.2f} tokens/s end to end), TTFT p50 "
        f"{summary['ttft_p50_ms']:.1f} ms, {st.mixed_steps} mixed ticks at "
        f"{summary['mixed_tick_ms']:.2f} ms without the capture, {st.chunks} decode ticks "
        f"x{econf.decode_chunk} at {summary['decode_tick_ms']:.2f} ms; capture "
        f"{summary['capture_ms']:.1f} ms; prefix hit {st.prefix_hit_tokens} tokens, "
        f"{len(copies)} copy-on-write page copies; launches {json.dumps(launches)}; "
        f"{json.dumps(per_replay)} a replay")
    log(f"qwen3-moe: peak device memory {peak / 2 ** 30:.2f} GiB after the engine run "
        f"(weights {w_bytes / 2 ** 30:.2f} GiB)")
    B, npp = econf.max_batch, econf.cache_spec().pages_per_seq
    table = torch.from_numpy(rng.permutation(np.arange(1, econf.n_pages))[: B * npp]
                             .reshape(B, npp).astype(np.int32))
    poison = torch.zeros(B, dtype=torch.bool)
    poison[5] = True
    cur = torch.from_numpy(rng.randint(0, V, B).astype(np.int32))
    graphs = {"bf16": graph_check("engine qwen3-moe bf16 pools", graph, lambda: graph.load(
        cur, torch.tensor([0, 63, 64, 300, 511, 700, 1000, 1023], dtype=torch.int32),
        table, poison), gen)}
    del eng, graph, copy_page
    summary["trace"] = trace_ticks(Engine(cfg, params, econf), prompts, max_new, summary,
                                   counters)
    qconf = EngineConfig(max_batch=4, max_len=1024, page_size=64, chunk_tokens=64,
                         decode_chunk=8, quant="w8a8")
    qeng = Engine(cfg, params, qconf)
    for si, stage in enumerate(qeng.params["stages"]):
        for gi, layer in stage.items():
            if any(w is not params["stages"][si][gi]["ffn"][n] for n, w in layer["ffn"].items()):
                fail("qwen3-moe w8a8: the MoE weights are not the float tensors they were")
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
            fail(f"qwen3-moe w8a8 engine rid {rid}: bad output {qres[rid].generated}")
    # a forward pass (a chunk or a decode step): 4 int8 GEMMs a layer and the
    # head's, after 2 quantize launches a layer (q/k/v share one) and the
    # head's; no bf16 GEMM is left
    n_gemm, n_quant = 4 * L + 1, 2 * L + 1
    if qlaunch["block_gemm_int8"] <= 0 or qlaunch["block_gemm"] != 0 \
            or qlaunch["quantize_rows"] * n_gemm != qlaunch["block_gemm_int8"] * n_quant:
        fail(f"qwen3-moe w8a8 engine launches {qlaunch}: the int8 GEMM must carry every GEMM, "
             f"{n_quant} quantize launches for every {n_gemm}")
    log(f"qwen3-moe engine w8a8: 4 requests x 16 tokens in {qwall:.3f} s; launches "
        f"{json.dumps(qlaunch)}; the router and the experts stay the bf16 / f32 tensors")
    qg, qB = qeng.runner.graph, qconf.max_batch
    qtable = torch.from_numpy(rng.permutation(np.arange(1, qconf.n_pages))[: qB * npp]
                              .reshape(qB, npp).astype(np.int32))
    graphs["w8a8"] = graph_check("engine qwen3-moe w8a8 pools", qg, lambda: qg.load(
        cur[:qB], torch.tensor([5, 64, 400, 1023], dtype=torch.int32), qtable,
        poison[:qB]), gen)
    del qeng, qg
    summary["w8a8"] = dict(wall_s=qwall, launches=qlaunch)
    summary["graph_per_replay"] = graphs
    # the direct loop on linear slot caches: prefill(cache_len) -> 8 steps
    Bd, Sd, steps, cache_len = 2, 300, 8, 512
    toks = torch.from_numpy(rng.randint(0, V, (Bd, Sd)).astype(np.int32)).cuda()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    logits, caches = M.prefill(cfg, params, toks, cache_len=cache_len)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    pre = {n: c.launches for n, c in names.items()}
    t0 = time.time()
    for i in range(steps):
        tok = torch.argmax(logits[:, -1, :V], -1).to(torch.int32)[:, None]
        logits, caches = M.decode_step(cfg, params, caches, tok, Sd + i)
        if logits.shape != (Bd, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"qwen3-moe direct decode step {i}: shape {tuple(logits.shape)} or "
                 f"non-finite logits")
    torch.cuda.synchronize()
    t_step = (time.time() - t0) / steps
    direct = {n: c.launches for n, c in names.items()}
    kc = caches[0]["0"]["k"]
    if tuple(kc.shape) != (L, Bd, cache_len, cfg.num_kv_heads, cfg.head_dim) \
            or pre["flash_attention"] != L or direct["flash_attention"] != L \
            or pre["flash_decode"] != 0 or direct["flash_decode"] != steps * L \
            or direct["flash_decode_paged"] or direct["flash_attention_paged"]:
        fail(f"qwen3-moe direct loop: cache {tuple(kc.shape)}, launches after the prefill "
             f"{pre}, after {steps} steps {direct}")
    summary["direct"] = dict(prefill_ms=t_pre * 1e3, eager_step_ms=t_step * 1e3,
                             launches=direct)
    log(f"qwen3-moe direct loop: prefill {Bd}x{Sd} (cache_len {cache_len}) in "
        f"{t_pre * 1e3:.1f} ms, {steps} eager decode steps on the slot caches at "
        f"{t_step * 1e3:.2f} ms; launches {json.dumps(direct)}")
    return launches, summary


# ---------------------------------------------------------------------------
# phase 7: Mamba-2 SSD (mamba2-130m) and the jamba hybrid through the
# whole-prefill engine
# ---------------------------------------------------------------------------

# mamba2-130m's GEMMs on a kernel: the untied head (K, N), f32 out, and each
# layer's w_out (d_inner 1536 -> 768, the row-parallel projection on a
# mesh); the SSD input projections are the reference's einsums
# (torch.matmul).  The M the head meets: a whole prefill's last row, the
# decode batch, the direct prefill; w_out also a whole prompt's rows
MAMBA_HEAD = (768, 50432)
MAMBA_M = (1, 8, 2)
MAMBA_W_OUT = (1536, 768)
MAMBA_W_OUT_M = (1, 8, 120, 499)
# jamba's bf16 GEMMs (K, N): wq / wo, wk / wv, a dense FFN's w_gate / w_up,
# w_down, the head (f32 out), the SSD layer's w_out; its attention: 32
# query heads over 8 of 128
JAMBA_BF16_KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 65536), (8192, 4096))
JAMBA_H, JAMBA_K = 32, 8
# the engine's prompts: a prime length (499: chunks of one row), a multiple
# of 256 (one full chunk) and 500 (two chunks of 250)
SSM_PROMPTS = (120, 333, 499, 256, 100, 260, 415, 500)
SSM_POS = [153, 366, 532, 289, 133, 293, 448, 533]  # the engine's decode state, 33 tokens in


def ssm_kernel_phase(flush, gen):
    """The kernels of the SSM paths at their shapes.  bf16 GEMM at
    mamba2-130m's head (768 x 50432, f32 out) for M in ``MAMBA_M``, its
    w_out (1536 x 768) for M in ``MAMBA_W_OUT_M``, and at jamba's six
    (K, N) for M = 8 and 500 against the plain version
    (``gemm_phase``'s tolerances), rows bit-identical across M; the int8
    GEMM at the head for M = 1 and 8 exactly (``int8_exact``); paged
    flash-decode (B = 8, 32 heads over 8, d = 128, page size 64, an empty
    slot and a frozen full one) and dense causal flash attention (one
    prompt of 499 rows) at jamba's heads in f32 and bf16 (``check_attn``,
    every paged slot alone == batched).  Timed beside the plain version, the
    library call and the bound: the bf16 head at M = 1 and 8, the int8 head
    at M = 8 (``torch._int_mm`` + epilogue, A padded to 32 rows), paged
    decode at jamba's heads (SDPA on K/V gathered beforehand).  Returns the
    rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import (block_gemm, block_gemm_int8, gemm_splits,
                                                int8_route)
    from repro_torch.kernels.decode_attention import flash_decode_paged
    from repro_torch.kernels.flash_attention import flash_attention
    rows = {"gemm": [], "int8": []}
    K, N = MAMBA_HEAD
    for (k, n), Ms in [(MAMBA_HEAD, MAMBA_M), (MAMBA_W_OUT, MAMBA_W_OUT_M)] + \
            [(kn, (8, 500)) for kn in JAMBA_BF16_KN]:
        f32_out = n in (50432, 65536)
        out_dtype = torch.float32 if f32_out else torch.bfloat16
        for M in Ms:
            a = torch.randn(M, k, generator=gen, device="cuda").bfloat16()
            b = (torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
            check_close(f"block_gemm bf16 {M}x{k}x{n}", block_gemm(a, b, out_dtype=out_dtype),
                        ref.block_gemm_ref(a, b, out_dtype), 1e-4,
                        1e-5 if f32_out else 2.0 ** -7)
    gemm_row_invariance(gen, [MAMBA_HEAD + (False,), MAMBA_W_OUT + (False,)]
                        + [kn + (False,) for kn in JAMBA_BF16_KN])
    for M in (1, 8):
        a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        b = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)).bfloat16()
        ms = time_ms(lambda: block_gemm(a, b, out_dtype=torch.float32), flush)
        plain = time_ms(lambda: ref.block_gemm_ref(a, b, torch.float32), flush)
        lib = time_ms(lambda: torch.matmul(a, b), flush)  # bf16 out, as the earlier head rows
        bms, by = bound_ms(2 * (M * K + K * N) + 4 * M * N, 2 * M * N * K, torch.bfloat16)
        rows["gemm"].append(dict(shape=f"{M}x{K}x{N}", ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=bms, bound_by=by))
        log(f"  block_gemm bf16 {M}x{K}x{N} f32 out (K split {gemm_splits(K, N)}): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, torch.matmul (bf16 out) {lib:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
    routes = set()
    for M in (1, 8, 2):
        routes.add(int8_route(M, N, tma_ok=K % 16 == 0))
        int8_exact(gen, M, K, N)
    int8_row_invariance(gen, [(K, N, 72)], (1, 2, 4, 8))
    M = 8
    a, b = _int8_operands(gen, M, K, N, 127)
    sa, sb = _int8_scales(gen, M, N)
    ms = time_ms(lambda: block_gemm_int8(a, b, sa, sb, torch.float32), flush)
    plain = time_ms(lambda: ref.block_gemm_int8_ref(a, b, sa, sb, torch.float32), flush, reps=5)
    a32 = torch.cat([a, a.new_zeros(32 - M, K)])
    bt = b.T
    lib = time_ms(lambda: (torch._int_mm(a32, bt)[:M].float() * sa * sb), flush)
    bms, by = bound_ms(M * K + N * K + 4 * (M + N) + 4 * M * N, 2 * M * N * K, torch.int8)
    rows["int8"].append(dict(shape=f"{M}x{K}x{N}", ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bms, bound_by=by, route=int8_route(M, N)))
    log(f"  block_gemm_int8 {M}x{K}x{N} f32 out (route {int8_route(M, N)}): kernel {ms:.4f} "
        f"ms, plain {plain:.4f} ms, torch._int_mm+epilogue (A padded to 32 rows) {lib:.4f} ms, "
        f"bound {bms:.4f} ms ({by}); exact at M in (1, 8, 2) over routes {sorted(routes)}")

    H, Kh, d, ps, max_len = JAMBA_H, JAMBA_K, 128, 64, 1024
    B, npp = len(SSM_POS), max_len // ps
    P = B * npp + 1
    pages = _tables(B, npp, P, 90)
    pos = torch.tensor(SSM_POS[:6] + [1024, 9], dtype=torch.int32, device="cuda")
    start = torch.tensor([0] * 7 + [10], dtype=torch.int32, device="cuda")
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        k, v = _paged_pools(gen, P, ps, Kh, d, dtype)
        q = torch.randn(B, H, d, generator=gen, device="cuda").to(dtype)
        got = flash_decode_paged(q, k, v, pos, start, pages)
        err[(dtype, "decode")] = check_attn(f"flash_decode_paged jamba {dtype}", got,
                                            ref.flash_decode_ref(q, k, v, pos, start,
                                                                 pages=pages), dtype)
        if float(got[7].abs().max()) != 0.0:
            fail(f"flash_decode_paged jamba {dtype}: the empty slot is not exactly 0")
        _slot_invariance(f"flash_decode_paged jamba {dtype}", lambda sl: flash_decode_paged(
            q[sl], k, v, pos[sl], start[sl], pages[sl]), B)
        qd, kd, vd = (torch.randn(1, 499, h, d, generator=gen, device="cuda").to(dtype)
                      .transpose(1, 2) for h in (H, Kh, Kh))
        err[(dtype, "dense")] = check_attn(f"flash_attention jamba {dtype}",
                                           flash_attention(qd, kd, vd),
                                           ref.flash_attention_ref(qd, kd, vd), dtype)
    torch.cuda.synchronize()
    log(f"SSM paths' kernels: bf16 GEMM at mamba2's head and w_out and jamba's (K, N) "
        f"agree, rows "
        f"bit-identical across M; int8 head exact; paged decode and dense attention at "
        f"jamba's heads (H {H} over K {Kh}, d {d}) x (f32, bf16) agree, the empty slot "
        f"exactly 0, every slot alone == batched; " + _errs(err))
    rows["attn_max_abs_err_bf16"] = _bf16_max(err)
    rows["decode"] = _paged_decode_row(flush, gen, H, Kh, SSM_POS, [0] * B, 91)
    return rows


def ssm_reference_check():
    """Reduced mamba2-130m and reduced jamba (f32 compute; SSD heads of 16,
    state 16, chunk 32; jamba one period of 8 layers, 4 experts top-2; seed-0
    weights) on the card's kernels against the CPU's plain versions, in
    float and w8a8 weights.

    Part 1, the model steps: a whole prefill of two 37-token prompts (a
    prime length: 37 chunks of one row), its KV rows written into pools of
    page size 16 through permuted tables and its SSD state into the slots'
    rows, then 12 paged ``decode_step``s on the same tokens (gate:
    ``_card_vs_cpu``: logits within 1e-4, or the flip rule in w8a8; jamba's
    MoE routing equal by ``routing_check``).  Part 2, a small engine,
    ``EngineConfig(max_batch=4, max_len=128, page_size=16, decode_chunk=4,
    prefix_cache=True)``: five prompts on four slots (one refilled), 16
    greedy tokens each, prefilled whole at admission, decode steps replayed
    as a CUDA graph on the card; the same on the CPU.  Gate: no radix tree,
    no mixed tick, equal greedy tokens (w8a8: unless Part 1 showed a
    boundary flip, then >= 0.9)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, check_invariants
    out = {}
    for name in ("mamba2-130m", "jamba-v0.1-52b"):
        cfg = reduce_config(get_config(name))
        V = cfg.vocab_size
        rng = np.random.RandomState(11)
        B, ps, npp, S, steps = 2, 16, 4, 37, 12
        toks = torch.from_numpy(rng.randint(0, V, (B, S + steps)).astype(np.int32))
        pages = torch.from_numpy(rng.permutation(np.arange(1, B * npp + 1))
                                 .reshape(B, npp).astype(np.int32))
        prompts = [rng.randint(0, V, n).tolist() for n in (34, 37, 29, 45, 32)]
        for quant in ("none", "w8a8"):
            p_cpu = M.init(cfg, seed=0, device="cpu")
            if quant == "w8a8":
                p_cpu = M.quantize_params(cfg, p_cpu)
            params = {"cpu": p_cpu, "cuda": _to_cuda(p_cpu)}
            caches = {d: M.init_paged_cache(cfg, B, B * npp + 1, ps, device=d)
                      for d in params}
            pairs = []
            with _Int8Recorder() as rec, _MoeRecorder() as mrec:
                lg = {}
                for d in params:
                    lg[d], small = M.prefill(cfg, params[d], toks[:, :S].to(d))
                    _scatter_prefill(cfg, caches[d], small, pages.to(d), S, ps)
                pairs.append((lg["cpu"], lg["cuda"].cpu()))
                for i in range(steps):
                    pos = torch.full((B,), S + i, dtype=torch.int32)
                    lg = {d: M.decode_step(cfg, params[d], caches[d],
                                           toks[:, S + i: S + i + 1].to(d), pos.to(d),
                                           pages=pages.to(d))[0].cpu() for d in params}
                    pairs.append((lg["cpu"], lg["cuda"]))
            res = _card_vs_cpu(f"reduced {name} paged", quant, pairs, rec)
            flipped = res["witness"] is not None and res["witness"]["first_flip"] is not None
            if cfg.num_experts:
                res["routing"] = routing_check(f"reduced {name} {quant}", mrec,
                                               strict=not flipped)
            econf = EngineConfig(max_batch=4, max_len=128, page_size=ps, decode_chunk=4,
                                 prefix_cache=True, quant=None if quant == "none" else quant)
            gens = {}
            for d in params:
                eng = Engine(cfg, params[d], econf, device=d)
                rids = [eng.submit(p, max_new=16) for p in prompts]
                by = {r.rid: r for r in eng.run()}
                gens[d] = [by[r].generated for r in rids]
                if eng.radix is not None or eng.stats.mixed_steps \
                        or eng.stats.prefills != len(prompts) \
                        or check_invariants(eng.pool, eng.radix, tables=eng.sched.owned):
                    fail(f"reduced {name} engine {quant} on {d}: a radix tree, a mixed tick, "
                         f"{eng.stats.prefills} prefills or a bad paging state")
                if d == "cuda" and eng.runner.graph.replays == 0:
                    fail(f"reduced {name} engine: the decode graph was never replayed")
            agree = statistics.mean(float(np.mean(np.array(a) == np.array(b)))
                                    for a, b in zip(gens["cpu"], gens["cuda"]))
            if (agree < 1.0 and not flipped) or agree < 0.9:
                fail(f"reduced {name} engine {quant}: card and CPU greedy tokens agree at "
                     f"{agree:.4f} (flip shown: {flipped})")
            res["engine_token_agreement"] = agree
            out[f"{name} {quant}"] = res
            routing = res.get("routing")
            log(f"reduced {name} {quant}, card vs CPU plain versions: whole prefill (S {S}) + "
                f"{steps} paged decode steps, max logits gap {res['gap']:.3e} (bound "
                f"{res['bound']:g}), argmax agreement {res['argmax_agreement']:.4f}"
                + (f", routing of {routing['calls']} MoE calls equal at "
                   f"{routing['token_agreement']:.4f} ({routing['witnesses']} near-tie "
                   f"witnesses)" if routing else "")
                + f"; engine (5 requests x 16 tokens on 4 slots, whole prefills, decode graph "
                f"on the card) greedy tokens card == CPU at {agree:.4f} of positions")
    return out


def _timed_prefills(eng):
    """Record (prompt length, wall ms) of every whole prefill ``eng`` runs
    (``whole_prefill`` ends in a device-to-host read: the time is the
    prefill's)."""
    runner, out = eng.runner, []
    inner = runner.whole_prefill

    def timed(tokens, *args):
        t0 = time.time()
        r = inner(tokens, *args)
        out.append((len(tokens), (time.time() - t0) * 1e3))
        return r
    runner.whole_prefill = timed
    return out


def _serve(cfg, params, econf, prompts, max_new, counters):
    """Serve ``prompts`` greedily through a fresh engine with every counter
    at 0.  Returns (engine, results by rid in prompt order, wall s, launches,
    [(prompt length, whole-prefill ms)])."""
    from repro_torch.serving import Engine
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    eng = Engine(cfg, params, econf)
    prefills = _timed_prefills(eng)
    t0 = time.time()
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    by = {r.rid: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.time() - t0
    return eng, [by[r] for r in rids], wall, {c.__name__: c.launches for c in counters}, prefills


def _check_served(name, eng, results, max_new, V, econf):
    """Every request LENGTH with ``max_new`` in-vocabulary tokens; no radix
    tree and no mixed tick (SSD is not prefix-decomposable, though the
    config asks for the prefix cache); one whole prefill a request; one
    replay a decode step; the pool reconciles."""
    from repro_torch.serving import FinishReason, check_invariants
    for r in results:
        if r.finish_reason != FinishReason.LENGTH or len(r.generated) != max_new \
                or not all(0 <= t < V for t in r.generated):
            fail(f"{name} rid {r.rid}: {r.finish_reason} with {len(r.generated)} tokens")
    st, graph = eng.stats, eng.runner.graph
    if eng.radix is not None or st.mixed_steps or st.prefills != len(results) \
            or graph.replays != st.chunks * econf.decode_chunk:
        fail(f"{name} engine: radix {eng.radix}, {st.mixed_steps} mixed ticks, "
             f"{st.prefills} prefills, {graph.replays} replays for {st.chunks} decode ticks")
    bad = check_invariants(eng.pool, eng.radix, tables=eng.sched.owned)
    if bad or eng.pool.num_free != eng.pool.n_pages - 1:
        fail(f"{name} paging state: " + "; ".join(bad) + f"; {eng.pool.num_free} free")


def _engine_summary(name, eng, results, wall, launches, prefills, econf):
    st, graph = eng.stats, eng.runner.graph
    ttft = sorted(r.ttft_s for r in results)
    by_len = {}
    for n, ms in prefills:
        by_len.setdefault(n, []).append(ms)
    summary = dict(tokens_per_s=st.tokens_out / wall, wall_s=wall,
                   ttft_p50_ms=statistics.median(ttft) * 1e3,
                   prefill_ms=st.prefill_s / st.prefills * 1e3,
                   prefill_ms_by_len={n: v for n, v in sorted(by_len.items())},
                   decode_tick_ms=(st.decode_s - graph.capture_s) / max(st.chunks, 1) * 1e3,
                   decode_ticks=st.chunks, capture_ms=graph.capture_s * 1e3,
                   launches=launches,
                   per_replay={c.__name__: n for c, n in graph.per_replay.items()})
    log(f"{name} engine: {len(results)} requests, {st.tokens_out} tokens in {wall:.3f} s "
        f"({summary['tokens_per_s']:.2f} tokens/s end to end), TTFT p50 "
        f"{summary['ttft_p50_ms']:.1f} ms, {st.prefills} whole prefills (ms by prompt length: "
        + ", ".join(f"{n}: " + "/".join(f"{m:.2f}" for m in v) for n, v in sorted(by_len.items()))
        + f"), {st.chunks} decode ticks x{econf.decode_chunk} at {summary['decode_tick_ms']:.2f} "
        f"ms wall without the graph's capture ({summary['capture_ms']:.1f} ms); launches "
        f"{json.dumps(launches)}; {json.dumps(summary['per_replay'])} a replay")
    return summary


def ssm_engine_phase(counters, gen):
    """Full-width, full-depth mamba2-130m (24 SSD layers, seeded random bf16
    weights) through ``repro_torch.serving.Engine`` after
    ``ssm_reference_check``: 8 greedy requests (``SSM_PROMPTS``, 32 new),
    ``EngineConfig(max_batch=8, max_len=1024, page_size=64, decode_chunk=8,
    prefix_cache=True)``.  Gates (``_check_served``): no radix tree, every
    tick a decode tick replaying the decode graph, the pool reconciles;
    only the bf16 GEMM launches (the head and each layer's w_out: 25 times
    a whole prefill, a replay, and the warm-up before capture); ``graph_check`` (SSD
    state included); two prompts served alone (the prime and the 256-row
    one) give the batched tokens; a traced decode tick as ``trace_ticks``.
    Then a short w8a8 pass (4 requests x 16 tokens: the head on the int8
    GEMM after one quantize, w_out -- no ``dense_proj`` weight of the
    reference's quantizer -- on the bf16 GEMM; its graph checked) and the
    direct ``prefill(cache_len=512)`` -> 8 greedy ``decode_step``s (B = 2 x
    300 tokens; only the bf16 GEMM, 25 times a call)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig
    names = {c.__name__: c for c in counters}
    summary = dict(reference=ssm_reference_check())
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("mamba2-130m")
    t0 = time.time()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"mamba2-130m: {cfg.num_layers} SSD layers, d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner} = {cfg.ssm_heads} heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, "
        f"conv {cfg.ssm_conv_width}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size} -> "
        f"{cfg.padded_vocab}; {n_params / 1e9:.4f} B parameters, {w_bytes / 1e9:.3f} GB, init "
        f"{time.time() - t0:.2f} s")
    econf = EngineConfig(max_batch=8, max_len=1024, page_size=64, decode_chunk=8,
                         prefix_cache=True)
    rng = np.random.RandomState(9)
    V = cfg.vocab_size
    prompts = [rng.randint(0, V, n).tolist() for n in SSM_PROMPTS]
    max_new = 32
    eng, results, wall, launches, prefills = _serve(cfg, params, econf, prompts, max_new,
                                                     counters)
    _check_served("mamba2-130m", eng, results, max_new, V, econf)
    graph = eng.runner.graph
    state_mb = sum(t.numel() * t.element_size() for t in graph.state) / 1e6
    per_fwd = 1 + cfg.num_layers  # the head and each layer's w_out
    for n, c in launches.items():
        if (n == "block_gemm") != (c > 0):
            fail(f"mamba2-130m engine: {n} launched {c} times (only the bf16 GEMM)")
    if graph.per_replay != {names["block_gemm"]: per_fwd} \
            or launches["block_gemm"] != per_fwd * (len(prompts) + graph.replays + 1):
        fail(f"mamba2-130m engine: {graph.per_replay} a replay, {launches['block_gemm']} bf16 "
             f"GEMMs for {len(prompts)} prefills and {graph.replays} replays ({per_fwd} a "
             f"forward)")
    summary.update(_engine_summary("mamba2-130m", eng, results, wall, launches, prefills,
                                   econf))
    summary.update(weights_gb=w_bytes / 1e9, params_b=n_params / 1e9, state_mb=state_mb)
    log(f"mamba2-130m: decode state {state_mb:.1f} MB (8 slots x 24 layers: h f32 and the "
        f"conv tails); peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB")
    batched = {tuple(p): r.generated for p, r in zip(prompts, results)}
    B, npp = econf.max_batch, econf.cache_spec().pages_per_seq
    table = torch.from_numpy(rng.permutation(np.arange(1, econf.n_pages))[: B * npp]
                             .reshape(B, npp).astype(np.int32))
    poison = torch.zeros(B, dtype=torch.bool)
    poison[3] = True
    cur = torch.from_numpy(rng.randint(0, V, B).astype(np.int32))
    graphs = {"bf16": graph_check("engine mamba2-130m bf16", graph, lambda: graph.load(
        cur, torch.tensor(SSM_POS, dtype=torch.int32), table, poison), gen)}
    del eng, graph
    for p in (prompts[2], prompts[3]):
        solo = Engine(cfg, params, econf)
        solo.submit(p, max_new=max_new)
        if solo.run()[0].generated != batched[tuple(p)]:
            fail(f"mamba2-130m: solo greedy tokens differ from batched for a {len(p)}-token "
                 f"prompt")
        del solo
    log("mamba2-130m: solo == batched greedy tokens for the 499- and 256-token prompts")
    summary["trace"] = trace_ticks(Engine(cfg, params, econf), prompts, max_new, summary,
                                   counters, kinds=("decode",))
    qconf = EngineConfig(max_batch=4, max_len=1024, page_size=64, decode_chunk=8,
                         prefix_cache=True, quant="w8a8")
    qeng, qres, qwall, qlaunch, _ = _serve(cfg, params, qconf, prompts[:4], 16, counters)
    _check_served("mamba2-130m w8a8", qeng, qres, 16, V, qconf)
    if qlaunch["block_gemm"] != cfg.num_layers * qlaunch["block_gemm_int8"] \
            or qlaunch["block_gemm_int8"] <= 0 \
            or qlaunch["quantize_rows"] != qlaunch["block_gemm_int8"]:
        fail(f"mamba2-130m w8a8 engine launches {qlaunch}: the head on the int8 GEMM after "
             f"one quantize, each layer's float w_out on the bf16 GEMM")
    agree = statistics.mean(sum(a == b for a, b in zip(r.generated, batched[tuple(p)])) / 16
                            for r, p in zip(qres, prompts[:4]))
    log(f"mamba2-130m engine w8a8: 4 requests x 16 tokens in {qwall:.3f} s; launches "
        f"{json.dumps(qlaunch)}; greedy tokens equal to bf16's at {agree:.4f} of positions")
    qg, qB = qeng.runner.graph, qconf.max_batch
    qtable = torch.from_numpy(rng.permutation(np.arange(1, qconf.n_pages))[: qB * npp]
                              .reshape(qB, npp).astype(np.int32))
    graphs["w8a8"] = graph_check("engine mamba2-130m w8a8", qg, lambda: qg.load(
        cur[:qB], torch.tensor(SSM_POS[:qB], dtype=torch.int32), qtable, poison[:qB]), gen)
    del qeng, qg
    summary["w8a8"] = dict(wall_s=qwall, launches=qlaunch, token_agreement=agree)
    summary["graph_per_replay"] = graphs
    # the direct loop on slot caches: prefill(cache_len) -> 8 steps
    Bd, Sd, steps, cache_len = 2, 300, 8, 512
    toks = torch.from_numpy(rng.randint(0, V, (Bd, Sd)).astype(np.int32)).cuda()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    logits, caches = M.prefill(cfg, params, toks, cache_len=cache_len)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    pre = {n: c.launches for n, c in names.items()}
    t0 = time.time()
    for i in range(steps):
        tok = torch.argmax(logits[:, -1, :V], -1).to(torch.int32)[:, None]
        logits, caches = M.decode_step(cfg, params, caches, tok, Sd + i)
        if logits.shape != (Bd, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"mamba2-130m direct decode step {i}: shape {tuple(logits.shape)} or "
                 f"non-finite logits")
    torch.cuda.synchronize()
    t_step = (time.time() - t0) / steps
    direct = {n: c.launches for n, c in names.items()}
    h = caches[0]["0"]["h"]
    if tuple(h.shape) != (cfg.num_layers, Bd, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state) \
            or pre["block_gemm"] != per_fwd or direct["block_gemm"] != per_fwd * (1 + steps) \
            or sum(direct.values()) != direct["block_gemm"]:
        fail(f"mamba2-130m direct loop: state {tuple(h.shape)}, launches after the prefill "
             f"{pre}, after {steps} steps {direct}")
    summary["direct"] = dict(prefill_ms=t_pre * 1e3, eager_step_ms=t_step * 1e3,
                             launches=direct)
    log(f"mamba2-130m direct loop: prefill {Bd}x{Sd} (cache_len {cache_len}: the state is "
        f"not padded) in {t_pre * 1e3:.1f} ms, {steps} eager decode steps on the slot caches at "
        f"{t_step * 1e3:.2f} ms; launches {json.dumps(direct)}")
    return summary


JAMBA_PATH = ("block_gemm", "flash_attention", "flash_decode_paged")


def jamba_engine_phase(counters, gen):
    """Full-width jamba-v0.1-52b over one layer period (8 layers: SSD, with
    attention at index 4 and MoE on odd layers), seeded random bf16 weights
    drawn on the card after every earlier model is freed, through the
    whole-prefill engine: 8 greedy requests as ``ssm_engine_phase``'s.  The
    depth is cut because the whole model (~104 GB of bf16 weights) does not
    fit one 80 GB card.  Gates (``_check_served``); only the bf16 GEMM,
    dense flash attention (once a whole prefill: one attention layer) and
    paged flash-decode (once a replay, and once for the warm-up) launch;
    ``graph_check``; a traced decode tick as ``trace_ticks``.  No solo ==
    batched gate: MoE capacity is shared by a call's rows (as for
    qwen3-moe)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    from repro_torch.serving import Engine, EngineConfig
    full = get_config("jamba-v0.1-52b")
    cfg = full.with_(num_layers=full.ssm_every)
    full_bytes = count_params(M.param_specs(full)) * 2
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"jamba-v0.1-52b depth cut: {full.num_layers} -> {cfg.num_layers} layers (one period: "
        f"{[s.mixer[:4] + '/' + s.ffn for s in cfg.layer_specs()]}), because the whole model's "
        f"{full_bytes / 1e9:.1f} GB of bf16 weights exceed the card's {total / 1e9:.1f} GB")
    log(f"jamba-v0.1-52b (one period): d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads}, SSD {cfg.ssm_heads} heads of {cfg.ssm_headdim} state "
        f"{cfg.ssm_state}, {cfg.num_experts} experts top-{cfg.experts_per_token} of width "
        f"{cfg.moe_d_ff}; {n_params / 1e9:.3f} B parameters, {w_bytes / 1e9:.2f} GB (routers "
        f"f32), init {init_s:.2f} s; {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB free "
        f"before init")
    econf = EngineConfig(max_batch=8, max_len=1024, page_size=64, decode_chunk=8,
                         prefix_cache=True)
    rng = np.random.RandomState(10)
    V = cfg.vocab_size
    prompts = [rng.randint(0, V, n).tolist() for n in SSM_PROMPTS]
    max_new = 32
    eng, results, wall, launches, prefills = _serve(cfg, params, econf, prompts, max_new,
                                                     counters)
    peak = torch.cuda.max_memory_allocated()
    _check_served("jamba", eng, results, max_new, V, econf)
    graph = eng.runner.graph
    per_replay = {c.__name__: n for c, n in graph.per_replay.items()}
    for n, c in launches.items():
        if (n in JAMBA_PATH) != (c > 0):
            fail(f"jamba engine: {n} launched {c} times (the path: {JAMBA_PATH})")
    if launches["flash_attention"] != len(prompts) or per_replay.get("flash_decode_paged") != 1 \
            or launches["flash_decode_paged"] != graph.replays + 1:
        fail(f"jamba engine: {launches['flash_attention']} dense attention launches for "
             f"{len(prompts)} prefills, {per_replay} a replay, {launches['flash_decode_paged']} "
             f"paged decodes for {graph.replays} replays")
    summary = _engine_summary("jamba", eng, results, wall, launches, prefills, econf)
    summary.update(weights_gb=w_bytes / 1e9, params_b=n_params / 1e9, peak_gib=peak / 2 ** 30,
                   init_s=init_s, layers=cfg.num_layers, full_weights_gb=full_bytes / 1e9)
    log(f"jamba: peak device memory {peak / 2 ** 30:.2f} GiB after the engine run (weights "
        f"{w_bytes / 2 ** 30:.2f} GiB)")
    B, npp = econf.max_batch, econf.cache_spec().pages_per_seq
    table = torch.from_numpy(rng.permutation(np.arange(1, econf.n_pages))[: B * npp]
                             .reshape(B, npp).astype(np.int32))
    poison = torch.zeros(B, dtype=torch.bool)
    poison[6] = True
    cur = torch.from_numpy(rng.randint(0, V, B).astype(np.int32))
    summary["graph_per_replay"] = graph_check("engine jamba bf16", graph, lambda: graph.load(
        cur, torch.tensor(SSM_POS, dtype=torch.int32), table, poison), gen)
    del eng, graph
    summary["trace"] = trace_ticks(Engine(cfg, params, econf), prompts, max_new, summary,
                                   counters, kinds=("decode",))
    return summary


# ---------------------------------------------------------------------------
# phase 8: the cross-attention VLM and the bidirectional audio encoder
# ---------------------------------------------------------------------------

VLM, ENC = "llama-3.2-vision-11b", "hubert-xlarge"
VLM_B, VLM_S, VLM_CACHE, VLM_STEPS = 2, 500, 1024, 32
ENC_B, ENC_T = 4, 1000  # 20 s of audio at HuBERT's 50 frames a second
# the bf16 GEMM's rows at both models' shapes (M, K, N): llama's decode
# projections (wq / wo, w_gate / w_up, w_down, the head with f32 out), the
# image's K/V at prefill (M = B * 1601, N = 8 kv-heads x 128), hubert's
# w1 over 4 x 1000 frames
VLM_GEMMS = ((8, 4096, 4096), (8, 4096, 14336), (8, 14336, 4096), (8, 4096, 128256),
             (3202, 4096, 1024), (4000, 1280, 5120))
# the int8 GEMM, exact, at the w8a8 passes' shapes: decode and prefill
# (M = B * S = 1000) projections, the head, the image's K/V, hubert's MLP
VLM_INT8 = ((2, 4096, 4096), (2, 4096, 14336), (2, 14336, 4096), (2, 4096, 128256),
            (1000, 4096, 4096), (1000, 4096, 1024), (1000, 4096, 14336), (1000, 14336, 4096),
            (3202, 4096, 1024), (4000, 1280, 5120), (4000, 5120, 1280))


def _open_zero_leaves(tree, gen):
    """In place: every cross-attention gate to 0.5 (``tanh(0) = 0`` would
    hide the cross sub-blocks) and every zero-initialised bias (the GELU
    MLP's b1 / b2, LayerNorm's bias) to 0.1 x N(0, 1) from ``gen``, which
    lives on the tree's device."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            _open_zero_leaves(v, gen)
        elif k == "gate":
            v.fill_(0.5)
        elif k in ("b1", "b2", "bias"):
            v.copy_(0.1 * torch.randn(v.shape, generator=gen, device=v.device))


def _attn_row(flush, name, q, k, v, causal):
    """Time dense flash attention on q [B,H,Sq,d], k/v [B,K,Sk,d] beside the
    plain version, SDPA (GQA, the same mask) and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal), flush, reps=10)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), flush, reps=5)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), flush)
    pairs = Sq * Sk if not causal else sum(min(i + 1 + Sk - Sq, Sk) for i in range(Sq))
    bms, by = bound_ms(2 * (2 * B * H * Sq * d + 2 * B * K * Sk * d),
                       4 * B * H * pairs * d, torch.bfloat16)
    shape = f"{name} B{B} H{H} K{K} Sq{Sq} Sk{Sk} d{d}"
    log(f"  flash_attention bf16 {shape}{'' if causal else ' bidirectional'}: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(shape=shape, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by)


def vlm_kernel_phase(flush, gen):
    """The kernels of the VLM and encoder paths at their shapes, beside their
    plain versions, the library call and the bound.  Dense attention
    (bidirectional): hubert's forward (B 4, 16 heads of 80 over 16, S 1000),
    the cross prefill (B 2, 32 heads over 8 of 128, Sq 500 over Sk 1601) and
    the cross decode (Sq 1 over 1601), against SDPA; its gates at these
    shapes are ``dense_attention_phase``'s cases.  Slot flash-decode at
    llama's heads (G 4, d 128; B 2 on a linear cache of 1024 rows, 532 live,
    the last decode step's) against SDPA with a live-row mask, gated in f32
    and bf16.  The bf16 GEMM at ``VLM_GEMMS`` against ``torch.matmul``
    (gated as ``gemm_phase``, rows bit-identical across M); the int8 GEMM
    exactly at ``VLM_INT8``; the row quantize bit for bit at the w8a8
    passes' activations.  Returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import block_gemm, gemm_splits
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.quantize import quantize_rows
    rows = {"attention": [], "gemm": []}
    bf = torch.bfloat16

    def qkv(B, H, K, Sq, Sk, d):  # the layers' layout, transposed without a copy
        return tuple(torch.randn(B, S, h, d, generator=gen, device="cuda").to(bf)
                     .transpose(1, 2) for S, h in ((Sq, H), (Sk, K), (Sk, K)))

    for name, shape in (("hubert", (ENC_B, 16, 16, ENC_T, ENC_T, 80)),
                        ("cross prefill", (VLM_B, 32, 8, VLM_S, 1601, 128)),
                        ("cross decode", (VLM_B, 32, 8, 1, 1601, 128))):
        rows["attention"].append(_attn_row(flush, name, *qkv(*shape), causal=False))

    B, H, Kh, d, S = VLM_B, 32, 8, 128, VLM_CACHE
    pos = torch.full((B,), VLM_S + VLM_STEPS - 1, dtype=torch.int32, device="cuda")
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    err = {}
    for dtype in (torch.float32, bf):
        q = torch.randn(B, H, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, S, Kh, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, Kh, d, generator=gen, device="cuda").to(dtype)
        err[dtype] = check_attn(f"flash_decode llama {dtype}", flash_decode(q, k, v, pos, start),
                                ref.flash_decode_ref(q, k, v, pos, start), dtype)
    ms = time_ms(lambda: flash_decode(q, k, v, pos, start), flush)
    plain = time_ms(lambda: ref.flash_decode_ref(q, k, v, pos, start), flush)
    mask = _live_mask(pos, start, S, False)[:, None, None, :]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True), flush)
    live = int(mask.sum())
    bms, by = bound_ms(2 * (2 * live * Kh * d + 2 * B * H * d) + 8 * B, 4 * live * H * d, bf)
    rows["decode"] = dict(shape=f"linear B{B} H{H} K{Kh} S{S} d{d} live{live}", ms=ms,
                          plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                          max_abs_err=err[bf][0])
    log(f"  flash_decode bf16 llama linear B={B} H={H} K={Kh} S={S} ({live} live rows): kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA+mask {lib:.4f} ms, bound {bms:.4f} ms "
        f"({by}); f32 / bf16 max_abs_err {err[torch.float32][0]:.3e} / {err[bf][0]:.3e}")

    gemm_err = 0.0
    for (M, K, N) in VLM_GEMMS:
        f32_out = N == 128256
        out_dtype = torch.float32 if f32_out else bf
        a = torch.randn(M, K, generator=gen, device="cuda").to(bf)
        b = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)).to(bf)
        gemm_err = max(gemm_err, check_close(
            f"block_gemm bf16 {M}x{K}x{N}", block_gemm(a, b, out_dtype=out_dtype),
            ref.block_gemm_ref(a, b, out_dtype), 1e-4, 1e-5 if f32_out else 2.0 ** -7))
        ms = time_ms(lambda: block_gemm(a, b, out_dtype=out_dtype), flush)
        plain = time_ms(lambda: ref.block_gemm_ref(a, b, out_dtype), flush)
        lib = time_ms(lambda: torch.matmul(a, b), flush)  # bf16 out, as the earlier rows
        bms, by = bound_ms(2 * (M * K + K * N) + M * N * (4 if f32_out else 2), 2 * M * N * K,
                           bf)
        rows["gemm"].append(dict(shape=f"{M}x{K}x{N}", ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=bms, bound_by=by))
        log(f"  block_gemm bf16 {M}x{K}x{N}{' f32 out' if f32_out else ''} (K split "
            f"{gemm_splits(K, N)}): kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.matmul "
            f"{lib:.4f} ms, bound {bms:.4f} ms ({by})")
    gemm_row_invariance(gen, [(K, N, False) for (_, K, N) in VLM_GEMMS[:4]])
    rows["gemm_max_abs_err"] = gemm_err
    for (M, K, N) in VLM_INT8:
        int8_exact(gen, M, K, N)
    for M, K in ((VLM_B, 4096), (VLM_B, 14336), (VLM_B * VLM_S, 4096), (VLM_B * 1601, 4096),
                 (ENC_B * ENC_T, 1280), (ENC_B * ENC_T, 5120)):
        x = torch.randn(M, K, generator=gen, device="cuda").to(bf)
        q, scale = quantize_rows(x)
        qr, sr = ref.quantize_rows_ref(x)
        if not (torch.equal(q, qr) and torch.equal(scale, sr)):
            fail(f"quantize_rows bf16 {M}x{K}: differs from the plain version")
    torch.cuda.synchronize()
    log(f"VLM / encoder kernels: bf16 GEMM at {len(VLM_GEMMS)} shapes agrees (max_abs_err "
        f"{gemm_err:.3e}), rows bit-identical across M; int8 GEMM exact at {len(VLM_INT8)} "
        f"shapes; quantize_rows bit-identical at 6 shapes; slot decode at G 4 agrees")
    return rows


def vlm_reference_check():
    """Reduced llama-3.2-vision-11b (f32 compute; 5 layers, the cross layer
    at index 4, 16 image tokens of width 32; seed-0 weights, gates 0.5) on
    the card's kernels against the CPU's plain versions, float and w8a8:
    ``prefill(tokens, images, cache_len=64)`` of two 40-token prompts, then
    12 ``decode_step``s on slot caches (cross-attention over the cached
    image K/V at Sq = 1).  Gate: ``_card_vs_cpu``."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    cfg = reduce_config(get_config(VLM))
    rng = np.random.RandomState(13)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 52)).astype(np.int32))
    img = torch.from_numpy(rng.randn(2, cfg.vision_tokens, cfg.vision_dim).astype(np.float32))
    out = {}
    for quant in ("none", "w8a8"):
        p_cpu = M.init(cfg, seed=0, device="cpu")
        _open_zero_leaves(p_cpu, torch.Generator().manual_seed(5))
        if quant == "w8a8":
            p_cpu = M.quantize_params(cfg, p_cpu)
        p_gpu = _to_cuda(p_cpu)
        with _Int8Recorder() as rec:
            lc, cc = M.prefill(cfg, p_cpu, toks[:, :40], images=img, cache_len=64)
            lg, cg = M.prefill(cfg, p_gpu, toks[:, :40].cuda(), images=img.cuda(), cache_len=64)
            pairs = [(lc, lg.cpu())]
            for i in range(12):
                tok = toks[:, 40 + i: 41 + i]
                lc, cc = M.decode_step(cfg, p_cpu, cc, tok, 40 + i)
                lg, cg = M.decode_step(cfg, p_gpu, cg, tok.cuda(), 40 + i)
                pairs.append((lc, lg.cpu()))
        out[quant] = _card_vs_cpu(f"reduced {VLM}", quant, pairs, rec)
        log(f"reduced {VLM} {quant}, card kernels vs CPU plain versions: prefill (40 tokens, "
            f"16 image tokens) + 12 decode steps, max logits gap {out[quant]['gap']:.3e} "
            f"(bound {out[quant]['bound']:g}), argmax agreement "
            f"{out[quant]['argmax_agreement']:.4f}")
    return out


def encoder_reference_check():
    """Reduced hubert-xlarge (f32 compute; 2 layers, 4 heads of 16, frames
    of width 64; seed-0 weights, biases 0.1 x N(0, 1)) on the card's kernels
    against the CPU's plain versions, float and w8a8: the bidirectional
    forward over 2 x 100 frames and the logits of every frame.  Gate:
    ``_card_vs_cpu``."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import model as M
    cfg = reduce_config(get_config(ENC))
    frames = torch.from_numpy(np.random.RandomState(14).randn(2, 100, cfg.frontend_dim)
                              .astype(np.float32))
    out = {}
    for quant in ("none", "w8a8"):
        p_cpu = M.init(cfg, seed=0, device="cpu")
        _open_zero_leaves(p_cpu, torch.Generator().manual_seed(6))
        if quant == "w8a8":
            p_cpu = M.quantize_params(cfg, p_cpu)
        p_gpu = _to_cuda(p_cpu)
        with _Int8Recorder() as rec:
            lc = M.lm_logits(cfg, p_cpu, M.forward_hidden(cfg, p_cpu, frames=frames)[0])
            lg = M.lm_logits(cfg, p_gpu, M.forward_hidden(cfg, p_gpu, frames=frames.cuda())[0])
        out[quant] = _card_vs_cpu(f"reduced {ENC}", quant, [(lc, lg.cpu())], rec)
        log(f"reduced {ENC} {quant}, card kernels vs CPU plain versions: forward over 2 x 100 "
            f"frames, max logits gap {out[quant]['gap']:.3e} (bound {out[quant]['bound']:g}), "
            f"argmax agreement {out[quant]['argmax_agreement']:.4f}")
    return out


def _launched(counters, names, want, what):
    """Fail unless the wrappers' counts ``{name: n}`` of ``counters`` are
    ``want`` for every name listed there and 0 for the others."""
    got = {c.__name__: c.launches for c in counters}
    for n in names:
        if got[n] != want.get(n, 0):
            fail(f"{what}: {n} launched {got[n]} times, not {want.get(n, 0)}")
    return got


def vlm_phase(counters, gen):
    """Full-width, full-depth llama-3.2-vision-11b (bf16, seed-0 weights drawn
    on the card after every earlier model is freed, gates 0.5): B = 2
    prompts of 500 tokens, each with 1601 random patch embeddings;
    ``prefill(images=..., cache_len=1024)``, then 32 greedy steps replayed as
    a CUDA graph (``_greedy_run``); then the same with ``quantize_params``
    (w8a8) on the bf16 run's tokens.  Launches, counted with every counter
    at 0 just before each run: a prefill runs 7 GEMMs a layer, 4 more a
    cross layer (the image's K/V and the cross q and o) and the head, and
    one dense attention a layer (causal) and a cross layer (bidirectional,
    Sq 500 over 1601 keys); a step 7 a layer, 2 more a cross layer and the
    head, one slot decode a layer and one dense attention a cross layer (Sq
    1 over 1601).  Under w8a8 each GEMM is an int8 GEMM, one quantize per
    distinct activation, no bf16 GEMM.  ``graph_check`` (the image K/V
    among the state leaves) and a traced step follow."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    small = vlm_reference_check()
    cfg = get_config(VLM)
    names = [c.__name__ for c in counters]
    L_, X = cfg.num_layers, cfg.num_layers // cfg.cross_every
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init(cfg, seed=0, device="cuda")
    _open_zero_leaves(params, gen)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"{VLM}: {L_} layers ({X} cross), d_model {cfg.d_model}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} of {cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.vision_tokens} "
        f"image tokens of width {cfg.vision_dim}; {n_params / 1e9:.3f} B parameters, "
        f"{w_bytes / 1e9:.2f} GB bf16, init {init_s:.2f} s; {free / 2 ** 30:.2f} of "
        f"{total / 2 ** 30:.2f} GiB free before init")
    B, S, V = VLM_B, VLM_S, cfg.vocab_size
    prompts = torch.from_numpy(np.random.RandomState(12).randint(0, V, (B, S))
                               .astype(np.int32)).cuda()
    images = torch.randn(B, cfg.vision_tokens, cfg.vision_dim, generator=gen,
                         device="cuda").bfloat16()
    per_prefill = {"block_gemm": 7 * L_ + 4 * X + 1, "flash_attention": L_ + X}
    per_step = {"block_gemm": 7 * L_ + 2 * X + 1, "flash_decode": L_, "flash_attention": X}
    quant_prefill = {"block_gemm_int8": per_prefill["block_gemm"],
                     "quantize_rows": 4 * L_ + 3 * X + 1, "flash_attention": L_ + X}
    quant_step = {"block_gemm_int8": per_step["block_gemm"], "quantize_rows": 4 * L_ + 2 * X + 1,
                  "flash_decode": L_, "flash_attention": X}
    out = {"params_b": n_params / 1e9, "weights_gb": w_bytes / 1e9, "init_s": init_s,
           "small": small}
    toks = None
    for quant, p in (("bf16", params), ("w8a8", None)):
        if quant == "w8a8":
            t0 = time.time()
            p = M.quantize_params(cfg, params)
            torch.cuda.synchronize()
            out["quantize_params_s"] = time.time() - t0
            want_pre, want_step = quant_prefill, quant_step
        else:
            want_pre, want_step = per_prefill, per_step
        _greedy_run(cfg, p, prompts, VLM_CACHE, 2, images=images)  # warm-up
        for c in counters:
            c.launches = 0
        outs, got_toks, t_pre, t_step, graph = _greedy_run(
            cfg, p, prompts, VLM_CACHE, VLM_STEPS, forced=toks, images=images)
        run = _launched(counters, names, {n: want_pre.get(n, 0) + (VLM_STEPS + 1)
                                          * want_step.get(n, 0) for n in names},
                        f"{VLM} {quant} run")
        step = {c.__name__: n for c, n in graph.per_replay.items()}
        if step != want_step or graph.replays != VLM_STEPS:
            fail(f"{VLM} {quant}: a replay launches {step}, not {want_step}; "
                 f"{graph.replays} replays")
        for c in counters:
            c.launches = 0
        M.prefill(cfg, p, prompts, images=images, cache_len=VLM_CACHE)
        _launched(counters, names, want_pre, f"{VLM} {quant} prefill")
        for i, lg in enumerate(outs):
            if lg.shape != (B, V) or not bool(torch.isfinite(lg).all()):
                fail(f"{VLM} {quant} logits {i}: shape {tuple(lg.shape)} or non-finite")
        res = dict(prefill_ms=t_pre * 1e3, step_ms=t_step * 1e3, run_launches=run,
                   per_prefill=want_pre, per_replay=step, capture_ms=graph.capture_s * 1e3)
        log(f"{VLM} {quant}: prefill {B}x{S} tokens + {B}x{cfg.vision_tokens} image tokens in "
            f"{t_pre * 1e3:.1f} ms; {VLM_STEPS - 1} replayed decode steps at {t_step * 1e3:.3f} "
            f"ms (captured in {graph.capture_s * 1e3:.1f} ms); launches per prefill "
            f"{json.dumps(want_pre)}, per replay {json.dumps(step)}, in the run "
            f"{json.dumps({n: c for n, c in run.items() if c})}")
        if quant == "bf16":
            toks = got_toks
            state = {tuple(t.shape) for t in graph.state}
            if len(graph.state) != 2 or state != {(X, B, cfg.vision_tokens, cfg.num_kv_heads,
                                                   cfg.head_dim)}:
                fail(f"{VLM}: the decode graph's state leaves are {state}, not the image K/V")
            res["graph_per_replay"] = graph_check(f"{VLM} bf16 slot caches", graph, lambda: (
                graph.load(toks[-1], torch.full((B,), S + VLM_STEPS, dtype=torch.int32),
                           nanmask=torch.tensor([False, True]))), gen)
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

            def one():
                lf, _ = graph.run()
                graph.cur.copy_(torch.argmax(lf, -1).to(torch.int32))
            dev, top, _, (n_graph, n_kernel) = _traced(one)
            if n_graph != 1:
                fail(f"traced {VLM} step: {n_graph} CUDA graph launches, not 1")
            res["trace"] = dict(device_ms=dev, untraced_ms=t_step * 1e3, top=top,
                                idle_share=1 - dev / (t_step * 1e3) if dev else None,
                                graph_launches=n_graph, kernel_launches=n_kernel)
            log(f"traced {VLM} decode step: device {dev:.3f} ms of an untraced "
                f"{t_step * 1e3:.3f} ms, {n_graph} cudaGraphLaunch + {n_kernel} kernels; top "
                f"kernels (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in top.items())
                if dev else f"traced {VLM} step: the profiler saw no device time "
                "(not measured)")
            bf_outs = outs
        else:
            res["argmax_agreement_vs_bf16"] = float(torch.mean(torch.stack([
                (torch.argmax(a, -1) == torch.argmax(b, -1)).float()
                for a, b in zip(outs, bf_outs)])))
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"{VLM} w8a8 vs bf16 argmax agreement on the same tokens "
                f"{res['argmax_agreement_vs_bf16']:.4f} over {len(outs) * B} positions "
                f"(information); peak device memory {res['peak_gib']:.2f} GiB")
        out[quant] = res
        del graph, outs
    return out


def encoder_phase(counters, gen):
    """Full-width, full-depth hubert-xlarge (bf16, seed-0 weights, biases 0.1
    x N(0, 1)): ``forward_hidden(frames=...)`` over B = 4 utterances of 1000
    frames (20 s at 50 frames a second), then ``lm_logits`` on every frame,
    in bf16 and w8a8.  Launches per forward, counted with every counter at
    0 just before it: 6 GEMMs a layer (q, k, v, o, w1, w2) and the head, one
    bidirectional dense attention a layer (16 heads of 80); under w8a8 int8
    GEMMs and 4 quantizes a layer and the head's.  The forward's wall time
    (median of 3 after a warm-up) and a traced forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    small = encoder_reference_check()
    cfg = get_config(ENC)
    names = [c.__name__ for c in counters]
    L_ = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init(cfg, seed=0, device="cuda")
    _open_zero_leaves(params, gen)
    n_params = sum(t.numel() for t in _leaves(params))
    frames = torch.randn(ENC_B, ENC_T, cfg.frontend_dim, generator=gen, device="cuda").bfloat16()
    out = {"params_b": n_params / 1e9, "small": small}

    for quant in ("bf16", "w8a8"):
        p = params if quant == "bf16" else M.quantize_params(cfg, params)
        want = ({"block_gemm": 6 * L_ + 1, "flash_attention": L_} if quant == "bf16" else
                {"block_gemm_int8": 6 * L_ + 1, "quantize_rows": 4 * L_ + 1,
                 "flash_attention": L_})

        def forward():
            return M.lm_logits(cfg, p, M.forward_hidden(cfg, p, frames=frames)[0])
        forward()  # warm-up
        times = []
        for _ in range(3):
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            logits = forward()
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            got = _launched(counters, names, want, f"{ENC} {quant} forward")
        if logits.shape != (ENC_B, ENC_T, cfg.padded_vocab) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"{ENC} {quant}: logits {tuple(logits.shape)} or non-finite")
        fwd_ms = statistics.median(times) * 1e3
        dev, top, _, _ = _traced(forward)
        res = dict(forward_ms=fwd_ms, launches=got, trace=dict(
            device_ms=dev, untraced_ms=fwd_ms, top=top,
            idle_share=1 - dev / fwd_ms if dev else None))
        log(f"{ENC} {quant}: forward over {ENC_B} x {ENC_T} frames + logits of every frame in "
            f"{fwd_ms:.2f} ms (median of 3); launches per forward "
            f"{json.dumps({n: c for n, c in got.items() if c})}; traced: device {dev:.3f} ms; "
            f"top kernels (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in top.items()))
        top1 = logits[..., : cfg.vocab_size].argmax(-1)
        if quant == "bf16":
            bf16_top1 = top1
        else:
            res["argmax_agreement_vs_bf16"] = float((top1 == bf16_top1).float().mean())
        out[quant] = res
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{ENC}: {L_} layers, d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, "
        f"{n_params / 1e9:.3f} B parameters; w8a8 vs bf16 frame argmax agreement "
        f"{out['w8a8']['argmax_agreement_vs_bf16']:.4f} (information); peak device memory "
        f"{out['peak_gib']:.2f} GiB")
    return out


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def trace_ticks(eng, prompts, max_new, summary, counters, kinds=("mixed", "decode")):
    """Device time of one mixed tick and one decode-only tick (``kinds``:
    an engine without chunks has no mixed tick) under torch.profiler, by
    kernel, set against the untraced tick times of the main run: idle share
    = 1 - device time / untraced tick time.  The decode tick may launch the
    decode graph at most ``decode_chunk`` times and fewer than 300 other
    kernels; each tick's graph replays and kernel launches (by wrapper, and
    on the host) are printed."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.submit(p, max_new=max_new)
    out = {}
    for kind in kinds:
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


# ---------------------------------------------------------------------------
# phase 9: training (the block GEMM's VJP, AdamW, the train step, the runner)
# ---------------------------------------------------------------------------

TRAIN = "olmo-1b"
TRAIN_B, TRAIN_S = 8, 512          # 4096 tokens a step
TRAIN_T = TRAIN_B * TRAIN_S
TRAIN_STEPS = 10
# olmo-1b's GEMMs at T = 4096 rows: (K, N) of q/k/v/o, w_gate/w_up, w_down
# and the untied head (N = the padded vocab, 50432)
TRAIN_KN = ((2048, 2048), (2048, 8192), (8192, 2048), (2048, 50432))


def _train_gemm_cases(T=TRAIN_T, kns=TRAIN_KN, head_n=None):
    """The three products of every forward GEMM A [T, K] @ W [K, N] of the
    train step: forward (f32 out at the head, whose N is a vocab or its
    shard: ``head_n``, or any N of 25216 and more), ``g @ W^T``
    (``trans_b``, the data gradient) and ``A^T @ g`` (``trans_a``, the
    weight gradient: M = K rows over the T tokens)."""
    out = []
    for K, N in kns:
        head = N == head_n if head_n is not None else N >= 25216
        out.append(dict(kind="forward", M=T, K=K, N=N, ta=False, tb=False,
                        out=torch.float32 if head else torch.bfloat16))
        out.append(dict(kind="backward g @ W^T", M=T, K=N, N=K, ta=False, tb=True,
                        out=torch.bfloat16))
        out.append(dict(kind="backward A^T @ g", M=K, K=T, N=N, ta=True, tb=False,
                        out=torch.bfloat16))
    return out


def _gemm_operands(gen, M, K, N, ta, tb, dtype=torch.bfloat16):
    """A ([M, K], or [K, M] with ``ta``) of unit normal entries and B ([K,
    N], or [N, K] with ``tb``) scaled by 1/sqrt(K): O(1) outputs."""
    a = torch.randn(*((K, M) if ta else (M, K)), generator=gen, device="cuda")
    b = torch.randn(*((N, K) if tb else (K, N)), generator=gen, device="cuda") / math.sqrt(K)
    return a.to(dtype), b.to(dtype)


def _gemm_case_rows(cases, flush, gen, what=None):
    """Each product of ``cases`` (dicts of M, K, N, ta, tb, out, kind) on
    the bf16 GEMM against its plain version (1e-4 + 2^-7 relative for bf16
    out, 1e-4 + 1e-5 for f32 out), timed beside the plain version,
    ``torch.matmul`` and the bound (operations at the bf16 peak, or bytes);
    ``what`` prefixes each printed row's kind.  Returns (max abs error,
    rows)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import block_gemm, gemm_splits
    err, rows = 0.0, []
    for c in cases:
        M, K, N, ta, tb, out = c["M"], c["K"], c["N"], c["ta"], c["tb"], c["out"]
        a, b = _gemm_operands(gen, M, K, N, ta, tb)
        got = block_gemm(a, b, out_dtype=out, trans_a=ta, trans_b=tb)
        want = ref.block_gemm_ref(a, b, out, trans_a=ta, trans_b=tb)
        rtol = 1e-5 if out == torch.float32 else 2.0 ** -7
        shape = f"{M}x{K}x{N}" + (" trans_a" if ta else "") + (" trans_b" if tb else "")
        err = max(err, check_close(f"block_gemm bf16 {shape}", got, want, 1e-4, rtol))
        del got, want
        reps = 10
        ms = time_ms(lambda: block_gemm(a, b, out_dtype=out, trans_a=ta, trans_b=tb), flush,
                     reps=reps)
        plain = time_ms(lambda: ref.block_gemm_ref(a, b, out, trans_a=ta, trans_b=tb), flush,
                        reps=reps)
        lib = time_ms(lambda: torch.matmul(a.T if ta else a, b.T if tb else b), flush,
                      reps=reps)
        bms, by = bound_ms(2 * (M * K + K * N) + M * N * (4 if out == torch.float32 else 2),
                           2 * M * N * K, torch.bfloat16)
        rows.append(dict(shape=shape, kind=c["kind"], ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bms, bound_by=by))
        kind = f"{what}, {c['kind']}" if what else c["kind"]
        log(f"  block_gemm bf16 {shape} ({kind}, K split {gemm_splits(K, N)}): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, torch.matmul {lib:.4f} ms, bound {bms:.4f} ms "
            f"({by}); {2 * M * N * K / ms / 1e9:.1f} TFLOP/s")
        del a, b
    torch.cuda.empty_cache()
    return err, rows


def train_gemm_phase(flush, gen):
    """The bf16 GEMM at olmo-1b's training shapes (T = 8 x 512 = 4096
    tokens): each of the twelve products of ``_train_gemm_cases`` against
    its plain version (``gemm_phase``'s tolerances: 1e-4 + 2^-7 relative
    for bf16 out, 1e-4 + 1e-5 for f32 out), timed beside the plain
    version, ``torch.matmul`` and the bound (operations at the bf16 peak, or
    bytes); ``trans_a`` also in f32 (the CUDA-core kernel) and at a ragged
    shape; rows bit-identical across M, ``trans_a`` included.  Returns
    (max abs error, rows)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import block_gemm
    err = 0.0
    for (M, K, N, ta, tb) in ((37, 1000, 777, True, False), (16, 4096, 2048, True, False),
                              (2048, 4096, 2048, True, False), (4096, 2048, 2048, False, True)):
        for dtype in (torch.float32, torch.bfloat16):
            a, b = _gemm_operands(gen, M, K, N, ta, tb, dtype)
            rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            err = max(err, check_close(
                f"block_gemm {str(dtype)[6:]} {M}x{K}x{N} trans_a={ta} trans_b={tb}",
                block_gemm(a, b, trans_a=ta, trans_b=tb),
                ref.block_gemm_ref(a, b, trans_a=ta, trans_b=tb), 1e-4, rtol))
    train_row_invariance(gen)
    row_err, rows = _gemm_case_rows(_train_gemm_cases(), flush, gen)
    err = max(err, row_err)
    log(f"block_gemm at olmo-1b's training shapes (T = {TRAIN_T}): {len(rows)} products agree "
        f"(forward, g @ W^T, A^T @ g), trans_a also in f32 and ragged; max_abs_err {err:.3e}")
    return err, rows


def train_row_invariance(gen):
    """Every output row of the bf16 GEMM is the same f32 sum whatever M is,
    at the training shapes: the first M rows of the T = 4096 forward (K, N)
    products and of the weight-gradient product ``A^T @ g`` (A stored [T,
    M'], its first M columns) equal the product at that M alone, bit for
    bit, f32 and bf16 out."""
    from repro_torch.kernels.block_gemm import block_gemm
    Ms = (1, 16, 17, 64, 100, 2048)
    for K, N, ta in ((2048, 2048, False), (2048, 8192, False), (8192, 2048, False),
                     (TRAIN_T, 2048, True), (TRAIN_T, 8192, True)):
        full_m = TRAIN_T if not ta else 2048
        a, b = _gemm_operands(gen, full_m, K, N, ta, False)
        for out in (torch.float32, torch.bfloat16):
            full = block_gemm(a, b, out_dtype=out, trans_a=ta)
            for M in Ms:
                part_a = a[:, :M].contiguous() if ta else a[:M].contiguous()
                part = block_gemm(part_a, b, out_dtype=out, trans_a=ta)
                if not torch.equal(part, full[:M]):
                    fail(f"block_gemm rows differ between M={M} and M={full_m} at K={K} "
                         f"N={N} trans_a={ta} {out}: {int((part != full[:M]).sum())} entries")
        del a, b, full
    torch.cuda.synchronize()
    log(f"block_gemm: rows bit-identical across M in {Ms} and the full M at the training "
        f"(K, N), trans_a included, f32 and bf16 out")


def _state_to(state, device):
    from repro_torch.core.quant import QTensor
    from repro_torch.core.tree import tree_map
    from repro_torch.training import TrainState

    def mv(t):
        if isinstance(t, QTensor):
            return QTensor(t.q.to(device), t.scale.to(device))
        return t.to(device)
    return TrainState(state.step.to(device), tree_map(mv, state.params),
                      tree_map(mv, state.mu), tree_map(mv, state.nu))


def _forward_gemms(cfg, params, batch):
    """The bf16 / f32 GEMM launches of one training forward (no autograd:
    the same GEMMs, each once)."""
    from repro_torch.kernels.block_gemm import block_gemm
    from repro_torch.models import model as M
    n0 = block_gemm.launches
    with torch.no_grad():
        M.loss_fn(cfg, params, batch)
    torch.cuda.synchronize()
    return block_gemm.launches - n0


def train_reference_check(counters):
    """Reduced olmo-1b and reduced qwen3-moe-30b-a3b (f32, seeded weights
    drawn on the CPU and copied): one train step on the card against the
    same step on the CPU's plain versions.  The loss within 1e-5; every
    gradient leaf finite and within 1e-4 of the CPU's, relative to the
    leaf's max |g|; the new parameters and moments finite.  On the card the
    gradient launches the block GEMM exactly 3 times per GEMM of the
    forward (forward, ``g @ W^T``, ``A^T @ g``) and no attention kernel (the
    plain attention under autograd, by rule).  Then a ``TrainRunner`` run
    on the card with a failure injected at step 3 (checkpoints every 2)
    gives the same loss stream and final state as a straight run."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.runtime import FailureInjector, TrainRunner
    from repro_torch.training import AdamWConfig, init_state, make_train_step
    from repro_torch.training.step import value_and_grad
    out = {}
    for name in (TRAIN, "qwen3-moe-30b-a3b"):
        cfg = reduce_config(get_config(name))
        opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        cpu = init_state(cfg, opt, seed=5, device="cpu")
        gpu = _state_to(cpu, "cuda")
        batch = SyntheticLM(cfg, batch=4, seq=64, seed=2).batch_at(0)
        n_fwd = _forward_gemms(cfg, gpu.params, to_device(batch, "cuda"))
        before = {c.__name__: c.launches for c in counters}
        l_gpu, e_gpu, g_gpu = value_and_grad(cfg, gpu.params, to_device(batch, "cuda"))
        torch.cuda.synchronize()
        moved = {c.__name__: c.launches - before[c.__name__] for c in counters}
        want = {"block_gemm": 3 * n_fwd}
        if moved != {n: want.get(n, 0) for n in moved}:
            fail(f"{name} train step on the card: launches {moved}, want {want} and no "
                 f"other kernel (3 GEMMs per forward GEMM; attention plain)")
        l_cpu, e_cpu, g_cpu = value_and_grad(cfg, cpu.params, to_device(batch, "cpu"))
        gap = abs(float(l_gpu) - float(l_cpu))
        if gap > 1e-5 or abs(float(e_gpu["aux"]) - float(e_cpu["aux"])) > 1e-5:
            fail(f"{name}: card loss {float(l_gpu)} vs CPU {float(l_cpu)}")
        worst = 0.0
        fg, fc = flatten(g_gpu), flatten(g_cpu)
        for k in fc:
            if not np.isfinite(fg[k]).all():
                fail(f"{name}: gradient {k} not finite on the card")
            scale = max(float(np.abs(fc[k]).max()), 1e-30)
            rel = float(np.abs(fg[k] - fc[k]).max()) / scale
            worst = max(worst, rel)
            if rel > 1e-4:
                fail(f"{name}: gradient {k} {rel:.3e} of its max from the CPU's (bound 1e-4)")
        new, m = make_train_step(cfg, opt)(gpu, batch)
        if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(new.params)):
            fail(f"{name}: non-finite parameters after a step on the card")
        out[name] = dict(loss_gap=gap, worst_grad_rel=worst, gemms_per_forward=n_fwd,
                         launches=moved)
        log(f"{name} (reduced) train step card vs CPU: loss {float(l_gpu):.6f} (gap "
            f"{gap:.2e}), aux {float(e_gpu['aux']):.6f}, worst gradient leaf {worst:.2e} of "
            f"its max; block_gemm {moved['block_gemm']} launches = 3 x {n_fwd} forward GEMMs, "
            f"no attention kernel")

    cfg = reduce_config(get_config(TRAIN))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    step = make_train_step(cfg, opt)
    data = SyntheticLM(cfg, batch=4, seq=64)
    state = init_state(cfg, opt, seed=0, device="cuda")
    root = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    try:
        s1, r1 = TrainRunner(step, data.batch_at, CheckpointManager(
            os.path.join(root, "a"), async_save=False), ckpt_every=2).run(state, 6)
        inj = FailureInjector(fail_at={3})
        s2, r2 = TrainRunner(step, data.batch_at, CheckpointManager(
            os.path.join(root, "b")), ckpt_every=2, injector=inj).run(state, 6)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if r2.restarts != 1 or r2.losses[:3] + r2.losses[4:] != r1.losses:
        fail(f"TrainRunner on the card: restarts {r2.restarts}, losses {r2.losses} vs "
             f"{r1.losses}")
    f1, f2 = flatten(s1), flatten(s2)
    if any(not np.array_equal(f1[k], f2[k]) for k in f1):
        fail("TrainRunner on the card: the restarted run ends at another state")
    out["runner"] = dict(losses=r1.losses, restarted_losses=r2.losses)
    log(f"TrainRunner on the card (reduced {TRAIN}, a failure at step 3, checkpoints every "
        f"2, async): the same {len(r1.losses)} losses and final state as a straight run")
    return out


def _attention_ms(cfg, gen):
    """Plain attention's forward + backward at one layer of the train step
    (q, k, v [B, H, S, d] bf16, causal), by CUDA events: the layer's
    attention time, measured alone (times the layers: its share of a
    step)."""
    from repro_torch.kernels.ref import flash_attention_ref
    shape = (TRAIN_B, cfg.num_heads, TRAIN_S, cfg.head_dim)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").bfloat16().requires_grad_()
               for _ in range(3))
    g = torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def run():
        o = flash_attention_ref(q, k, v, causal=True)
        torch.autograd.grad(o, (q, k, v), g)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        run()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / 5


SPANS = ("plain_attention", "adamw_update")  # the port's profiler ranges


def _device_events(events):
    """The device's own activity in a trace (kernels, copies, fills): events
    on the CUDA device, without the CPU ops whose device time repeats that
    of the kernels they launched (the GEMM's ``autograd.Function`` and its
    backward are such ops), without the device-side spans of the port's
    profiler ranges (``SPANS``: first to last kernel inside, gaps included)
    and without CUPTI's "Command Buffer Full" records (the host waiting on
    a full launch queue: no device work)."""
    from torch.autograd import DeviceType
    return [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA
            and _device_us(e) > 0 and not e.key.startswith("Command Buffer")
            and e.key not in SPANS]


def _gemm_kind(key: str):
    """'forward' / 'backward' for a bf16 GEMM kernel's name (its template
    flags AT, BT: forward products take neither -- olmo-1b's head is untied
    --, ``g @ W^T`` takes BT, ``A^T @ g`` AT), else None."""
    import re
    m = re.search(r"gemm_bf16_kernel<\s*\d+,\s*\d+,\s*\d+,\s*\d+,\s*\d+,\s*(\w+),\s*(\w+)", key)
    if not m:
        return None
    return "forward" if m.group(1) == m.group(2) == "false" else "backward"


def _span_labels(events):
    """``label(op)``: the profiler range of ``SPANS`` a CPU op of a traced
    step belongs to.  An op inside a range belongs to it; an op of the
    backward pass (under an ``autograd::engine::evaluate_function`` node)
    belongs to ``"<range> backward"`` of the forward op that carries the
    node's autograd sequence number; any other op to None."""
    def walk(e):  # (the range e lies in, the backward node e runs under)
        while e is not None:
            if e.name in SPANS:
                return e.name, None
            if e.name.startswith("autograd::engine::evaluate_function"):
                return None, e
            e = e.cpu_parent
        return None, None

    made = {}  # (thread, sequence nr) -> (start, range) of the op that made the node
    for e in events:
        if e.sequence_nr < 0 or e.name.startswith("autograd::engine"):
            continue
        span, node = walk(e)
        key = (e.thread, e.sequence_nr)
        if node is None and (key not in made or e.time_range.start >= made[key][0]):
            made[key] = (e.time_range.start, span)

    def label(e):
        span, node = walk(e)
        if node is None:
            return span
        fwd = made.get((node.fwd_thread, node.sequence_nr), (0, None))[1]
        return None if fwd is None else fwd + " backward"
    return label


def _span_split(events):
    """{label: device us of the kernels the ops launched (:func:`_kernel_us`)}
    over a traced step's ops, by :func:`_span_labels`."""
    label = _span_labels(events)
    out: dict = {}
    for e in events:
        d = _kernel_us(e)
        if d:
            out[label(e)] = out.get(label(e), 0.0) + d
    return out


#: CUPTI and runtime records among a trace's CPU events: their correlation
#: ids collide with the ops', so their kernel lists repeat the ops' kernels
RECORDS = ("Command Buffer", "Activity Buffer", "cuda")


def _kernel_us(event) -> float:
    """Device us of the kernels a CPU op launched, the block GEMM's left
    out (the trace's GEMM split reads those by name), and so is a profiler
    range's own device-side span (``SPANS``); 0 for ``RECORDS``."""
    if event.name.startswith(RECORDS):
        return 0.0
    return sum(k.duration for k in getattr(event, "kernels", ())
               if not _gemm_kind(k.name) and k.name not in SPANS)


def _moments_vs_f32(st, ref, kind: str) -> dict:
    """Hold a step's ``kind`` (bf16 or int8) moments against the f32-moment
    step from the same state and batch (``ref``: its mu / nu leaves on the
    host): every new parameter and decoded moment finite, and each decoded
    moment within its encoding's precision of the f32 one -- bf16: 2^-7 of
    |f32| (twice its rounding's worst case), int8: one quantization step
    (``scale``, twice its rounding's); both plus 1e-6 of the leaf's max |f32| for the
    last-bit differences of two backward passes.  Returns the worst
    |err| / bound of mu and of nu."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.training.optimizer import _decode_moment
    for p in tree_leaves(st.params):
        if not torch.isfinite(p).all():
            fail(f"{TRAIN} {kind} moments: a non-finite parameter after one step")
    worst = {}
    for name in ("mu", "nu"):
        moms = tree_leaves(tree_map(lambda p, x: x, st.params, getattr(st, name)))
        w = 0.0
        for i, (x, r) in enumerate(zip(moms, ref[name])):
            d = _decode_moment(x, kind)
            r = r.to(d.device)
            if not torch.isfinite(d).all():
                fail(f"{TRAIN} {kind} moments: non-finite {name} leaf {i}")
            step_ = 2.0 ** -7 * r.abs() if kind == "bf16" else x.scale.expand_as(d)
            bound = step_ + 1e-6 * r.abs().max()
            ratio = float(((d - r).abs() / bound.clamp_min(1e-30)).max())
            if not ratio <= 1.0:
                fail(f"{TRAIN} {kind} moments: {name} leaf {i} {tuple(d.shape)} off the "
                     f"f32-moment step by {ratio:.3f} of its bound")
            w = max(w, ratio)
            del r, d, bound
        worst[name] = w
    return worst


def train_phase(counters, gen):
    """Full-width, full-depth olmo-1b (16 layers, d_model 2048, bf16,
    seed-0 weights from ``model.init`` on the card): 10 steps of
    ``make_train_step`` on ``SyntheticLM`` batches of 8 x 512 tokens, f32
    moments, lr 1e-3 with 2 warm-up steps.  Every loss finite and the last
    below the first; the block GEMM launched 3 times per forward GEMM a
    step and no attention kernel.  Step ms (median of steps 3-10),
    tokens/s, peak device memory; one traced step (device ms of the GEMM's
    forward and backward products by kernel name, of plain attention's
    forward and backward and the AdamW update by the port's profiler
    ranges (:func:`_span_split`), the rest, the idle share), with the
    optimizer update and one layer's plain attention (forward + backward)
    timed alone by CUDA events as a cross-check.  Then one step each with bf16 and
    int8 moments (loss, peak memory), their moments held against the
    f32-moment step's (:func:`_moments_vs_f32`).  No checkpoint at full width: a
    14 GB npz is disk time, not the card's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.training import AdamWConfig, init_state, make_train_step
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.step import value_and_grad
    ref = train_reference_check(counters)
    # remat pinned to none: every activation kept, as this phase measured before
    # the config carried a remat policy
    cfg = get_config(TRAIN).with_(remat_policy="none")
    names = [c.__name__ for c in counters]
    data = SyntheticLM(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=0)
    batches = [data.batch_at(i) for i in range(TRAIN_STEPS)]
    out = {"reference": ref}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS, moments_dtype="f32")
    state = init_state(cfg, opt, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    n_fwd = _forward_gemms(cfg, state.params, to_device(batches[0], "cuda"))
    step = make_train_step(cfg, opt)
    losses, times = [], []
    for c in counters:
        c.launches = 0
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = step(state, b)
        losses.append(float(m["loss"]))  # waits for the step
        times.append(time.time() - t0)
        if i == 0:  # step 1's f32 moments, on the host: what bf16 and int8 are held to
            ref_mom = {k: [t.cpu() for t in tree_leaves(getattr(state, k))]
                       for k in ("mu", "nu")}
    launches = _launched(counters, names, {"block_gemm": 3 * n_fwd * TRAIN_STEPS},
                         f"{TRAIN} train run")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{TRAIN} training: losses {losses} (finite, the last below the first)")
    step_ms = statistics.median(times[2:]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"{TRAIN} training: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters (bf16), f32 moments; {TRAIN_STEPS} steps of "
        f"{TRAIN_B} x {TRAIN_S} tokens: losses " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"{TRAIN} training: step {step_ms:.1f} ms (median of steps 3-{TRAIN_STEPS}; all: "
        + ", ".join(f"{t * 1e3:.1f}" for t in times) + f"), {TRAIN_T / step_ms * 1e3:.0f} "
        f"tokens/s, peak device memory {peak / 2 ** 30:.2f} GiB; block_gemm "
        f"{launches['block_gemm'] // TRAIN_STEPS} launches a step (3 x {n_fwd} forward "
        f"GEMMs), no attention kernel")

    # one traced step, split by kernel name (the GEMM) and by the port's
    # profiler ranges (attention, the optimizer); the optimizer and one
    # layer's attention timed alone as a cross-check
    b = batches[-1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step(state, b)
        torch.cuda.synchronize()
    kernels = _device_events(prof.key_averages())
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3
    by = {"forward": 0.0, "backward": 0.0}
    for e in kernels:
        kind = _gemm_kind(e.key)
        if kind:
            by[kind] += _device_us(e) / 1e3
    spans = {k: v / 1e3 for k, v in _span_split(prof.events()).items()}
    not_gemm = dev_ms - by["forward"] - by["backward"]
    read = sum(spans.values())  # each kernel once: all the device time that is not GEMM
    if dev_ms and abs(read - not_gemm) <= 0.02 * not_gemm:
        attn_f, attn_b = spans.get("plain_attention", 0.0), spans.get("plain_attention backward", 0.0)
        opt_tr = spans.get("adamw_update", 0.0)
    else:
        attn_f = attn_b = opt_tr = None
        log(f"traced step: the ops' launches read {read:.2f} ms of the {not_gemm:.2f} ms that "
            f"is not GEMM: attention and optimizer device ms not measured")
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    loss, extras, grads = value_and_grad(cfg, state.params, to_device(b, "cuda"))
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    upd = adamw_update(opt, state.params, grads, state.mu, state.nu, state.step)
    e.record()
    e.synchronize()
    opt_ms = s.elapsed_time(e)
    del upd, grads, loss
    attn_ms = _attention_ms(cfg, gen)
    trace = dict(device_ms=dev_ms, untraced_step_ms=step_ms,
                 idle_share=(1 - dev_ms / step_ms) if dev_ms else None,
                 gemm_forward_ms=by["forward"], gemm_backward_ms=by["backward"],
                 attention_forward_ms=attn_f, attention_backward_ms=attn_b,
                 optimizer_ms=opt_tr, ranges_read_ms=read,
                 other_ms=None if opt_tr is None else not_gemm - attn_f - attn_b - opt_tr,
                 optimizer_ms_alone=opt_ms, attention_layer_ms_alone=attn_ms,
                 attention_step_ms_alone=attn_ms * cfg.num_layers,
                 top={f"{k.key[:60]} x{k.count}": _device_us(k) / 1e3 for k in top})
    idle = "not measured" if not dev_ms else f"{trace['idle_share']:.3f}"
    ms = {k: "not measured" if trace[k] is None else f"{trace[k]:.2f} ms" for k in
          ("attention_forward_ms", "attention_backward_ms", "optimizer_ms", "other_ms")}
    log(f"traced {TRAIN} train step: device {dev_ms:.2f} ms of an untraced {step_ms:.1f} ms "
        f"step (idle share {idle}); GEMM forward {by['forward']:.2f} ms, GEMM backward "
        f"{by['backward']:.2f} ms, plain attention forward {ms['attention_forward_ms']}, "
        f"backward {ms['attention_backward_ms']}, AdamW update {ms['optimizer_ms']}, the rest "
        f"{ms['other_ms']} (the ops' launches read {read:.2f} ms of the {not_gemm:.2f} ms "
        f"that is not GEMM); cross-check, alone: AdamW update {opt_ms:.2f} ms, plain "
        f"attention fwd + bwd {attn_ms:.3f} ms a layer ({attn_ms * cfg.num_layers:.2f} ms a "
        "step); top kernels (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in trace["top"].items()))
    out["f32"] = dict(losses=losses, step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
                      tokens_per_s=TRAIN_T / step_ms * 1e3, peak_gib=peak / 2 ** 30,
                      gemm_launches_per_step=launches["block_gemm"] // TRAIN_STEPS,
                      gemms_per_forward=n_fwd, launches=launches, trace=trace,
                      params_b=n_params / 1e9)
    del state, m
    for moments in ("bf16", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt_m = opt._replace(moments_dtype=moments)
        st = init_state(cfg, opt_m, seed=0, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        st, m = make_train_step(cfg, opt_m)(st, batches[0])
        loss = float(m["loss"])
        dt = time.time() - t0
        pk = torch.cuda.max_memory_allocated() / 2 ** 30
        if not math.isfinite(loss) or abs(loss - losses[0]) > 1e-3 * abs(losses[0]):
            fail(f"{TRAIN} {moments} moments: step-1 loss {loss} vs {losses[0]} (f32 moments)")
        worst = _moments_vs_f32(st, ref_mom, moments)
        out[moments] = dict(loss=loss, peak_gib=pk, step_ms=dt * 1e3,
                            moment_err_of_bound=worst)
        log(f"{TRAIN} training, {moments} moments: step-1 loss {loss:.4f}, step {dt * 1e3:.1f} ms "
            f"(the first: allocator warm-up), peak device memory {pk:.2f} GiB; every new leaf "
            f"finite, decoded mu / nu within {worst['mu']:.3f} / {worst['nu']:.3f} of their "
            f"bound from the f32-moment step")
        del st, m
    return out, launches


# ---------------------------------------------------------------------------
# phase 4b: the serving driver (launch/serve.py) with sampled decode
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--no-reduced", "--requests", "16", "--max-new", "32", "--max-len", "512",
              "--batch", "8"]
SERVE_PATH = ("block_gemm", "flash_attention_paged", "flash_decode_paged")
SERVE_W8A8_PATH = ("block_gemm_int8", "quantize_rows", "flash_attention_paged",
                   "flash_decode_paged")


def _serve_run(serve, cfg, params, argv, counters, what, path):
    """``launch.serve.run`` in-process with every counter at 0: every
    request ``ok`` with ``--max-new`` in-vocabulary tokens, the pool
    reconciled after ``close()``, each kernel of ``path`` launched and no
    other wrapper's.  Prints the serving driver's summary lines.  Returns
    (results by rid, stats, engine, launches, wall s)."""
    from repro_torch.serving import check_invariants
    args = serve.parser().parse_args(argv)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    results, stats, eng = serve.run(cfg, params, args)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {c.__name__: c.launches for c in counters}
    for line in serve.summary_lines(cfg, eng, results, args):
        log(line)
    for r in results:
        if not r.ok or len(r.generated) != args.max_new \
                or not all(0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"{what} rid {r.rid}: {r.finish_reason} with {len(r.generated)} tokens")
    if len(results) != args.requests:
        fail(f"{what}: {len(results)} results for {args.requests} requests")
    bad = check_invariants(eng.pool, eng.radix, tables=eng.sched.owned)
    if bad or eng.pool.num_free != eng.pool.n_pages - 1:
        fail(f"{what} paging state after close(): " + "; ".join(bad))
    for n, v in launches.items():
        if (v > 0) != (n in path):
            fail(f"{what}: launches {launches}; the path is {path}")
    return {r.rid: r for r in results}, stats, eng, launches, wall


def _serve_summary(serve, results, stats, eng, wall, launches):
    p50, p99 = serve.latency_percentiles(list(results.values()))
    ttft = sorted(r.ttft_s for r in results.values())
    graph = eng.runner.graph
    return dict(tokens_per_s=stats.tokens_per_s, tokens_per_s_end_to_end=stats.tokens_out / wall,
                wall_s=wall, p50_s=p50, p99_s=p99, ttft_p50_ms=statistics.median(ttft) * 1e3,
                decode_tick_ms=stats.decode_s / max(stats.chunks, 1) * 1e3,
                decode_ticks=stats.chunks, mixed_ticks=stats.mixed_steps,
                capture_ms=graph.capture_s * 1e3, preempted=stats.preempted,
                launches=launches)


def serve_phase(counters):
    """The port's serving driver on the card (``repro_torch.launch.serve``,
    ``run()`` in-process), full-width olmo-1b with seed-0 weights, all runs
    at ``--max-len 512 --batch 8``:

    (a) ``--no-reduced --requests 16 --max-new 32 --rate 8`` at the default
        ``--temperature 0.7``: Poisson arrivals, whole-suffix prefill (the
        suffix as one chunk of a power-of-two buffer, so paged chunk
        attention), the bf16 GEMM, paged decode;
    (b) the same with ``--chunk-tokens 64``;
    (c) (b) with ``--quant w8a8`` (the int8 GEMM and the row quantize);
    (d) reduced olmo-1b (f32) with ``--preemption recompute --pages 9`` at
        temperature 0.7, against the same run with the default pool, which
        never preempts.

    Gates: every request of (a)-(c) ``ok`` with 32 in-vocabulary tokens,
    the pool reconciled after ``close()``, each run's path kernels launched
    and no other wrapper; sampled tokens seeded on the card: at ``--rate 0``
    each request's tokens in the closed batch of 16 equal its tokens served
    alone with the same seed, and in (d) every request's tokens (the
    preempted ones included; at least one preemption) equal those of the
    run that never preempts.  The decode tick's wall ms at temperature 0.7
    against greedy comes from two closed batches at ``--rate 0``."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig
    cfg = get_config("olmo-1b")
    params = M.init(cfg, seed=0, device="cuda")
    out = {}
    runs = {"a": SERVE_ARGS + ["--rate", "8"],
            "b": SERVE_ARGS + ["--rate", "8", "--chunk-tokens", "64"],
            "c": SERVE_ARGS + ["--rate", "8", "--chunk-tokens", "64", "--quant", "w8a8"]}
    for key, argv in runs.items():
        path = SERVE_W8A8_PATH if key == "c" else SERVE_PATH
        res, st, eng, launches, wall = _serve_run(serve, cfg, params, argv, counters,
                                                  f"serve ({key})", path)
        out[key] = _serve_summary(serve, res, st, eng, wall, launches)
        del eng
    # the closed batch at temperature 0.7 and greedy: the decode tick's cost
    # of sampling, and each sampled request alone == in the batch
    closed = {}
    for temp in ("0.7", "0"):
        res, st, eng, launches, wall = _serve_run(
            serve, cfg, params, SERVE_ARGS + ["--rate", "0", "--temperature", temp],
            counters, f"serve closed batch, temperature {temp}", SERVE_PATH)
        closed[temp] = (res, _serve_summary(serve, res, st, eng, wall, launches))
        del eng
    prompts = serve.make_prompts(16, cfg.vocab_size)
    econf = EngineConfig(max_len=512, max_batch=8)
    for i, p in enumerate(prompts):
        solo = Engine(cfg, params, econf)
        solo.submit(p, 32, 0.7, seed=i)
        got = solo.run()[0].generated
        if got != closed["0.7"][0][i].generated:
            fail(f"serve: request {i} sampled alone differs from the closed batch at "
                 f"temperature 0.7")
        del solo
    sampled, greedy = closed["0.7"][1], closed["0"][1]
    log(f"serve: 16 sampled requests alone == in the closed batch (temperature 0.7, seeds "
        f"0-15); decode tick {sampled['decode_tick_ms']:.2f} ms at temperature 0.7 vs "
        f"{greedy['decode_tick_ms']:.2f} ms greedy ({sampled['decode_ticks']} / "
        f"{greedy['decode_ticks']} decode ticks x8 steps)")
    del params
    gc.collect()
    # (d) preemption with recompute on reduced olmo-1b, f32
    rcfg = reduce_config(cfg)
    rparams = M.init(rcfg, seed=0, device="cuda")
    small = ["--requests", "16", "--max-new", "32", "--max-len", "512", "--batch", "8",
             "--rate", "0"]
    pre, st, eng, launches, wall = _serve_run(
        serve, rcfg, rparams, small + ["--preemption", "recompute", "--pages", "9"],
        counters, "serve (d) preempting", SERVE_PATH)
    if st.preempted < 1:
        fail(f"serve (d): no preemption with a pool of {eng.pool.n_pages} pages")
    out["d"] = _serve_summary(serve, pre, st, eng, wall, launches)
    ref, _, _, _, _ = _serve_run(serve, rcfg, rparams, small, counters,
                                 "serve (d) without preemption", SERVE_PATH)
    diff = [rid for rid in ref if pre[rid].generated != ref[rid].generated]
    if diff:
        fail(f"serve (d): requests {diff} sampled other tokens under preemption")
    log(f"serve (d): {st.preempted} preemptions (recompute), every request's sampled tokens "
        f"equal to the run that never preempts")
    out.update(closed_sampled=sampled, closed_greedy=greedy,
               sampling_tick_ms=sampled["decode_tick_ms"] - greedy["decode_tick_ms"])
    return out


# ---------------------------------------------------------------------------
# the mesh phase: mesh-sharded serving, two gloo ranks sharing the one card
# ---------------------------------------------------------------------------

MESH_WORK = os.path.join(HERE, "build", "mesh_phase")  # git-ignored
MESH_CONF = dict(max_batch=8, max_len=1024, page_size=64, chunk_tokens=64, decode_chunk=8)
MESH_MAX_NEW = 32
MOE_MESH_LAYERS = 8  # of qwen3-moe-30b-a3b's 48: two ranks and the single rank in one budget
MOE_MESH_MAX_NEW = 16
MESH_LOGITS_BOUND = 1e-2  # the mesh's logits against the single rank's at a flip
MESH_DTYPES = (("a", torch.bfloat16), ("a32", torch.float32))
MOE_F32_BOUND = 1e-4  # expert-parallel prefill logits in f32 (the CPU tests' bound vs JAX)
# (h): (b)'s model over three ranks, where its 128 experts do not divide and
# each expert's FFN (768 = 3 x 256) does: the FFN cut over the model axis
MOE_FFN_MESH = "1x3"
RING_T, RING_D, RING_F = 512, 2048, 8192  # olmo-1b's FFN at 512 tokens
MESH_PATH = ("block_gemm", "flash_attention_paged", "flash_decode_paged")
# (e): the w8a8 path's kernels; the row-parallel entries launch for wo and
# w_down (2 a layer a forward), the fused int8 GEMM for the column splits
# and the head
MESH_W8A8_PATH = ("block_gemm_int8", "quantize_rows", "block_gemm_int8_acc", "int8_epilogue",
                  "row_amax", "quantize_rows_given", "flash_attention_paged",
                  "flash_decode_paged")
# (f): mamba2-130m's runs (key, mesh, dtype, quant) and its engine
MESH_SSD_RUNS = (("f", "1x2", torch.bfloat16, None), ("f32", "1x2", torch.float32, None),
                 ("f21", "2x1", torch.bfloat16, None), ("f21_32", "2x1", torch.float32, None),
                 ("fq", "1x2", torch.bfloat16, "w8a8"))
MESH_SSD_CONF = dict(max_batch=8, max_len=1024, page_size=64, decode_chunk=8)
MESH_SSD_MAX_NEW = 32
MESH_SSD_W8A8_NEW = 16  # the short w8a8 pass: 4 requests
MESH_SSD_PATH = ("block_gemm",)  # the head and each layer's w_out (SSD's einsums are plain)
# (g): reduced jamba (f32, 8 layers, 4 experts) at 1x2
MESH_JAMBA_CONF = dict(max_batch=4, max_len=256, page_size=16, decode_chunk=4)
MESH_JAMBA_LENGTHS = (37, 64, 101, 20)
MESH_JAMBA_NEW = 16
MESH_JAMBA_PATH = ("block_gemm", "flash_attention", "flash_decode_paged")


def _mesh_prompts(V, lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, n).tolist() for n in lengths]


MESH_LENGTHS = (100, 333, 480, 205, 120, 500, 260, 415)
MOE_MESH_LENGTHS = (100, 280, 190, 333)


def _serve_ticks(eng, prompts, max_new, mesh=None):
    """Submit ``prompts`` (greedy) and step the engine to the end, timing each
    tick on the host clock (a tick ends in its one device-to-host read) and
    counting the mesh's collectives in it.  Returns (results by rid, ticks:
    [(kind, ms, collectives)])."""
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, 0.0, seed=i)
    results, ticks = [], []
    while eng.num_queued or eng.num_active:
        c0 = mesh.collectives if mesh is not None else 0
        m0, t0 = eng.stats.mixed_steps, time.time()
        results.extend(eng.step())
        ticks.append(("mixed" if eng.stats.mixed_steps > m0 else "decode",
                      (time.time() - t0) * 1e3,
                      (mesh.collectives - c0) if mesh is not None else 0))
    return {r.rid: r for r in results}, ticks


def _tick_summary(ticks):
    dec = [t for t in ticks if t[0] == "decode"]
    mix = [t for t in ticks if t[0] == "mixed"]
    return dict(decode_ticks=len(dec), mixed_ticks=len(mix),
                decode_tick_ms=statistics.median(t[1] for t in dec) if dec else None,
                mixed_tick_ms=statistics.median(t[1] for t in mix) if mix else None,
                collectives_per_decode_tick=max((t[2] for t in dec), default=0),
                collectives_median_decode_tick=(statistics.median(t[2] for t in dec)
                                                if dec else 0),
                collectives_per_mixed_tick=max((t[2] for t in mix), default=0))


class _ShapeRecorder:
    """Records the distinct shapes the kernel entry points are called with
    on the card (every call is eager under gloo): the block GEMM's (A, B),
    the row-parallel int8 GEMM's int32 partial (A, B), paged chunk
    attention's (q, pool) and paged decode's (q, pool)."""

    def __init__(self):
        from repro_torch.core import gemm
        from repro_torch.models import layers
        self.gemm, self.layers, self.seen = gemm, layers, {}

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if args[0].is_cuda:
                key = " x ".join(str(list(a.shape)) for a in args[:2])
                self.seen.setdefault(name, set()).add(key)
            return fn(*args, **kw)
        return call

    def __enter__(self):
        self._orig = (self.gemm.cgra_matmul, self.layers.attention, self.layers.attend_decode,
                      self.gemm.block_gemm_int8_acc)
        self.gemm.cgra_matmul = self._wrap("block_gemm", self._orig[0])
        self.layers.attention = self._wrap("flash_attention_paged", self._orig[1])
        self.layers.attend_decode = self._wrap("flash_decode_paged", self._orig[2])
        self.gemm.block_gemm_int8_acc = self._wrap("block_gemm_int8_acc", self._orig[3])
        return self

    def __exit__(self, *exc):
        (self.gemm.cgra_matmul, self.layers.attention, self.layers.attend_decode,
         self.gemm.block_gemm_int8_acc) = self._orig

    def report(self):
        return {k: sorted(v) for k, v in self.seen.items()}


def _witness_rows(eng, results, single, prompts):
    """For each request whose tokens leave the single rank's, the step where
    they first differ: (rid, step, single token, mesh token) and this
    mesh's f32 logits row there, from ``model.prefill`` of the prompt and
    the single rank's tokens before that step."""
    from repro_torch.models import model as M
    rows, logits = [], []
    for rid, r in results.items():
        want = single[str(rid)]
        if r.generated == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(want, r.generated)) if a != b)
        toks = torch.tensor([prompts[rid] + want[:j]], dtype=torch.int32, device="cuda")
        with eng.runner.on_mesh():
            lg = M.prefill(eng.cfg, eng.runner.params, toks)[0][0, -1, : eng.cfg.vocab_size]
        rows.append(dict(rid=rid, step=j, single=want[j], mesh=r.generated[j]))
        logits.append(lg.float().cpu())
    return rows, logits


def _mesh_rank(rank, work):
    """One rank of the mesh phase (two ranks on the one card over gloo):
    (a) full olmo-1b served at 1x2, (e) the same in w8a8, (f) full
    mamba2-130m at 1x2 and 2x1 (bf16, f32, a w8a8 pass), (g) reduced jamba
    at 1x2, (b) 8 layers of qwen3-moe-30b-a3b served expert-parallel at 1x2
    and one prefill's logits, (c) the four ring schedules at olmo-1b's FFN
    shapes.  Writes ``rank<r>.json`` (and the logits rows as ``.pt``) into
    ``work``."""
    import gc as _gc
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import torus
    from repro_torch.kernels import _build
    from repro_torch.launch.sharding import activation_mesh
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, MeshSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # the main process built them: loaded from build/
    plan = json.load(open(os.path.join(work, "plan.json")))
    mesh = MeshSpec(1, 2).build()
    out = dict(rank=rank, backend=mesh.backend, device=str(torch.cuda.current_device()))

    # (a) full olmo-1b at 1x2, in bf16 and in f32
    for key, dtype in MESH_DTYPES:
        cfg = get_config("olmo-1b").with_(compute_dtype=dtype)
        params = M.init(cfg, seed=0, device="cuda")
        eng = Engine(cfg, params, EngineConfig(mesh="1x2", **MESH_CONF))
        del params
        _gc.collect()
        torch.cuda.empty_cache()
        out[f"{key}_local_shapes"] = dict(
            wq=list(eng.params["stages"][0]["0"]["mixer"]["wq"].shape),
            w_gate=list(eng.params["stages"][0]["0"]["ffn"]["w_gate"].shape),
            lm_head=list(eng.params["lm_head"].shape), embed=list(eng.params["embed"].shape),
            k_pool=list(eng.runner.caches[0]["0"]["k"].shape))
        out[key] = _mesh_serve(eng, plan["a_prompts"], plan[f"{key}_single"], MESH_MAX_NEW,
                               work, key, rank, record=True)
        del eng
        _gc.collect()
        torch.cuda.empty_cache()

    # (e) full olmo-1b w8a8 at 1x2: wo and w_down row-parallel on the int8
    # entries (the whole row's max, the int32 partial, the exact sum, the
    # epilogue), the column-split projections and the head on the fused one
    cfg = get_config("olmo-1b")
    eng = Engine(cfg, M.init(cfg, seed=0, device="cuda"),
                 EngineConfig(mesh="1x2", quant="w8a8", **MESH_CONF))
    _gc.collect()
    torch.cuda.empty_cache()
    lay = eng.params["stages"][0]["0"]
    out["e_local_shapes"] = dict(
        wq=list(lay["mixer"]["wq"].q.shape), wo=list(lay["mixer"]["wo"].q.shape),
        wo_scale=list(lay["mixer"]["wo"].scale.shape), w_down=list(lay["ffn"]["w_down"].q.shape),
        lm_head=list(eng.params["lm_head"].q.shape))
    out["e"] = _mesh_serve(eng, plan["a_prompts"], plan["e_single"], MESH_MAX_NEW, work, "e",
                           rank, record=True)
    del eng, lay
    _gc.collect()
    torch.cuda.empty_cache()

    # (f) full mamba2-130m, head-parallel (12 of 24 SSD heads a rank) at 1x2
    # and the state's slots over the data group at 2x1, bf16 and f32; then a
    # short w8a8 pass at 1x2
    for key, shape, dtype, quant in MESH_SSD_RUNS:
        cfg = get_config("mamba2-130m").with_(compute_dtype=dtype)
        eng = Engine(cfg, M.init(cfg, seed=0, device="cuda"),
                     EngineConfig(mesh=shape, quant=quant, **MESH_SSD_CONF))
        n = MESH_SSD_MAX_NEW if quant is None else MESH_SSD_W8A8_NEW
        prompts = plan["f_prompts"][: len(plan[f"{key}_single"])]
        out[key] = _mesh_serve(eng, prompts, plan[f"{key}_single"], n, work, key, rank)
        out[key]["h"] = list(eng.runner.caches[0]["0"]["h"].shape)
        del eng
        _gc.collect()
        torch.cuda.empty_cache()

    # (g) reduced jamba at 1x2 in f32: SSD, attention and expert-parallel MoE
    cfg = reduce_config(get_config("jamba-v0.1-52b"))
    eng = Engine(cfg, M.init(cfg, seed=0, device="cuda"),
                 EngineConfig(mesh="1x2", **MESH_JAMBA_CONF))
    out["g"] = _mesh_serve(eng, plan["g_prompts"], plan["g_single"], MESH_JAMBA_NEW, work, "g",
                           rank)
    out["g"].update(shard_map=eng.cfg.moe_shard_map,
                    h=list(next(g for g in eng.runner.caches[0].values() if "h" in g)["h"].shape),
                    experts_held=int(next(g for g in eng.params["stages"][0].values()
                                          if "router" in g.get("ffn", {}))["ffn"]["w_gate"]
                                     .shape[1]))
    del eng
    _gc.collect()
    torch.cuda.empty_cache()

    # (b) qwen3-moe-30b-a3b over 8 of its 48 layers, expert-parallel at 1x2:
    # first one f32 prefill (the same draws, kept f32), then the bf16 engine
    mcfg = get_config("qwen3-moe-30b-a3b").with_(num_layers=MOE_MESH_LAYERS)
    toks = torch.tensor([plan["b_prompts"][1]], dtype=torch.int32, device="cuda")
    cfg32 = mcfg.with_(compute_dtype=torch.float32, moe_shard_map=True)
    for r in range(2):  # one rank at a time holds the whole f32 tree (22 GB)
        if r == rank:
            sp = M.shard_params(cfg32, M.init(cfg32, seed=0, device="cuda"), mesh)
            _gc.collect()
            torch.cuda.empty_cache()
        mesh.broadcast(torch.zeros(1), None)
    with activation_mesh(mesh):
        lg = M.prefill(cfg32, sp, toks)[0][0, -1, : mcfg.vocab_size]
    torch.save(lg.float().cpu(), os.path.join(work, f"b32_prefill_r{rank}.pt"))
    del sp, lg
    _gc.collect()
    torch.cuda.empty_cache()
    params = M.init(mcfg, seed=0, device="cuda")
    eng = Engine(mcfg, params, EngineConfig(mesh="1x2", **MESH_CONF))
    del params
    _gc.collect()
    torch.cuda.empty_cache()
    with eng.runner.on_mesh():
        lg = M.prefill(eng.cfg, eng.runner.params, toks)[0][0, -1, : mcfg.vocab_size]
    torch.save(lg.float().cpu(), os.path.join(work, f"b_prefill_r{rank}.pt"))
    out["b"] = _mesh_serve(eng, plan["b_prompts"], plan["b_single"], MOE_MESH_MAX_NEW, work,
                           "b", rank)
    out["b"].update(shard_map=eng.cfg.moe_shard_map,
                    experts_held=int(eng.params["stages"][0]["0"]["ffn"]["w_gate"].shape[1]))
    del eng
    _gc.collect()
    torch.cuda.empty_cache()

    # (c) the ring schedules at olmo-1b's FFN shapes, f32 and bf16
    out["c"] = {}
    i, tp = mesh.index("model"), 2
    Tl, Fl = RING_T // tp, RING_F // tp
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn(RING_T, RING_D, generator=g, device="cuda").to(dtype)
        wg, wu = (torch.randn(RING_D, RING_F, generator=g, device="cuda").mul_(
            RING_D ** -0.5).to(dtype) for _ in range(2))
        wd = torch.randn(RING_F, RING_D, generator=g, device="cuda").mul_(
            RING_F ** -0.5).to(dtype)
        vs = torch.randn(tp, RING_T * RING_D, generator=g, device="cuda").to(dtype)
        cols = slice(i * Fl, (i + 1) * Fl)
        h = torch.nn.functional.silu(x.float() @ wg.float()).to(dtype)
        calls = {
            "ring_allgather_matmul": (
                lambda: torus.ring_allgather_matmul(x[i * Tl:(i + 1) * Tl], wg[:, cols], mesh),
                lambda: x.float() @ wg[:, cols].float()),
            "matmul_reducescatter_ring": (
                lambda: torus.matmul_reducescatter_ring(h[:, cols].contiguous(),
                                                        wd[cols].contiguous(), mesh),
                lambda: (h.float() @ wd.float())[i * Tl:(i + 1) * Tl]),
            "ring_allreduce": (lambda: torus.ring_allreduce(vs[i], mesh),
                               lambda: vs.float().sum(0)),
            # the dense FFN rounds g, u and silu(g) * u to the dtype, as the
            # schedule's GEMMs store them
            "torus_ffn": (
                lambda: torus.torus_ffn(x[None], wg[:, cols].contiguous(),
                                        wu[:, cols].contiguous(), wd[cols].contiguous(),
                                        mesh)[0],
                lambda: (_swiglu_hidden(x, wg, wu).float() @ wd.float())[i * Tl:(i + 1) * Tl]),
        }
        row = {}
        for name, (ring, dense) in calls.items():
            got = ring()
            want = dense()
            err = float((got.float() - want).abs().max() / want.abs().max())
            times = []
            for _ in range(5):
                mesh.broadcast(torch.zeros(1), None)  # both ranks start together
                torch.cuda.synchronize()
                t0 = time.time()
                ring()
                torch.cuda.synchronize()
                times.append((time.time() - t0) * 1e3)
            row[name] = dict(rel_err=err, ms=statistics.median(times))
        out["c"][str(dtype).split(".")[-1]] = row
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _mesh_ffn_rank(rank, work):
    """One rank of mesh (h) (three ranks on the one card over gloo): (b)'s 8
    layers of qwen3-moe-30b-a3b at ``MOE_FFN_MESH``, every rank holding all
    128 experts and 256 of each expert's 768 FFN columns: one f32 prefill's
    logits (one rank at a time draws the whole f32 tree), then the bf16
    engine on (b)'s prompts.  Writes ``h_rank<r>.json`` (and the logits rows
    as ``.pt``) into ``work``."""
    import gc as _gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.sharding import activation_mesh
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, MeshSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # the main process built them: loaded from build/
    plan = json.load(open(os.path.join(work, "plan.json")))
    spec = MeshSpec.parse(MOE_FFN_MESH)
    mesh = spec.build()
    mcfg = get_config("qwen3-moe-30b-a3b").with_(num_layers=MOE_MESH_LAYERS)
    toks = torch.tensor([plan["b_prompts"][1]], dtype=torch.int32, device="cuda")
    cfg32 = mcfg.with_(compute_dtype=torch.float32)
    for r in range(spec.size):  # one rank at a time holds the whole f32 tree (22 GB)
        if r == rank:
            sp = M.shard_params(cfg32, M.init(cfg32, seed=0, device="cuda"), mesh)
            _gc.collect()
            torch.cuda.empty_cache()
        mesh.broadcast(torch.zeros(1), None)
    with activation_mesh(mesh):
        lg = M.prefill(cfg32, sp, toks)[0][0, -1, : mcfg.vocab_size]
    torch.save(lg.float().cpu(), os.path.join(work, f"h32_prefill_r{rank}.pt"))
    del sp, lg
    _gc.collect()
    torch.cuda.empty_cache()
    params = M.init(mcfg, seed=0, device="cuda")
    eng = Engine(mcfg, params, EngineConfig(mesh=spec, **MESH_CONF))
    del params
    _gc.collect()
    torch.cuda.empty_cache()
    with eng.runner.on_mesh():
        lg = M.prefill(eng.cfg, eng.runner.params, toks)[0][0, -1, : mcfg.vocab_size]
    torch.save(lg.float().cpu(), os.path.join(work, f"h_prefill_r{rank}.pt"))
    out = dict(rank=rank, h=_mesh_serve(eng, plan["b_prompts"], plan["b_single"],
                                        MOE_MESH_MAX_NEW, work, "h", rank))
    out["h"].update(shard_map=eng.cfg.moe_shard_map,
                    w_gate=list(eng.params["stages"][0]["0"]["ffn"]["w_gate"].shape),
                    w_down=list(eng.params["stages"][0]["0"]["ffn"]["w_down"].shape))
    with open(os.path.join(work, f"h_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _mesh_serve(eng, prompts, single, max_new, work, key, rank, record=False):
    """A rank's run of ``eng`` over ``prompts`` (greedy, ``max_new``) with
    every launch counter at 0 just before and read just after: the tokens,
    ok / agree, the launches, the kernel shapes (``record``), the tick
    summary and peak memory, and the witness rows of each request whose
    tokens leave ``single`` (their logits rows saved as
    ``<key>_logits_r<rank>.pt``)."""
    from repro_torch.kernels.ops import LAUNCH_COUNTERS
    for c in LAUNCH_COUNTERS:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rec = _ShapeRecorder() if record else contextlib.nullcontext()
    with rec:
        res, ticks = _serve_ticks(eng, prompts, max_new, eng.mesh)
    got = dict(tokens={str(k): r.generated for k, r in res.items()},
               ok=all(r.ok for r in res.values()), agree=eng.ranks_agree(res.values()),
               graphed=eng.runner.graph.graphed,
               launches={c.__name__: c.launches for c in LAUNCH_COUNTERS},
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, **_tick_summary(ticks))
    if record:
        got["shapes"] = rec.report()
    got["witness"], lg = _witness_rows(eng, res, single, prompts)
    torch.save(lg, os.path.join(work, f"{key}_logits_r{rank}.pt"))
    return got


def _swiglu_hidden(x, wg, wu):
    """silu(x wg) * (x wu) with each product stored in x's dtype."""
    g = (x.float() @ wg.float()).to(x.dtype)
    u = (x.float() @ wu.float()).to(x.dtype)
    return torch.nn.functional.silu(g) * u


def mesh_flip_witness(single, mesh, a: int, b: int, bound) -> dict:
    """The flip rule for a token the mesh picks other than the single rank
    (``a`` the single rank's token, ``b`` the mesh's) at the first step
    they differ.  Both logits rows at that step come from ``model.prefill``
    of the same tokens, on the one rank and on the mesh.  The flip is the
    sharded sum's rounding, not a wrong token, when ``a`` and ``b`` are a
    near-tie that the rows' difference can reorder: ``|l[a] - l[b]|`` in
    the single rank's row at most twice the largest entry of ``|mesh -
    single|``; and that difference is within ``bound`` (None: printed, not
    gated)."""
    gap = float((mesh - single).abs().max())
    tie = float(single[a] - single[b])
    return dict(logits_gap=gap, pair_gap=tie, bound=bound,
                held=abs(tie) <= 2 * gap and (bound is None or gap <= bound))


def _single_rank_logits(cfg, params, prompt, toks):
    from repro_torch.models import model as M
    t = torch.tensor([prompt + toks], dtype=torch.int32, device="cuda")
    return M.prefill(cfg, params, t)[0][0, -1, : cfg.vocab_size].float().cpu()


def _mesh_gate(name, single, ranks, key, cfg, prompts, bound, problems, quant=None):
    """Tokens equal to the single rank's, or every first difference held by
    :func:`mesh_flip_witness`; every rank the same tokens, every request
    ok.  A gate that fails is added to ``problems``.  ``quant``: the
    single rank's weights for a witness are quantized so (w8a8)."""
    a0 = ranks[0][key]
    if any(r[key]["tokens"] != a0["tokens"] or not r[key]["agree"] for r in ranks):
        problems.append(f"{name}: the ranks emitted different tokens")
    if not all(r[key]["ok"] for r in ranks):
        problems.append(f"{name}: a request did not finish ok")
    mesh_rows = torch.load(os.path.join(MESH_WORK, f"{key}_logits_r0.pt"))
    witnesses = []
    params = None
    if a0["witness"]:  # the seed-0 weights again, drawn after the ranks are done
        from repro_torch.models import model as M
        params = M.init(cfg, seed=0, device="cuda")
        if quant == "w8a8":
            params = M.quantize_params(cfg, params)
    for w, row in zip(a0["witness"], mesh_rows):
        s = _single_rank_logits(cfg, params, prompts[w["rid"]],
                                single[str(w["rid"])][: w["step"]])
        wit = dict(w, **mesh_flip_witness(s, row, w["single"], w["mesh"], bound))
        witnesses.append(wit)
        if not wit["held"]:
            problems.append(f"{name}: request {w['rid']} leaves the single rank at step "
                            f"{w['step']} without the flip witness: {wit}")
    same = sum(a0["tokens"][k] == single[k] for k in single)
    log(f"{name}: {same} of {len(single)} requests' tokens equal to the single rank's; "
        f"{len(witnesses)} first differences: {json.dumps(witnesses)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return witnesses


def _mesh_ffn_gates(ranks, mcfg, single32, single16, single, single_ticks, prompts,
                    problems) -> dict:
    """The gates of mesh (h) on what its three ranks wrote: no expert-
    parallel split, every rank holding all experts and a third of each
    expert's FFN; the f32 prefill logits within ``MOE_F32_BOUND`` of the
    single rank's (``single32``) and the same on every rank (the bf16 gap to
    ``single16`` printed); greedy tokens under :func:`_mesh_gate`'s rule,
    the same on every rank; ``MESH_PATH``'s kernels launched on every rank."""
    n = len(ranks)
    E, D, Fdim = mcfg.num_experts, mcfg.d_model, mcfg.moe_d_ff
    h0 = ranks[0]["h"]
    if h0["shard_map"] or h0["w_gate"][1:] != [E, D, Fdim // n] \
            or h0["w_down"][1:] != [E, Fdim // n, D]:
        problems.append(f"mesh (h): not the FFN cut: shard_map {h0['shard_map']}, w_gate "
                        f"{h0['w_gate']}, w_down {h0['w_down']}")
    gaps = {}
    for key, want in (("h32", single32), ("h", single16)):
        lg = [torch.load(os.path.join(MESH_WORK, f"{key}_prefill_r{r}.pt")) for r in range(n)]
        gaps[key] = float((lg[0] - want).abs().max())
        if not all(torch.equal(lg[0], x) for x in lg[1:]):
            problems.append(f"mesh (h) {key}: the ranks' prefill logits differ")
    if not math.isfinite(gaps["h32"]) or gaps["h32"] > MOE_F32_BOUND:
        problems.append(f"mesh (h): f32 prefill logits {gaps['h32']:.3e} from the single "
                        f"rank's (bound {MOE_F32_BOUND})")
    log(f"mesh (h) qwen3-moe {MOE_MESH_LAYERS} of 48 layers at {MOE_FFN_MESH}, all {E} experts "
        f"and {Fdim // n} of each expert's {Fdim} FFN columns a rank, prefill logits from the "
        f"single rank's: f32 {gaps['h32']:.3e} (gate {MOE_F32_BOUND}), bf16 {gaps['h']:.3e} "
        f"(beside {MESH_LOGITS_BOUND}, not gated)")
    witnesses = _mesh_gate(f"mesh (h) qwen3-moe {MOE_FFN_MESH} bf16", single, ranks, "h", mcfg,
                           prompts, None, problems)
    for r in ranks:
        a = r["h"]
        missing = [k for k in MESH_PATH if a["launches"][k] <= 0]
        if missing:
            problems.append(f"mesh (h) rank {r['rank']}: {missing} never launched")
        log(f"mesh (h) rank {r['rank']}: launches "
            f"{json.dumps({k: v for k, v in a['launches'].items() if v})}; peak "
            f"{a['peak_gib']:.2f} GiB; collectives a decode tick "
            f"{a['collectives_per_decode_tick']}, a mixed tick {a['collectives_per_mixed_tick']}")
    log(f"mesh (h): decode tick {h0['decode_tick_ms']:.2f} ms ({n} ranks, eager, gloo) vs "
        f"{single_ticks['decode_tick_ms']:.2f} ms single rank (graphed); mixed tick "
        f"{h0['mixed_tick_ms']:.2f} vs {single_ticks['mixed_tick_ms']:.2f} ms")
    return dict(prefill_logits_gap=gaps, witnesses=witnesses,
                ranks=[r["h"] | {"tokens": None} for r in ranks])


def _mesh_gates_efg(ranks, singles, a_prompts, f_prompts, g_prompts, problems):
    """The gates of (e)-(g) on what the ranks wrote: tokens (``_mesh_gate``:
    equal to the single rank's or witnessed flips; both ranks the same),
    each path's kernels launched on every rank and no other, (e)'s
    row-parallel entries exactly 2 a layer a forward at the shard's shapes
    (K 1024 and 4096, N 2048), (f)'s state holding the rank's heads or
    slots.  Returns {key: summary}, with the witnesses under
    ``"witnesses"``."""
    from repro_torch.configs import get_config, reduce_config
    out, witnesses = {}, {}
    olmo = get_config("olmo-1b")
    witnesses["e"] = _mesh_gate("mesh (e) olmo-1b 1x2 w8a8", singles["e"][0], ranks, "e", olmo,
                                a_prompts, None, problems, quant="w8a8")
    for r in ranks:
        e, name = r["e"], f"mesh (e) rank {r['rank']}"
        ln = e["launches"]
        missing = [n for n in MESH_W8A8_PATH if ln[n] <= 0]
        extra = [n for n, c in ln.items() if c and n not in MESH_W8A8_PATH]
        acc = ln["block_gemm_int8_acc"]
        rowpar = {n: ln[n] for n in ("int8_epilogue", "row_amax", "quantize_rows_given")}
        if missing or extra or any(c != acc for c in rowpar.values()) \
                or acc % (2 * olmo.num_layers):
            problems.append(f"{name}: launches {json.dumps(ln)} (the path {MESH_W8A8_PATH}; the "
                            f"row-parallel entries 2 a layer a forward, equal counts)")
        # B [N, K/2]: the K halves of wo (H * dh = 2048) and w_down (8192)
        want = {str([olmo.d_model, K // 2]) for K in (olmo.num_heads * olmo.head_dim,
                                                      olmo.d_ff)}
        got_b = {k.split(" x ")[1] for k in e["shapes"].get("block_gemm_int8_acc", [])}
        if got_b != want:
            problems.append(f"{name}: int32 partials at B shapes {sorted(got_b)}, not wo's and "
                            f"w_down's halves {sorted(want)}")
        if e["graphed"]:
            problems.append(f"{name}: a gloo rank graphed its decode step")
        log(f"{name}: shard {json.dumps(r['e_local_shapes'])}; launches "
            f"{json.dumps({k: v for k, v in ln.items() if v})} ({acc // (2 * olmo.num_layers)} "
            f"forwards); int32-partial shapes {e['shapes'].get('block_gemm_int8_acc')}; peak "
            f"{e['peak_gib']:.2f} GiB; collectives a decode tick "
            f"{e['collectives_per_decode_tick']}, a mixed tick {e['collectives_per_mixed_tick']}")
    e0, st = ranks[0]["e"], singles["e"][1]
    log(f"mesh (e): decode tick {e0['decode_tick_ms']:.2f} ms wall (eager, 2 ranks on one card "
        f"over gloo) vs {st['decode_tick_ms']:.2f} ms single rank (graphed); mixed tick "
        f"{e0['mixed_tick_ms']:.2f} vs {st['mixed_tick_ms']:.2f} ms")
    out["e"] = dict(single=st, shard=ranks[0]["e_local_shapes"],
                    launches=e0["launches"], ranks=[r["e"] | {"tokens": None} for r in ranks])
    for key, shape, dtype, quant in MESH_SSD_RUNS:
        cfg = get_config("mamba2-130m").with_(compute_dtype=dtype)
        name = f"mesh (f) mamba2-130m {shape} {str(dtype).split('.')[-1]}" + \
            (" w8a8" if quant else "")
        k = len(singles[key][0])
        witnesses[key] = _mesh_gate(name, singles[key][0], ranks, key, cfg, f_prompts[:k],
                                    MESH_LOGITS_BOUND if dtype == torch.float32 else None,
                                    problems, quant=quant)
        data, model = (int(v) for v in shape.split("x"))
        for r in ranks:
            f = r[key]
            path = MESH_SSD_PATH + (("block_gemm_int8", "quantize_rows") if quant else ())
            bad = [n for n, c in f["launches"].items() if (c > 0) != (n in path)]
            if bad or f["h"][1:3] != [MESH_SSD_CONF["max_batch"] // data,
                                      cfg.ssm_heads // model]:
                problems.append(f"{name} rank {r['rank']}: launches {json.dumps(f['launches'])} "
                                f"(the path {path}), state {f['h']} (want the rank's "
                                f"{MESH_SSD_CONF['max_batch'] // data} slots of "
                                f"{cfg.ssm_heads // model} heads)")
        f0, st = ranks[0][key], singles[key][1]
        log(f"{name}: state a rank {f0['h']}; decode tick {f0['decode_tick_ms']:.2f} ms (eager, "
            f"gloo) vs {st['decode_tick_ms']:.2f} ms single rank (graphed); collectives a "
            f"decode tick: median {f0['collectives_median_decode_tick']}, most "
            f"{f0['collectives_per_decode_tick']} (a tick that also admits whole prefills); "
            f"peak {f0['peak_gib']:.2f} GiB")
        out[key] = dict(single=st, ranks=[r[key] | {"tokens": None} for r in ranks])
    jcfg = reduce_config(get_config("jamba-v0.1-52b"))
    witnesses["g"] = _mesh_gate("mesh (g) reduced jamba 1x2 f32", singles["g"][0], ranks, "g",
                                jcfg, g_prompts, MESH_LOGITS_BOUND, problems)
    for r in ranks:
        g = r["g"]
        bad = [n for n, c in g["launches"].items() if (c > 0) != (n in MESH_JAMBA_PATH)]
        if bad or not g["shard_map"] or g["experts_held"] != jcfg.num_experts // 2 \
                or g["h"][2] != jcfg.ssm_heads // 2:
            problems.append(f"mesh (g) rank {r['rank']}: launches {json.dumps(g['launches'])}, "
                            f"expert-parallel {g['shard_map']} ({g['experts_held']} held), "
                            f"state {g['h']}")
    same = sum(ranks[0]["g"]["tokens"][k] == v for k, v in singles["g"][0].items())
    log(f"mesh (g) reduced jamba 1x2 f32: {same} of {len(singles['g'][0])} requests equal to "
        f"the single rank's; {ranks[0]['g']['experts_held']} of {jcfg.num_experts} experts and "
        f"state {ranks[0]['g']['h']} a rank; launches "
        f"{json.dumps({k: v for k, v in ranks[0]['g']['launches'].items() if v})}")
    out["g"] = dict(single=singles["g"][1], ranks=[r["g"] | {"tokens": None} for r in ranks])
    out["witnesses"] = witnesses
    return out


def mesh_phase():
    """Mesh-sharded serving on the one card: two ranks of the port's own
    entry points on ``cuda:0`` over gloo (NCCL refuses two ranks on one
    device), each holding its shard (8 heads of 16, an ffn of 4096, half
    the vocab, 64 of 128 experts):

    (a) full olmo-1b at ``MeshSpec(1, 2)``, ``EngineConfig(max_batch=8,
        max_len=1024, page_size=64, chunk_tokens=64)``, 8 requests of 100-500
        tokens, 32 greedy new, in bf16 and in f32: tokens equal to the
        single-rank engine's with the same seed-0 weights, or each first
        difference a witnessed flip (``mesh_flip_witness``: a near-tie, and
        in f32 the logits there within 1e-2; bf16's gap is printed -- its
        rounding through 16 layers moves the logits ~5e-2); both ranks the
        same tokens; each rank launched the block GEMM and both paged
        kernels, at its shard's shapes;
    (b) qwen3-moe-30b-a3b at full width over 8 of its 48 layers, expert-
        parallel (``moe_shard_map``): one prefill's logits within 1e-4 of
        the single rank's in f32 (the CPU tests' bound against JAX; the
        bf16 gap printed beside 1e-2), 4 requests' greedy tokens in bf16
        under the same flip rule;
    (c) the four ring schedules at olmo-1b's FFN shapes (512 tokens, D 2048,
        F 8192, tp 2) against the dense product, f32 and bf16, timed beside
        the single rank's dense GEMMs;
    (d) ``python -m repro_torch.launch.serve --no-reduced --mesh 1x2 --backend
        gloo --requests 8 --max-new 16``: every request ``ok``, rank 0's
        summary line;
    (e) full olmo-1b w8a8 at ``MeshSpec(1, 2)`` with (a)'s engine and prompts:
        wo and w_down row-parallel (the whole row's max, the int32 partial,
        the exact int32 sum, the epilogue), the other projections and the
        head on the fused int8 GEMM of their column slices; tokens equal to
        the single rank's w8a8 engine or witnessed flips, both ranks the
        same, the path's kernels launched and no other, the row-parallel
        entries 2 a layer a forward at wo's and w_down's K halves;
    (f) full mamba2-130m, head-parallel at 1x2 (12 of 24 SSD heads a rank)
        and with the state's slots over the data group at 2x1, in bf16 and
        f32 (8 requests, ``SSM_PROMPTS``, 32 new; f32 under the flip rule's
        1e-2, bf16's gap printed), and a short w8a8 pass at 1x2 (4 x 16):
        tokens equal to the single rank's or witnessed flips, only the bf16
        GEMM (and, in w8a8, the int8 head) launched, each rank's state its
        heads and slots;
    (g) reduced jamba (f32; SSD, attention and 4 experts, expert-parallel) at
        1x2: tokens equal to the single rank's or witnessed flips.  The
        full-width period does not fit here: each rank would draw the whole
        26.5 GB period before it keeps its half, beside the single rank's;
    (h) (b)'s model at ``MOE_FFN_MESH`` (three ranks in a spawn of their
        own): 128 experts do not divide over 3, so every rank holds all of
        them and 256 of each expert's 768 FFN columns, and each MoE layer's
        output is one f32 all-reduce of the ranks' partials; (b)'s gates
        against (b)'s single rank (f32 prefill logits within 1e-4, bf16
        tokens under the flip rule, the same tokens on every rank) and
        ``MESH_PATH``'s kernels launched on every rank.

    Times of two ranks sharing one card over gloo (every collective through
    host memory, the decode step eager by rule) are not multi-GPU scaling
    numbers."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.gemm import cgra_gemm
    from repro_torch.launch import dist as D
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig
    os.makedirs(MESH_WORK, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.time()
    # the single-rank references, in this process: the engine's tokens and
    # tick times, and (b)'s prefill logits
    problems: list[str] = []
    mcfg = get_config("qwen3-moe-30b-a3b").with_(num_layers=MOE_MESH_LAYERS)
    b_prompts = _mesh_prompts(mcfg.vocab_size, MOE_MESH_LENGTHS, 4)
    cfg32 = mcfg.with_(compute_dtype=torch.float32)
    b32_prefill = _single_rank_logits(cfg32, M.init(cfg32, seed=0, device="cuda"),
                                      b_prompts[1], [])
    gc.collect()
    torch.cuda.empty_cache()
    singles = {}
    a_prompts = _mesh_prompts(get_config("olmo-1b").vocab_size, MESH_LENGTHS, 3)
    for key, dtype in MESH_DTYPES:
        cfg = get_config("olmo-1b").with_(compute_dtype=dtype)
        res, ticks = _serve_ticks(Engine(cfg, M.init(cfg, seed=0, device="cuda"),
                                         EngineConfig(**MESH_CONF)), a_prompts, MESH_MAX_NEW)
        singles[key] = ({str(k): r.generated for k, r in res.items()}, _tick_summary(ticks))
        gc.collect()
    # (e) the single rank's w8a8 engine
    cfg = get_config("olmo-1b")
    res, ticks = _serve_ticks(Engine(cfg, M.init(cfg, seed=0, device="cuda"),
                                     EngineConfig(quant="w8a8", **MESH_CONF)), a_prompts,
                              MESH_MAX_NEW)
    singles["e"] = ({str(k): r.generated for k, r in res.items()}, _tick_summary(ticks))
    # (f) mamba2-130m, (g) reduced jamba: the single rank's engines
    f_prompts = _mesh_prompts(get_config("mamba2-130m").vocab_size, SSM_PROMPTS, 9)
    for key, _, dtype, quant in MESH_SSD_RUNS:
        cfg = get_config("mamba2-130m").with_(compute_dtype=dtype)
        n_new, n_req = (MESH_SSD_MAX_NEW, 8) if quant is None else (MESH_SSD_W8A8_NEW, 4)
        res, ticks = _serve_ticks(Engine(cfg, M.init(cfg, seed=0, device="cuda"),
                                         EngineConfig(quant=quant, **MESH_SSD_CONF)),
                                  f_prompts[:n_req], n_new)
        singles[key] = ({str(k): r.generated for k, r in res.items()}, _tick_summary(ticks))
    jcfg = reduce_config(get_config("jamba-v0.1-52b"))
    g_prompts = _mesh_prompts(jcfg.vocab_size, MESH_JAMBA_LENGTHS, 11)
    res, ticks = _serve_ticks(Engine(jcfg, M.init(jcfg, seed=0, device="cuda"),
                                     EngineConfig(**MESH_JAMBA_CONF)), g_prompts, MESH_JAMBA_NEW)
    singles["g"] = ({str(k): r.generated for k, r in res.items()}, _tick_summary(ticks))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    mparams = M.init(mcfg, seed=0, device="cuda")
    res, ticks = _serve_ticks(Engine(mcfg, mparams, EngineConfig(**MESH_CONF)), b_prompts,
                              MOE_MESH_MAX_NEW)
    b_single = {str(k): r.generated for k, r in res.items()}
    b_ticks = _tick_summary(ticks)
    b_prefill = _single_rank_logits(mcfg, mparams, b_prompts[1], [])
    del res, mparams  # the ranks need the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    with open(os.path.join(MESH_WORK, "plan.json"), "w") as f:
        json.dump(dict(a_prompts=a_prompts, b_prompts=b_prompts, b_single=b_single,
                       f_prompts=f_prompts, g_prompts=g_prompts,
                       **{f"{k}_single": v[0] for k, v in singles.items()}), f)
    t0 = time.time()
    D.spawn(_mesh_rank, 2, "gloo", args=(MESH_WORK,))
    ranks_s = time.time() - t0
    ranks = [json.load(open(os.path.join(MESH_WORK, f"rank{r}.json"))) for r in range(2)]
    log(f"mesh: backend {ranks[0]['backend']}, both ranks on cuda:{ranks[0]['device']}; the "
        f"decode step graphed: {ranks[0]['a']['graphed']} (eager by rule under gloo); the "
        f"ranks' run {ranks_s:.1f} s")
    # (a): f32 holds the flip rule's 1e-2 on the logits; bf16 is printed beside it
    witnesses = {}
    for key, dtype in MESH_DTYPES:
        cfg = get_config("olmo-1b").with_(compute_dtype=dtype)
        name = f"mesh (a) olmo-1b 1x2 {str(dtype).split('.')[-1]}"
        witnesses[key] = _mesh_gate(name, singles[key][0], ranks, key, cfg, a_prompts,
                                    MESH_LOGITS_BOUND if key == "a32" else None, problems)
        for r in ranks:
            a = r[key]
            if a["graphed"]:
                problems.append(f"{name}: a gloo rank graphed its decode step")
            missing = [n for n in MESH_PATH if a["launches"][n] <= 0]
            if missing:
                problems.append(f"{name} rank {r['rank']}: {missing} never launched")
            log(f"{name} rank {r['rank']}: shard {json.dumps(r[key + '_local_shapes'])}; "
                f"launches {json.dumps({k: v for k, v in a['launches'].items() if v})}; peak "
                f"{a['peak_gib']:.2f} GiB; collectives a decode tick "
                f"{a['collectives_per_decode_tick']}, a mixed tick "
                f"{a['collectives_per_mixed_tick']}")
            log(f"{name} rank {r['rank']} kernel shapes: {json.dumps(a['shapes'])}")
        a0, st = ranks[0][key], singles[key][1]
        log(f"{name}: decode tick {a0['decode_tick_ms']:.2f} ms wall (eager, 2 ranks on one "
            f"card over gloo) vs {st['decode_tick_ms']:.2f} ms single rank (graphed); mixed "
            f"tick {a0['mixed_tick_ms']:.2f} vs {st['mixed_tick_ms']:.2f} ms")
    # (b)
    b0 = ranks[0]["b"]
    if not (b0["shard_map"] and b0["experts_held"] == mcfg.num_experts // 2):
        problems.append(f"mesh (b): expert-parallel not on: {b0['shard_map']}, "
                        f"{b0['experts_held']} held")
    # the gate reads f32 (bound 1e-4, the CPU tests' against JAX); the bf16
    # gap is printed beside the bound 1e-2 of the flip rule
    gaps = {}
    for key, single in (("b32", b32_prefill), ("b", b_prefill)):
        lg = [torch.load(os.path.join(MESH_WORK, f"{key}_prefill_r{r}.pt")) for r in range(2)]
        gaps[key] = float((lg[0] - single).abs().max())
        if not torch.equal(lg[0], lg[1]):
            problems.append(f"mesh (b) {key}: the ranks' prefill logits differ")
    b_gap = gaps["b"]
    log(f"mesh (b) qwen3-moe {MOE_MESH_LAYERS} of 48 layers, 64 of 128 experts a rank, "
        f"expert-parallel prefill logits from the single rank's: f32 {gaps['b32']:.3e} (gate "
        f"{MOE_F32_BOUND}), bf16 {b_gap:.3e} (beside {MESH_LOGITS_BOUND}, not gated: bf16 "
        f"rounding of the sharded sums through 8 layers)")
    if not math.isfinite(gaps["b32"]) or gaps["b32"] > MOE_F32_BOUND:
        problems.append(f"mesh (b): f32 prefill logits {gaps['b32']:.3e} from the single "
                        f"rank's (bound {MOE_F32_BOUND})")
    witnesses["b"] = _mesh_gate("mesh (b) qwen3-moe 1x2 bf16", b_single, ranks, "b", mcfg,
                                b_prompts, None, problems)
    log(f"mesh (b): decode tick {b0['decode_tick_ms']:.2f} ms (2 ranks, eager, gloo) vs "
        f"{b_ticks['decode_tick_ms']:.2f} ms single rank (graphed); peak "
        f"{b0['peak_gib']:.2f} GiB a rank; collectives a decode tick "
        f"{b0['collectives_per_decode_tick']}")
    gc.collect()
    torch.cuda.empty_cache()
    # (h) the same model over three ranks, each expert's FFN cut over them
    t0 = time.time()
    D.spawn(_mesh_ffn_rank, 3, "gloo", args=(MESH_WORK,))
    h_s = time.time() - t0
    h_ranks = [json.load(open(os.path.join(MESH_WORK, f"h_rank{r}.json"))) for r in range(3)]
    ffn_cut = _mesh_ffn_gates(h_ranks, mcfg, b32_prefill, b_prefill, b_single, b_ticks,
                              b_prompts, problems)
    ffn_cut["ranks_s"] = h_s
    gc.collect()
    torch.cuda.empty_cache()
    e_f_g = _mesh_gates_efg(ranks, singles, a_prompts, f_prompts, g_prompts, problems)
    witnesses.update(e_f_g.pop("witnesses"))
    gc.collect()
    torch.cuda.empty_cache()
    # (c): agreement, and the single rank's dense GEMMs at the same shapes
    ring = {}
    for dt, tol in (("float32", 1e-5), ("bfloat16", 2 ** -7)):
        g = torch.Generator(device="cuda").manual_seed(7)
        dtype = getattr(torch, dt)
        x = torch.randn(RING_T, RING_D, generator=g, device="cuda").to(dtype)
        w = torch.randn(RING_D, RING_F, generator=g, device="cuda").to(dtype)
        wd = torch.randn(RING_F, RING_D, generator=g, device="cuda").to(dtype)
        h = torch.randn(RING_T, RING_F, generator=g, device="cuda").to(dtype)
        dense = dict(ffn_up=time_ms(lambda: cgra_gemm(x, w), L2Flush(), reps=10),
                     ffn_down=time_ms(lambda: cgra_gemm(h, wd), L2Flush(), reps=10))
        for name in ranks[0]["c"][dt]:
            errs = [r["c"][dt][name]["rel_err"] for r in ranks]
            if max(errs) > tol:
                problems.append(f"mesh (c) {name} {dt}: {max(errs):.3e} from the dense "
                                f"product (relative, bound {tol})")
        ring[dt] = dict(rows=ranks[0]["c"][dt], dense_single_rank_ms=dense)
        log(f"mesh (c) ring schedules {dt}, tp 2, two ranks on one card over gloo (not a "
            f"scaling number): " + ", ".join(
                f"{n} {v['ms']:.2f} ms (rel err {v['rel_err']:.2e})"
                for n, v in ranks[0]["c"][dt].items())
            + f"; single-rank dense GEMMs x @ W_up {dense['ffn_up']:.3f} ms, h @ W_down "
            f"{dense['ffn_down']:.3f} ms (CUDA events)")
    # (d) launch.serve's own command line
    t0 = time.time()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--no-reduced", "--mesh", "1x2",
           "--backend", "gloo", "--requests", "8", "--max-new", "16"]
    out = subprocess.run(cmd, cwd=HERE, env=dict(os.environ, PYTHONPATH=os.path.join(
        HERE, "src")), text=True, capture_output=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if "=" in ln]
    for ln in lines:
        log(f"mesh (d) {ln}")
    if out.returncode != 0 or len(lines) != 2 or "requests=8 ok=8" not in lines[0] \
            or "ranks_agree=True" not in lines[1]:
        problems.append(f"mesh (d): {' '.join(cmd[2:])} gave {out.returncode}: "
                        f"{out.stdout[-1500:]}{out.stderr[-1500:]}")
    d_s = time.time() - t0
    if problems:
        fail("; ".join(problems))
    return dict(backend=ranks[0]["backend"], graphed=ranks[0]["a"]["graphed"], ranks_s=ranks_s,
                a={key: dict(single=singles[key][1], witnesses=witnesses[key],
                             shard=ranks[0][key + "_local_shapes"],
                             ranks=[r[key] | {"tokens": None} for r in ranks])
                   for key, _ in MESH_DTYPES},
                b=dict(single=b_ticks, prefill_logits_gap=gaps, witnesses=witnesses["b"],
                       ranks=[r["b"] | {"tokens": None} for r in ranks]),
                h=ffn_cut,
                **{k: dict(v, witnesses=witnesses[k]) for k, v in e_f_g.items()},
                ring=ring, serve_line=lines, serve_s=d_s, wall_s=time.time() - t_phase)


# ---------------------------------------------------------------------------
# phase 9b: the reference's single-card training options
# ---------------------------------------------------------------------------

REMAT = ("none", "dots_nb", "dots", "full")
OPTION_STEPS = 3
LONG_B, LONG_STEPS = 2, 10  # SHAPES["train_4k"]'s sequence length, 2 sequences a step


def _policy_run(cfg, opt, batches, counters, n_fwd, n_head, what, **step_kw):
    """``make_train_step`` over ``batches`` from the seed-0 state with every
    counter at 0: losses (finite), step ms (host clock to the loss's read),
    peak device memory over the steps (the update holds two states), the
    block GEMM's launches a step, which must be 3 per forward GEMM, 4 per
    GEMM inside a layer group under ``full`` (the head stays at 3), and no
    other wrapper's.  Before the steps, one forward + backward alone gives
    the activations' peak above the state."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.training import init_state, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.training.step import value_and_grad
    state = init_state(cfg, opt, seed=0, device="cuda")
    step = make_train_step(cfg, opt, **step_kw)
    # forward + backward alone: the activations' peak above the state
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = value_and_grad(cfg, state.params, to_device(batches[0], "cuda"),
                           attn_chunk=step_kw.get("attn_chunk", 0))[2]
    torch.cuda.synchronize()
    grad_peak = torch.cuda.max_memory_allocated() - held
    del grads
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        times.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()
    per_gemm = 4 if cfg.remat_policy == "full" else 3
    want = (per_gemm * (n_fwd - n_head) + 3 * n_head) * len(batches)
    got = _launched(counters, [c.__name__ for c in counters], {"block_gemm": want}, what)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: losses {losses}")
    del state, m
    return dict(losses=losses, step_ms_all=[t * 1e3 for t in times],
                step_ms=statistics.median(times[1:] if len(times) > 1 else times) * 1e3,
                peak_gib=peak / 2 ** 30, grad_peak_above_state_gib=grad_peak / 2 ** 30,
                gemm_launches_per_step=got["block_gemm"] // len(batches),
                gemm_launches_per_layer_gemm=per_gemm)


def train_options_phase(counters):
    """Full-width olmo-1b (16 layers, bf16, seed-0 weights), f32 moments:

    - 3 steps of 8 x 512 tokens under each ``remat_policy`` (``none``,
      ``dots_nb``, ``dots``, ``full``) on the same batches: the losses equal
      across policies to 1e-6 relative (recompute runs the same
      deterministic kernels in the same order: expected bit-equal); the
      block GEMM launched 3 times per forward GEMM of the layer stack a step
      under ``none`` / ``dots_nb`` / ``dots`` and 4 under ``full``, the head
      3; ``full``'s peak of a forward + backward (above the state) below
      ``none``'s; step ms, that peak and the step's peak (set by the pure
      update, which holds two states) per policy;
    - ``full`` at 2 x 4096 tokens (``SHAPES["train_4k"]``'s sequence
      length) for 10 steps: finite losses, the last below the first; step
      ms, tokens/s, peak, and the model-FLOP share ``model_flops / (step_s
      x 989e12)`` (``launch/roofline.py``); ``none`` is not run there (its
      plain-attention scores alone are ~2.1 GiB of f32 a layer);
    - ``attn_chunk``: one step under ``none`` at 8 x 512 with
      ``attn_chunk=128`` (4 query blocks) and one under ``full`` at 2 x 4096
      with ``attn_chunk=512`` (8 blocks) equal the unchunked first losses to
      1e-5 relative; ``make_eval_step(attn_chunk=512)`` at 2 x 4096 launches
      the dense flash kernel once a layer (without autograd it takes the
      whole query block), its loss within 1e-4 of the f32-score plain
      attention's (bf16 probabilities in the kernel)."""
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.training import AdamWConfig, init_state, make_eval_step
    names = [c.__name__ for c in counters]
    base = get_config(TRAIN)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=LONG_STEPS, moments_dtype="f32")
    data = SyntheticLM(base, batch=TRAIN_B, seq=TRAIN_S, seed=0)
    batches = [data.batch_at(i) for i in range(OPTION_STEPS)]
    state = init_state(base, opt, seed=0, device="cuda")
    n_fwd = _forward_gemms(base, state.params, to_device(batches[0], "cuda"))
    del state
    n_head = 1  # the untied head: the one GEMM outside the layer groups
    out = {"gemms_per_forward": n_fwd}
    for policy in REMAT:
        cfg = base.with_(remat_policy=policy)
        r = _policy_run(cfg, opt, batches, counters, n_fwd, n_head, f"remat {policy}")
        out[policy] = r
        log(f"{TRAIN} remat_policy={policy}: {OPTION_STEPS} steps of {TRAIN_B} x {TRAIN_S}, "
            f"losses " + ", ".join(f"{x:.6f}" for x in r["losses"]) + f"; step "
            f"{r['step_ms']:.1f} ms (all: " + ", ".join(f"{t:.1f}" for t in r["step_ms_all"])
            + f"), peak {r['peak_gib']:.2f} GiB (forward + backward alone "
            f"{r['grad_peak_above_state_gib']:.2f} GiB above the state); block_gemm "
            f"{r['gemm_launches_per_step']} "
            f"launches a step ({r['gemm_launches_per_layer_gemm']} per layer GEMM x "
            f"{n_fwd - n_head}, 3 at the head)")
    ref = out["none"]["losses"]
    for policy in REMAT[1:]:
        gap = max(abs(a - b) / abs(b) for a, b in zip(out[policy]["losses"], ref))
        out[policy]["loss_rel_gap_vs_none"] = gap
        if gap > 1e-6:
            fail(f"remat {policy}: losses {out[policy]['losses']} vs none {ref}")
    # the activations' peak (a forward + backward alone): what remat moves;
    # a whole step's peak at 8 x 512 is the update's, which holds two states
    full_pk, none_pk = (out[p]["grad_peak_above_state_gib"] for p in ("full", "none"))
    if not full_pk < none_pk:
        fail(f"remat full: forward + backward peak {full_pk:.2f} GiB above the state, not "
             f"below none's {none_pk:.2f}")
    chunked = _policy_run(base.with_(remat_policy="none"), opt, batches[:1], counters, n_fwd,
                          n_head, "none, attn_chunk=128", attn_chunk=128)
    gap = abs(chunked["losses"][0] - ref[0]) / abs(ref[0])
    if gap > 1e-5:
        fail(f"attn_chunk=128: loss {chunked['losses'][0]} vs {ref[0]} unchunked")
    out["attn_chunk_128_none"] = dict(chunked, loss_rel_gap=gap)

    # full at the reference's training length
    S = SHAPES["train_4k"].seq_len
    cfg = base.with_(remat_policy="full")
    long_data = SyntheticLM(base, batch=LONG_B, seq=S, seed=0)
    long_batches = [long_data.batch_at(i) for i in range(LONG_STEPS)]
    r = _policy_run(cfg, opt, long_batches, counters, n_fwd, n_head, f"full at {LONG_B} x {S}")
    losses = r["losses"]
    if not losses[-1] < losses[0]:
        fail(f"full at {LONG_B} x {S}: losses {losses} (the last below the first)")
    flops = model_flops(cfg, ShapeConfig("train_2x4k", S, LONG_B, "train"))
    share = flops / (r["step_ms"] / 1e3 * PEAK_FLOPS)
    r.update(tokens_per_s=LONG_B * S / r["step_ms"] * 1e3, model_flops=flops,
             model_flop_share=share)
    out["full_2x4096"] = r
    log(f"{TRAIN} remat_policy=full at {LONG_B} x {S} tokens: {LONG_STEPS} steps, losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f"; step {r['step_ms']:.1f} ms (median of "
        f"steps 2-{LONG_STEPS}), {r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gib']:.2f} "
        f"GiB, model FLOPs {flops:.4e} a step: {share:.4f} of 989 TFLOP/s")
    chunk = _policy_run(cfg, opt, long_batches[:1], counters, n_fwd, n_head,
                        f"full at {LONG_B} x {S}, attn_chunk=512", attn_chunk=512)
    gap = abs(chunk["losses"][0] - losses[0]) / abs(losses[0])
    if gap > 1e-5:
        fail(f"attn_chunk=512 at {LONG_B} x {S}: loss {chunk['losses'][0]} vs {losses[0]}")
    out["attn_chunk_512_full_2x4096"] = dict(chunk, loss_rel_gap=gap)
    # without autograd the dense flash kernel takes the whole query block
    state = init_state(cfg, opt, seed=0, device="cuda")
    for c in counters:
        c.launches = 0
    ev = make_eval_step(cfg, attn_chunk=512)(state.params, long_batches[0])
    ev_loss = float(ev["loss"])
    _launched(counters, names, {"block_gemm": n_fwd, "flash_attention": base.num_layers},
              "eval step, attn_chunk=512")
    eval_gap = abs(ev_loss - losses[0]) / abs(losses[0])
    # 1e-4: ~4x the gap measured on the card (2.25e-5); the kernel itself
    # is held at this shape, row by row, in ``dense_attention_phase``
    if not eval_gap <= 1e-4:
        fail(f"eval step on the dense flash kernel: loss {ev_loss} vs {losses[0]} (plain)")
    out["eval_attn_chunk_512"] = dict(loss=ev_loss, loss_rel_gap_vs_plain=eval_gap,
                                      flash_attention_launches=base.num_layers)
    del state
    log(f"attn_chunk: none at {TRAIN_B} x {TRAIN_S} with 128-row query blocks, loss gap "
        f"{out['attn_chunk_128_none']['loss_rel_gap']:.2e}; full at {LONG_B} x {S} with "
        f"512-row blocks, loss gap {gap:.2e}, peak {chunk['peak_gib']:.2f} GiB (unchunked "
        f"{r['peak_gib']:.2f}); eval step on the dense flash kernel ({base.num_layers} "
        f"launches), loss {ev_loss:.6f}, {eval_gap:.2e} from the plain attention's")
    return out


# ---------------------------------------------------------------------------
# phase 10: training over a mesh (two gloo ranks sharing the one card)
# ---------------------------------------------------------------------------

MESH_TRAIN_WORK = os.path.join(HERE, "build", "mesh_train_phase")  # git-ignored
# layout: (mesh shape, axes, remat policy, compress_pod, steps, what)
MESH_TRAIN_LAYOUTS = {
    "a": ((1, 2), ("data", "model"), "none", False, 3, "1x2 2d (tensor parallel)"),
    "b": ((2, 1), ("data", "model"), "full", False, 3, "2x1 FSDP (ZeRO-3 over data)"),
    "c": ((2, 1, 1), ("pod", "data", "model"), "none", True, 2, "pod=2 compress_pod"),
}
# stated before the first run: bf16 over 16 layers rounds differently when the
# sums are split (row-parallel partials, shard gathers, the int8 pod mean),
# and an AdamW step near sign(g) can turn a near-zero entry either way; a mean
# loss over 4096 tokens moves far less than a logit (~5e-2 in PR 23's serving)
MESH_TRAIN_LOSS_BOUND = 2e-2   # |mesh loss - single rank's| at each step, bf16
MESH_TRAIN_GNORM_RTOL = 2e-2   # grad_norm, relative (the int8 pod mean included)
MESH_TRAIN_F32_LAYERS = 2      # (d): f32 at full width, the main stage cut to 2 layers
MESH_TRAIN_GRAD_RTOL = 1e-4    # (d): gathered gradients vs the single rank's, of each leaf's max
# the bf16 GEMM at the shards' training shapes: 1x2 halves every GEMM's N (a
# column-parallel weight) or K (a row-parallel one) at all T = 4096 rows; 2x1
# and pod=2 run the whole widths at T / 2 = 2048 rows a rank
MESH_TRAIN_GEMMS = ((TRAIN_T, ((2048, 1024), (1024, 2048), (2048, 4096), (4096, 2048),
                               (2048, 25216))),
                    (TRAIN_T // 2, TRAIN_KN))
# (e)-(h): the other families at full width in bf16, each against the single
# rank in this phase: (arch, layouts, batch, seq, what); a layout is (the key
# of the (a)-(c) mesh it runs on, remat policy)
MESH_TRAIN_FAMILIES = {
    "e": ("mamba2-130m", (("a", "none"), ("b", "full")), 8, 512,
          "mamba2-130m whole (24 SSD layers), 1x2 head-parallel (12 of 24 heads a rank) and "
          "2x1 FSDP"),
    "f": ("minicpm3-4b", (("a", "full"),), 4, 512,
          "minicpm3-4b MLA, 1x2 (20 of 40 heads a rank), the main stage cut to 35 of 62 layers"),
    "g": ("llama-3.2-vision-11b", (("a", "none"),), 2, 512,
          "llama-3.2-vision-11b one period (4 self + 1 cross layer), 1x2, 1601 stub patch "
          "embeddings a row, gates 0.5"),
    "h": ("hubert-xlarge", (("a", "full"),), 4, 1000,
          "hubert-xlarge whole (48 layers), 1x2, 4 x 1000 frames, biases opened"),
}
MESH_TRAIN_FAMILY_STEPS = 2    # (e)-(h): 2 steps each, to keep the phase's growth near 200 s
MESH_TRAIN_F32_PERIODS = 2     # (i): f32 at full width, 2 layers (the VLM: one period)
# the main stage's depth of (e)-(h) where it is cut (the others run whole):
# (f) minicpm3-4b at 35 of its 62 layers (2.570 B parameters).  A rank pays
# about 28 bytes a parameter it holds (bf16 weights and gradients, f32
# moments, the step's f32 gradient copies) and holds about half of each
# layer (62.7 M parameters) and of the rest (438.9 M), so 35 layers are the
# most two ranks fit in 85 % of an 80 GB card; (g) one VLM period
MESH_TRAIN_FAMILY_DEPTH = {"f": 35, "g": 1}
# the GEMM at the new families' shard shapes (1x2 unless said), as (T, (K,
# N) of each forward GEMM, the head's N): mamba2 w_out (row-parallel) and
# head, also at 2x1; minicpm3-4b wq_a, wq_b, wkv_a, wkv_b, wo, gate / up,
# down, head; llama-3.2-vision q, k / v, o, gate / up, down, head and the
# image's k / v (T = 2 x 1601); hubert q / k / v, o, w1, w2, head
MESH_TRAIN_FAMILY_GEMMS = {
    "e": ((4096, ((768, 768), (768, 25216)), 25216), (2048, ((1536, 768), (768, 50432)), 50432)),
    "f": ((2048, ((2560, 768), (768, 1920), (2560, 288), (256, 2560), (1280, 2560),
                  (2560, 3200), (3200, 2560), (2560, 36736)), 36736),),
    "g": ((1024, ((4096, 2048), (4096, 512), (2048, 4096), (4096, 7168), (7168, 4096),
                  (4096, 64128)), 64128), (3202, ((4096, 512),), None)),
    "h": ((4000, ((1280, 640), (640, 1280), (1280, 2560), (2560, 1280), (1280, 256)), 256),),
}


# (j): qwen3-moe-30b-a3b at full width (d_model 2048, 128 experts top-8 of
# width 768) over the MoE meshes the expert-parallel rule does not serve:
# (key: (mesh shape, parallel_mode, what)), each under the config's own
# remat_policy ("full", MESH_MOE_REMAT), so a layer's recompute runs its
# collectives again on the autograd engine's thread.  j1: the batch splits
# over both ranks and prepare_arch makes one dispatch group (pod * data), so
# the group spans them; j2: 128 experts do not divide over 3, each expert's
# FFN (768 = 3 x 256) does
MESH_MOE_LAYOUTS = {
    "j1": ((1, 2), "fsdp", "1x2 parallel_mode='fsdp' (one dispatch group over both ranks)"),
    "j2": ((1, 3), "2d", "1x3 '2d' (256 of each expert's 768 FFN columns a rank)"),
}
MESH_MOE_REMAT = "full"
# the main stage cut to 2 of its 48 layers: the single rank's bf16 step
# holds about 20 bytes a parameter (bf16 weights and gradients, f32
# moments) and each layer carries 623 M (604 M of them experts), so the
# whole model's 30.5 B would not fit one card; 2 layers and the 311 M
# embedding and 311 M head make 1.87 B
MESH_MOE_LAYERS = 2
MESH_MOE_B, MESH_MOE_S, MESH_MOE_STEPS = 4, 512, 2
MESH_MOE_F32_LAYERS = 1  # (j3): f32 at full width, 1 layer, each layout


def _moe_train_cfg(mode, dtype=torch.bfloat16, remat="none"):
    from repro_torch.configs import get_config
    return get_config("qwen3-moe-30b-a3b").with_(parallel_mode=mode, remat_policy=remat,
                                                 compute_dtype=dtype)


def _moe_batches():
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(_moe_train_cfg("2d"), batch=MESH_MOE_B, seq=MESH_MOE_S, seed=0)
    return [data.batch_at(i) for i in range(MESH_MOE_STEPS)]


@contextlib.contextmanager
def _route_drops():
    """The choices every MoE route inside the block drops, summed
    (``layers.moe_route`` wrapped for the block; each count stays on the
    card until the block ends): yields a list whose one entry is set at
    the end."""
    from repro_torch.models import layers as L
    route, counts, box = L.moe_route, [], [0]

    def counted(*a, **kw):
        r = route(*a, **kw)
        counts.append((~r.kept).sum())
        return r
    L.moe_route = counted
    try:
        yield box
    finally:
        L.moe_route = route
        box[0] = int(sum(int(c) for c in counts))


def _mesh_moe_train_rank(rank, work):
    """One rank of mesh training (j) (three ranks on ``cuda:0`` over gloo):
    (j1) / (j2) qwen3-moe-30b-a3b at ``MESH_MOE_LAYERS`` layers in bf16 on
    each layout of ``MESH_MOE_LAYOUTS`` (a rank outside j1's 1x2 mesh waits
    at a barrier), ``MESH_MOE_STEPS`` steps of ``MESH_MOE_B`` x
    ``MESH_MOE_S`` tokens under ``MESH_MOE_REMAT``, a row a step as (a)-(c),
    the first step's collective records and the choices capacity dropped
    (each route of the forward and of the recompute); (j3) f32 at
    ``MESH_MOE_F32_LAYERS`` layer on each layout: the
    gathered gradients and the loss of the first batch against the single
    rank's (rank 0 computes those alone first).  Writes ``moe_rank<r>.json``
    into ``work``."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import _build
    from repro_torch.launch.cells import prepare_arch
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.sharding import gather_whole
    from repro_torch.models import model as M
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.step import mesh_config, mesh_value_and_grad, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # the main process built them: loaded from build/
    dev = torch.device("cuda", 0)
    meshes = {k: make_device_mesh(v[0], ("data", "model")) for k, v in MESH_MOE_LAYOUTS.items()}
    world = meshes["j2"]  # every rank
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS, moments_dtype="f32")
    batches = _moe_batches()
    out, R = {}, MESH_MOE_LAYERS
    for key, (shape, mode, _) in MESH_MOE_LAYOUTS.items():
        mesh = meshes[key]
        world.barrier()  # a rank outside the last layout's mesh waits for it here
        if mesh.coords is None:
            continue
        cfg = prepare_arch(_moe_train_cfg(mode, remat=MESH_MOE_REMAT), mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = _mesh_train_state(cfg, opt, mesh, dev, R)
        ffn = state.params["stages"][0]["0"]["ffn"]
        held_shapes = {k: list(ffn[k].shape) for k in ("w_gate", "w_down")}
        n_local = sum(t.numel() for t in tree_leaves(state.params))
        step = make_train_step(cfg, opt, mesh=mesh, main_repeats=R)
        held = _held_before_step()
        rows = []
        with _route_drops() as dropped:
            for i in range(MESH_MOE_STEPS):
                mesh.records = [] if i == 0 else None  # the first step's collectives
                state, row = _timed_mesh_step(step, state, batches[i], mesh)
                if i == 0:
                    records = [list(x) for x in mesh.records]
                rows.append(row)
        mesh.records = None
        out[key] = dict(steps=rows, **_step_memory(*held), params_local=n_local,
                        dropped=dropped[0], groups=cfg.num_moe_groups, records=records,
                        **held_shapes)
        del state, step, ffn
    world.barrier()
    gc.collect()
    torch.cuda.empty_cache()

    # (j3) f32 at 1 layer: gradients and loss against the single rank's
    R = MESH_MOE_F32_LAYERS
    batch = batches[0]
    single = None
    if rank == 0:  # the single rank, alone (no collective runs meanwhile)
        cfg = _moe_train_cfg("2d", torch.float32)
        params = _seed_params(cfg, dev, R)
        loss, _, single = value_and_grad(cfg, params, to_device(batch, dev), main_repeats=R)
        out["j3_single_loss"] = float(loss)
        del params
    j3 = {}
    for key, (shape, mode, _) in MESH_MOE_LAYOUTS.items():
        mesh = meshes[key]
        if mesh.coords is None:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        cfg = prepare_arch(_moe_train_cfg(mode, torch.float32, MESH_MOE_REMAT), mesh)
        params = M.shard_params(cfg, _seed_params(cfg, dev, R), mesh, fsdp=cfg.fsdp,
                                main_repeats=R)
        pspecs = M.param_pspecs(mesh_config(cfg, mesh), mesh, fsdp=cfg.fsdp, main_repeats=R)
        with _route_drops() as dropped:
            loss, _, g = mesh_value_and_grad(cfg, params, batch, mesh, main_repeats=R)
        del params
        whole = tree_map(lambda t, ps: gather_whole(t, mesh, ps), g, pspecs)
        row = dict(loss=float(loss), dropped=dropped[0])
        if rank == 0:
            row["grad_gap"], row["grad_leaf"] = _grad_gap(whole, single)
        del g, whole
        j3[key] = row
    out["j3"] = j3
    with open(os.path.join(work, f"moe_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _mesh_moe_train(opt, problems) -> dict:
    """Mesh training (j) on the card: :func:`_mesh_moe_train_rank` on three
    gloo ranks, then the single rank's bf16 steps in this process (under
    the same remat, so its routes run as often); gates as (a)-(c)
    (:func:`_mesh_train_gates`, every rank of the layout), capacity dropping
    choices in j1, each rank's first step issuing the collectives the dry
    run predicts for it (``launch.dryrun.count`` of ``build_cell`` on a
    ``DryMesh`` of the layout, as that rank: kind, axis, group and bytes of
    each, in any order), j1's among them its dispatch group's count
    all-gathers, one a MoE layer's forward and one its recompute; (j3) as
    (d).  Each rank's peak printed beside the dry run's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dist as D
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import count
    from repro_torch.launch.mesh import DryMesh
    from repro_torch.training import make_train_step
    t0 = time.time()
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        D.spawn(_mesh_moe_train_rank, 3, "gloo", args=(MESH_TRAIN_WORK,))
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    ranks_s = time.time() - t0
    ranks = [json.load(open(os.path.join(MESH_TRAIN_WORK, f"moe_rank{r}.json")))
             for r in range(3)]
    # the single rank's bf16 steps (one dispatch group, as both layouts)
    R = MESH_MOE_LAYERS
    cfg = _moe_train_cfg("2d", remat=MESH_MOE_REMAT)
    torch.cuda.reset_peak_memory_stats()
    state = _mesh_train_state(cfg, opt, None, torch.device("cuda", 0), R)
    step = make_train_step(cfg, opt, main_repeats=R)
    single = []
    with _route_drops() as single_dropped:
        for batch in _moe_batches():
            torch.cuda.synchronize()
            t1 = time.time()
            state, m = step(state, batch)
            single.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                               ms=(time.time() - t1) * 1e3))
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    n_fwd = _n_forward_gemms(cfg, R)
    summary = {}
    for key, (shape, mode, what) in MESH_MOE_LAYOUTS.items():
        n = math.prod(shape)
        rows = [r[key]["steps"] for r in ranks[:n]]
        _mesh_train_gates(key, rows, single, MESH_MOE_REMAT, n_fwd, problems)
        if key == "j1" and not ranks[0][key]["dropped"] > 0:
            problems.append("mesh train (j1): capacity dropped no choice: the cross-rank "
                            "slots were not exercised")
        preds = []
        # a rank's int32 choice counts [1, k, E] gathered over its group (model)
        count_gather = ["all-gather", "model", n, cfg.experts_per_token * cfg.num_experts * 4]
        for r in range(n):  # the dry run's prediction for this rank
            dm = DryMesh(shape, ("data", "model"), rank=r)
            c = count(build_cell(_moe_train_cfg(mode, remat=MESH_MOE_REMAT), ShapeConfig(
                "train", MESH_MOE_S, MESH_MOE_B, "train"), dm, opt=opt, main_repeats=R))
            live = ranks[r][key]["records"]
            gathers = sum(x == count_gather for x in live)
            preds.append(dict(arguments_gib=c.argument_bytes / 2 ** 30,
                              peak_gib=c.peak / 2 ** 30, collectives=dm.collectives,
                              wire_bytes=dm.wire_bytes, count_gathers=gathers))
            if Counter(map(tuple, live)) != Counter(map(tuple, dm.records)):
                problems.append(f"mesh train ({key}) rank {r}: the first step's collectives "
                                f"({len(live)}) are not the dry run's ({len(dm.records)})")
            want = 2 * R  # a MoE layer's forward and its recompute
            if key == "j1" and gathers != want:
                problems.append(f"mesh train ({key}) rank {r}: {gathers} count all-gathers "
                                f"{count_gather} in the first step, want {want}")
        ms = [statistics.median(x["ms"] for x in r_[1:] or r_) for r_ in rows]
        last = rows[0][-1]
        summary[key] = dict(
            what=what, depth=R, groups=ranks[0][key]["groups"],
            dropped=[r[key]["dropped"] for r in ranks[:n]],
            single_dropped=single_dropped[0],
            w_gate=ranks[0][key]["w_gate"], w_down=ranks[0][key]["w_down"],
            step_ms_median=ms, step_ms_all=[[x["ms"] for x in r_] for r_ in rows],
            losses=[x["loss"] for x in rows[0]], single_losses=[x["loss"] for x in single],
            grad_norms=[x["grad_norm"] for x in rows[0]],
            single_grad_norms=[x["grad_norm"] for x in single],
            single_step_ms=[x["ms"] for x in single], single_peak_gib=single_peak,
            collectives_per_step=[x["collectives"] for x in rows[0]],
            wire_bytes_per_step=[x["wire_bytes"] for x in rows[0]],
            peak_gib=[r[key]["peak_gib"] for r in ranks[:n]],
            step_peak_gib=[r[key]["step_peak_gib"] for r in ranks[:n]],
            held_gib=[r[key]["held_gib"] for r in ranks[:n]],
            reserved_gib=[r[key]["reserved_gib"] for r in ranks[:n]],
            gemm_launches_per_step=[[x["launches"].get("block_gemm", 0) for x in r_]
                                    for r_ in rows],
            trans_a_per_step=[[x["trans_a"] for x in r_] for r_ in rows],
            params_local=[r[key]["params_local"] for r in ranks[:n]], predicted=preds)
        log(f"mesh train ({key}) qwen3-moe-30b-a3b {R} of 48 layers, {what}, {n} ranks on one "
            f"card over gloo (not a scaling number): step "
            + " / ".join(f"{x:.1f}" for x in ms) + " ms a rank (step 2; all: "
            + ", ".join(f"{x['ms']:.1f}" for x in rows[0]) + "); single rank "
            + ", ".join(f"{x['ms']:.1f}" for x in single) + " ms; losses "
            + ", ".join(f"{x['loss']:.5f}" for x in rows[0]) + " (single rank "
            + ", ".join(f"{x['loss']:.5f}" for x in single) + f"); {summary[key]['dropped']} "
            f"choices dropped a rank over the steps (single rank {single_dropped[0]})")
        log(f"mesh train ({key}): {last['collectives']} collectives and "
            f"{last['wire_bytes'] / 1e9:.3f} GB handed to them a step a rank (dry run "
            f"{preds[0]['collectives']} and {preds[0]['wire_bytes'] / 1e9:.3f} GB); block_gemm "
            f"{last['launches'].get('block_gemm', 0)} launches a step a rank "
            f"({last['trans_a']} trans_a, {n_fwd} forward GEMMs, remat {MESH_MOE_REMAT}); "
            f"{preds[0]['count_gathers']} count all-gathers in the first step; w_gate held "
            f"{ranks[0][key]['w_gate']}, w_down {ranks[0][key]['w_down']}")
        for r in range(n):
            x, pr = ranks[r][key], preds[r]
            log(f"mesh train ({key}) rank {r}: held {x['held_gib']:.3f} GiB before its steps, "
                f"their peak {x['step_peak_gib']:.3f} GiB ({x['reserved_gib']:.3f} reserved); "
                f"the dry run predicts arguments {pr['arguments_gib']:.3f} GiB and a peak "
                f"{pr['peak_gib']:.3f} GiB (single rank's peak {single_peak:.3f} GiB)")
    # (j3)
    y = ranks[0]["j3_single_loss"]
    for key, row in ranks[0]["j3"].items():
        n = math.prod(MESH_MOE_LAYOUTS[key][0])
        if not row["grad_gap"] <= MESH_TRAIN_GRAD_RTOL:
            problems.append(f"mesh train (j3) {key}: gradients {row['grad_gap']:.3e} from the "
                            f"single rank's at {row['grad_leaf']} (bound {MESH_TRAIN_GRAD_RTOL} "
                            f"of each leaf's max)")
        others = [r["j3"][key]["loss"] for r in ranks[1:n]]
        if not abs(row["loss"] - y) <= 1e-4 * abs(y) or any(o != row["loss"] for o in others):
            problems.append(f"mesh train (j3) {key}: f32 loss {row['loss']} vs the single "
                            f"rank's {y} (1e-4 relative) and the other ranks' {others}")
        log(f"mesh train (j3) {key} f32, {MESH_MOE_F32_LAYERS} layer at full width: gradients "
            f"{row['grad_gap']:.3e} of each leaf's max from the single rank's (worst leaf "
            f"{row['grad_leaf']}); loss {row['loss']:.6f} (single {y:.6f}); "
            f"{[r['j3'][key]['dropped'] for r in ranks[:n]]} choices dropped a rank")
    return dict(layouts=summary, j3=ranks[0]["j3"], j3_single_loss=y, ranks_s=ranks_s,
                wall_s=time.time() - t0)


def _mesh_train_state(cfg, opt, mesh, dev, main_repeats=None, opened=False):
    """Seed-0 weights drawn whole on the card, this rank's shard kept
    (``model.shard_params`` with ``cfg.fsdp``; all of them without
    ``mesh``), zero moments of the shard: ``training.step.shard_state`` of
    ``init_state``, without the whole moments.  ``opened``: the zero-
    initialised leaves opened first (``_open_zero_leaves``, its own seed),
    the same on every rank and on the single rank."""
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import init_moments
    from repro_torch.training.step import TrainState
    params = _seed_params(cfg, dev, main_repeats, opened)
    if mesh is None:
        local = params
    else:
        local = M.shard_params(cfg, params, mesh, fsdp=cfg.fsdp, main_repeats=main_repeats)
    del params
    mu, nu = init_moments(local, opt)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), local, mu, nu)


def _seed_params(cfg, dev, main_repeats=None, opened=False):
    """Seed-0 weights drawn whole on the card (``model.init``); ``opened``:
    with the zero-initialised leaves opened (``_open_zero_leaves``, seed 27)."""
    from repro_torch.models import model as M
    params = M.init(cfg, 0, dev, main_repeats)
    if opened:
        _open_zero_leaves(params, torch.Generator(device=dev).manual_seed(27))
    return params


def _grad_gap(got, want) -> tuple[float, str]:
    """The largest of each leaf's max |got - want| over its max |want|,
    leaves paired by key, and that leaf's key."""
    def walk(g, w, path):
        if isinstance(w, (dict, list)):
            for k in (w if isinstance(w, dict) else range(len(w))):
                yield from walk(g[k], w[k], f"{path}/{k}" if path else str(k))
        else:
            yield (float((g.float() - w.float()).abs().max())
                   / max(float(w.float().abs().max()), 1e-30), path)
    return max(walk(got, want, ""))


def _family_batches(key):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    arch, _, B, S, _ = MESH_TRAIN_FAMILIES[key]
    data = SyntheticLM(get_config(arch), batch=B, seq=S, seed=0)
    return [data.batch_at(i) for i in range(MESH_TRAIN_FAMILY_STEPS)]


def _n_forward_gemms(cfg, main_repeats=None) -> int:
    """The bf16 GEMMs (``layers.dense_proj`` and the head) of one training
    forward: an SSD layer's w_out, attention's q / k / v / o (MLA's wq_a,
    wq_b, wkv_a, wkv_b, wo), a cross layer's self-attention and its wq /
    wk / wv / wo, a SwiGLU's three and a GELU MLP's two products, and the
    head; the SSD projections, a MoE's experts, the frontend and vision
    projections are plain products."""
    from repro_torch.models.layers import ffn_kind
    n = 1
    for stage in cfg.stages(main_repeats):
        per = 0
        for sp in stage.group:
            per += {"ssm": 1, "cross": 8}.get(sp.mixer, 5 if cfg.use_mla else 4)
            if sp.ffn == "dense":
                per += 2 if ffn_kind(cfg) == "gelu_mlp" else 3
        n += per * stage.repeats
    return n


def _timed_mesh_step(step, state, batch, mesh):
    """One train step over ``mesh`` timed on the host clock (to the loss's
    read): (state, row of loss, grad_norm, ms, the mesh's collectives and
    bytes, kernel launches and those of the GEMM with ``trans_a``)."""
    from repro_torch.kernels.block_gemm import block_gemm
    from repro_torch.kernels.ops import LAUNCH_COUNTERS
    for c in LAUNCH_COUNTERS:
        c.launches = 0
    block_gemm.trans_a_launches = 0
    c0, b0 = mesh.collectives, mesh.wire_bytes
    torch.cuda.synchronize()
    t0 = time.time()
    state, m = step(state, batch)
    loss = float(m["loss"])  # waits for the step
    return state, dict(loss=loss, grad_norm=float(m["grad_norm"]),
                       ms=(time.time() - t0) * 1e3, collectives=mesh.collectives - c0,
                       wire_bytes=mesh.wire_bytes - b0,
                       launches={c.__name__: c.launches for c in LAUNCH_COUNTERS
                                 if c.launches},
                       trans_a=block_gemm.trans_a_launches)


def _family_cfg(key, remat, dtype=torch.bfloat16):
    from repro_torch.configs import get_config
    return get_config(MESH_TRAIN_FAMILIES[key][0]).with_(remat_policy=remat,
                                                         compute_dtype=dtype)


def _held_before_step() -> tuple[int, int, int]:
    """(bytes allocated on the card just before a run of steps, the
    allocated and reserved peaks until then); the peaks restart, so
    ``max_memory_allocated`` then reads the steps' own."""
    torch.cuda.synchronize()
    held = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    torch.cuda.reset_peak_memory_stats()
    return held


def _step_memory(held: int, drawn: int, reserved: int) -> dict:
    """A run of steps' memory record in GiB: the allocated and reserved
    peaks since the state was drawn, the steps' own peak and what was held
    before them."""
    steps = torch.cuda.max_memory_allocated()
    return dict(peak_gib=max(drawn, steps) / 2 ** 30, step_peak_gib=steps / 2 ** 30,
                held_gib=held / 2 ** 30,
                reserved_gib=max(reserved, torch.cuda.max_memory_reserved()) / 2 ** 30)


def _mesh_train_rank(rank, work):
    """One rank of the mesh training phase (two ranks on ``cuda:0`` over
    gloo): (a)-(c) full olmo-1b in bf16 on each layout of
    ``MESH_TRAIN_LAYOUTS``, a row a step (loss, grad_norm, host ms, the
    mesh's collectives and bytes, block GEMM launches and those with
    ``trans_a``) and the rank's peak; (d) f32 at 2 layers: each layout's
    gathered gradients against the single rank's (rank 0 computes those
    alone first), the compressed pod mean against the exact one, 2 steps'
    losses; (e)-(h) each family of ``MESH_TRAIN_FAMILIES`` in bf16 on its
    layouts, a row a step as (a)-(c); (i) each family in f32 at 2 layers (the
    VLM one period) on its first layout: gradients and loss as (d), no
    optimizer step.  Each bf16 run also records what the rank held on the
    card before its first step and the steps' own peak.  Writes
    ``rank<r>.json`` into ``work``."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels import _build
    from repro_torch.launch.cells import prepare_arch
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.sharding import gather_whole
    from repro_torch.models import model as M
    from repro_torch.training import AdamWConfig, init_state, make_train_step
    from repro_torch.training.step import mesh_config, mesh_value_and_grad, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # the main process built them: loaded from build/
    dev = torch.device("cuda", 0)
    meshes = {k: make_device_mesh(v[0], v[1]) for k, v in MESH_TRAIN_LAYOUTS.items()}
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS, moments_dtype="f32")
    data = SyntheticLM(get_config(TRAIN), batch=TRAIN_B, seq=TRAIN_S, seed=0)
    batches = [data.batch_at(i) for i in range(3)]
    out = {"backend": meshes["a"].backend}
    for key, (shape, axes, remat, compress, n_steps, _) in MESH_TRAIN_LAYOUTS.items():
        mesh = meshes[key]
        cfg = prepare_arch(get_config(TRAIN).with_(remat_policy=remat), mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = _mesh_train_state(cfg, opt, mesh, dev)
        wq = state.params["stages"][0]["0"]["mixer"]["wq"]
        n_local = sum(t.numel() for t in tree_leaves(state.params))
        step = make_train_step(cfg, opt, mesh=mesh, compress_pod=compress)
        held = _held_before_step()
        rows = []
        for i in range(n_steps):
            state, row = _timed_mesh_step(step, state, batches[i], mesh)
            rows.append(row)
        out[key] = dict(steps=rows, **_step_memory(*held),
                        wq_local=list(wq.shape), params_local=n_local)
        del state, step, wq
    gc.collect()
    torch.cuda.empty_cache()

    # (d) f32 at 2 layers: gradients and losses against the single rank's
    cfg32 = get_config(TRAIN).with_(compute_dtype=torch.float32, remat_policy="none")
    R = MESH_TRAIN_F32_LAYERS
    b0 = to_device(batches[0], dev)
    single = None
    if rank == 0:  # the single rank, alone (no collective runs meanwhile)
        st = init_state(cfg32, opt, 0, dev, main_repeats=R)
        single = value_and_grad(cfg32, st.params, b0, main_repeats=R)[2]
        step = make_train_step(cfg32, opt, main_repeats=R)
        single_losses = []
        for i in range(2):
            st, m = step(st, batches[i])
            single_losses.append(float(m["loss"]))
        del st, step, m
        out["d_single_losses"] = single_losses
    d = {}
    for key, (shape, axes, remat, compress, _, _) in MESH_TRAIN_LAYOUTS.items():
        mesh = meshes[key]
        cfg = prepare_arch(cfg32, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        state = _mesh_train_state(cfg, opt, mesh, dev, main_repeats=R)
        pspecs = M.param_pspecs(mesh_config(cfg, mesh), mesh, fsdp=cfg.fsdp, main_repeats=R)
        _, _, g = mesh_value_and_grad(cfg, state.params, batches[0], mesh, main_repeats=R)
        whole = tree_map(lambda t, ps: gather_whole(t, mesh, ps), g, pspecs)
        row = {}
        if rank == 0:
            row["grad_gap"], row["grad_leaf"] = _grad_gap(whole, single)
        if compress:  # the int8 pod mean against the exact one, leaf by leaf
            _, _, gc_ = mesh_value_and_grad(cfg, state.params, batches[0], mesh,
                                            main_repeats=R, compress_pod=True)
            gcw = tree_map(lambda t, ps: gather_whole(t, mesh, ps), gc_, pspecs)
            row["compressed_gap"] = _grad_gap(gcw, whole)[0]
            del gc_, gcw
        del g, whole
        step = make_train_step(cfg, opt, mesh=mesh, main_repeats=R, compress_pod=compress)
        losses = []
        for i in range(2):
            state, m = step(state, batches[i])
            losses.append(float(m["loss"]))
        row["losses"] = losses
        d[key] = row
        del state, step, m
    out["d"] = d

    # (e)-(h): the other families in bf16, each layout 2 steps
    fam = {}
    for key, (arch, layouts, _, _, _) in MESH_TRAIN_FAMILIES.items():
        batches = _family_batches(key)
        R = MESH_TRAIN_FAMILY_DEPTH.get(key)
        for mkey, remat in layouts:
            mesh = meshes[mkey]
            cfg = prepare_arch(_family_cfg(key, remat), mesh)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state = _mesh_train_state(cfg, opt, mesh, dev, R, opened=True)
            n_local = sum(t.numel() for t in tree_leaves(state.params))
            step = make_train_step(cfg, opt, mesh=mesh, main_repeats=R)
            held = _held_before_step()
            rows = []
            for i in range(MESH_TRAIN_FAMILY_STEPS):
                state, row = _timed_mesh_step(step, state, batches[i], mesh)
                rows.append(row)
            fam[f"{key}/{mkey}"] = dict(
                steps=rows, **_step_memory(*held),
                params_local=n_local, depth=R, n_fwd=_n_forward_gemms(cfg, R))
            del state, step
    out["families"] = fam
    gc.collect()
    torch.cuda.empty_cache()

    # (i) each family in f32 at full width, 2 layers (the VLM one period), on
    # its first layout: the gradients and the loss of the first batch against
    # the single rank's (no optimizer step: the VLM's f32 state would not fit
    # twice beside the ranks')
    fam32 = {}
    for key, (arch, layouts, _, _, _) in MESH_TRAIN_FAMILIES.items():
        mkey = layouts[0][0]
        mesh = meshes[mkey]
        R = 1 if key == "g" else MESH_TRAIN_F32_PERIODS
        cfg = prepare_arch(_family_cfg(key, "none", torch.float32), mesh)
        batch = _family_batches(key)[0]
        single, row = None, dict(layout=mkey, depth=R)
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:  # the single rank, alone (no collective runs meanwhile)
            params = _seed_params(cfg, dev, R, opened=True)
            loss, _, single = value_and_grad(cfg, params, to_device(batch, dev), main_repeats=R)
            row["single_loss"] = float(loss)
            del params
        params = M.shard_params(cfg, _seed_params(cfg, dev, R, opened=True), mesh,
                                fsdp=cfg.fsdp, main_repeats=R)
        pspecs = M.param_pspecs(mesh_config(cfg, mesh), mesh, fsdp=cfg.fsdp, main_repeats=R)
        loss, _, g = mesh_value_and_grad(cfg, params, batch, mesh, main_repeats=R)
        row["loss"] = float(loss)
        del params
        whole = tree_map(lambda t, ps: gather_whole(t, mesh, ps), g, pspecs)
        if rank == 0:
            row["grad_gap"], row["grad_leaf"] = _grad_gap(whole, single)
        del g, whole, single
        fam32[key] = row
    out["families_f32"] = fam32
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mesh_train_phase():
    """Training over a mesh on the one card: two ranks of the port's own
    entry points on ``cuda:0`` over gloo (NCCL refuses two ranks on one
    device), full-width olmo-1b (1.280 B parameters), ``train_phase``'s 8 x
    512 tokens and AdamW settings, each rank holding its shard:

    (a) 1x2 ``"2d"`` (tensor parallel: 8 of 16 heads, an ffn of 4096, half
        the vocab a rank), 3 steps, bf16, ``remat_policy="none"``;
    (b) 2x1 with ``cfg.fsdp`` (ZeRO-3: every weight and moment cut over
        ``data``, each layer's weights gathered when it runs), 3 steps,
        bf16, ``remat_policy="full"`` (the gather runs again in the
        recompute, so a rank holds one layer's gathered weights at a time);
    (c) ``(pod, data, model) = (2, 1, 1)`` with ``compress_pod``: the int8
        pod mean, 2 steps, bf16;
    (d) f32 with the main stage cut to 2 layers at full width: each
        layout's gathered gradients within 1e-4 of each leaf's max of the
        single rank's, (c)'s compressed mean within one int8 quantum of its
        exact mean (``max |g| / 127``: a scale at most twice the mean's
        largest entry, halved by rounding), each layout's 2 losses within
        1e-4 (relative) of the single rank's.

    (e)-(h) the other families at full width in bf16, 2 steps each
        (``MESH_TRAIN_FAMILIES``, the zero-initialised leaves opened): (e)
        mamba2-130m whole at 1x2 (head-parallel SSD, 12 of 24 heads a rank)
        and 2x1 FSDP, 8 x 512; (f) minicpm3-4b (MLA) at 1x2, 4 x 512, the
        main stage cut to 35 of its 62 layers (``MESH_TRAIN_FAMILY_DEPTH``);
        (g) llama-3.2-vision-11b one period (4 self + 1 cross layer) at
        1x2, 2 x 512 tokens and 1601 stub patch
        embeddings a row, gates 0.5; (h) hubert-xlarge whole (48 layers) at
        1x2, 4 x 1000 frames, biases opened.  Each against the single rank
        in this process, gated as (a)-(c);
    (i) each family in f32 at full width, 2 layers (the VLM one period), on
        its first layout: the gathered gradients within 1e-4 of each leaf's
        max of the single rank's and the loss within 1e-4 (relative), as
        (d), on the first batch (no optimizer step);
    (j) qwen3-moe-30b-a3b at full width, ``MESH_MOE_LAYERS`` of 48 layers,
        on three ranks of their own (:func:`_mesh_moe_train`): (j1) 1x2
        ``parallel_mode="fsdp"``, one dispatch group over both ranks, and
        (j2) 1x3 ``"2d"``, each expert's FFN cut over the three ranks, bf16,
        4 x 512, 2 steps, gated as (a)-(c) against the single rank, and
        (j1) dropping choices; (j3) each in f32 at 1 layer as (i); each
        rank's peak printed beside the dry run's prediction.

    Gates (a)-(c): each step's loss finite, the same on both ranks, within
    ``MESH_TRAIN_LOSS_BOUND`` of the single rank's at that step (and
    grad_norm within ``MESH_TRAIN_GNORM_RTOL``); both ranks launched the
    block GEMM forward and with ``trans_a``: 3 launches a forward GEMM a
    step (``full``: 4 inside a layer group), one of them ``trans_a``.  Then
    the GEMM at the shards' training shapes (``MESH_TRAIN_GEMMS``).  Times of
    two ranks sharing one card over gloo (every collective through host
    memory) are not multi-GPU scaling numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dist as D
    from repro_torch.training import AdamWConfig, init_state, make_train_step
    os.makedirs(MESH_TRAIN_WORK, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.time()
    # the single rank's bf16 steps, in this process, freed before the ranks start
    cfg = get_config(TRAIN).with_(remat_policy="none")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS, moments_dtype="f32")
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=0)
    state = init_state(cfg, opt, seed=0, device="cuda")
    step = make_train_step(cfg, opt)
    single, single_ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        state, m = step(state, data.batch_at(i))
        single.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
        single_ms.append((time.time() - t0) * 1e3)
    del state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    # what this process still holds while the two ranks share the card with it
    held = (torch.cuda.memory_allocated() / 2 ** 30, torch.cuda.memory_reserved() / 2 ** 30)
    free, total = (x / 2 ** 30 for x in torch.cuda.mem_get_info())
    log(f"mesh train: the main process holds {held[0]:.2f} GiB ({held[1]:.2f} reserved) when the "
        f"ranks start; {free:.2f} of {total:.2f} GiB free on the card")
    # the ranks' allocator grows its segments in place: with fixed segments a
    # rank reserved about a third more than its peak at (c) (split blocks
    # that no later request fits), and two ranks beside this process then
    # filled the card
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.time()
    try:
        D.spawn(_mesh_train_rank, 2, "gloo", args=(MESH_TRAIN_WORK,))
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    ranks_s = time.time() - t0
    ranks = [json.load(open(os.path.join(MESH_TRAIN_WORK, f"rank{r}.json"))) for r in range(2)]
    # the single rank of each family (e)-(h), bf16, each freed before the
    # next, after the ranks have left the card
    fam_single = {}
    for key, (_, layouts, _, _, _) in MESH_TRAIN_FAMILIES.items():
        R = MESH_TRAIN_FAMILY_DEPTH.get(key)
        fcfg = _family_cfg(key, layouts[0][1])
        torch.cuda.reset_peak_memory_stats()
        state = _mesh_train_state(fcfg, opt, None, torch.device("cuda", 0), R, opened=True)
        step = make_train_step(fcfg, opt, main_repeats=R)
        rows = []
        for batch in _family_batches(key):
            torch.cuda.synchronize()
            t0 = time.time()
            state, m = step(state, batch)
            rows.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                             ms=(time.time() - t0) * 1e3))
        fam_single[key] = dict(steps=rows, depth=R,
                               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del state, step, m
        gc.collect()
        torch.cuda.empty_cache()
    problems = []
    n_fwd = 16 * 7 + 1  # q, k, v, o, gate, up, down a layer, and the head
    summary = {}
    for key, (shape, _, remat, compress, n_steps, what) in MESH_TRAIN_LAYOUTS.items():
        rows = [r[key]["steps"] for r in ranks]
        _mesh_train_gates(key, rows, single, remat, n_fwd, problems)
        ms = [statistics.median(x["ms"] for x in r_[1:] or r_) for r_ in rows]
        summary[key] = dict(
            what=what, step_ms_median=ms, step_ms_all=[[x["ms"] for x in r_] for r_ in rows],
            losses=[x["loss"] for x in rows[0]], single_losses=[s["loss"] for s in single[:n_steps]],
            grad_norms=[x["grad_norm"] for x in rows[0]],
            single_grad_norms=[s["grad_norm"] for s in single[:n_steps]],
            collectives_per_step=[x["collectives"] for x in rows[0]],
            wire_bytes_per_step=[x["wire_bytes"] for x in rows[0]],
            peak_gib=[r[key]["peak_gib"] for r in ranks],
            step_peak_gib=[r[key]["step_peak_gib"] for r in ranks],
            held_gib=[r[key]["held_gib"] for r in ranks],
            reserved_gib=[r[key]["reserved_gib"] for r in ranks],
            gemm_launches_per_step=[[x["launches"].get("block_gemm", 0) for x in r_]
                                    for r_ in rows],
            trans_a_per_step=[[x["trans_a"] for x in r_] for r_ in rows],
            wq_local=ranks[0][key]["wq_local"], params_local=ranks[0][key]["params_local"])
        extra = ""
        if compress:
            n = ranks[0][key]["params_local"]
            extra = (f"; the int8 pod mean gathers {n:,} bytes a rank a step, where an f32 "
                     f"mean would all-reduce {4 * n:,}")
            summary[key].update(int8_payload_bytes=n, f32_payload_bytes=4 * n)
        log(f"mesh train ({key}) {what}, two ranks on one card over gloo (not a scaling number): "
            f"step {ms[0]:.1f} / {ms[1]:.1f} ms a rank (median of steps 2-{n_steps}; all: "
            + ", ".join(f"{x['ms']:.1f}" for x in rows[0])
            + f"); single rank {statistics.median(single_ms[1:]):.1f} ms; losses "
            + ", ".join(f"{x['loss']:.5f}" for x in rows[0]) + " (single rank "
            + ", ".join(f"{s['loss']:.5f}" for s in single[:n_steps]) + ")")
        log(f"mesh train ({key}): {rows[0][-1]['collectives']} collectives and "
            f"{rows[0][-1]['wire_bytes'] / 1e9:.3f} GB handed to them a step a rank{extra}; peak "
            f"{ranks[0][key]['peak_gib']:.2f} / {ranks[1][key]['peak_gib']:.2f} GiB a rank "
            f"({ranks[0][key]['reserved_gib']:.2f} / {ranks[1][key]['reserved_gib']:.2f} "
            f"reserved); "
            f"block_gemm {rows[0][-1]['launches'].get('block_gemm', 0)} launches a step a rank "
            f"({rows[0][-1]['trans_a']} trans_a); wq held {ranks[0][key]['wq_local']}")
    # (d)
    sl = ranks[0]["d_single_losses"]
    for key, row in ranks[0]["d"].items():
        if not row["grad_gap"] <= MESH_TRAIN_GRAD_RTOL:
            problems.append(f"mesh train (d) {key}: gradients {row['grad_gap']:.3e} from the "
                            f"single rank's at {row['grad_leaf']} (bound {MESH_TRAIN_GRAD_RTOL} "
                            f"of each leaf's max)")
        if "compressed_gap" in row and not row["compressed_gap"] <= 1 / 127:
            problems.append(f"mesh train (d) {key}: the int8 pod mean {row['compressed_gap']:.3e} "
                            f"from the exact mean (bound 1/127 of each leaf's max)")
        for i, (x, y) in enumerate(zip(row["losses"], sl)):
            if not abs(x - y) <= 1e-4 * abs(y) or x != ranks[1]["d"][key]["losses"][i]:
                problems.append(f"mesh train (d) {key} step {i}: f32 loss {x} vs the single "
                                f"rank's {y} (1e-4 relative) and rank 1's "
                                f"{ranks[1]['d'][key]['losses'][i]}")
        log(f"mesh train (d) {key} f32, {MESH_TRAIN_F32_LAYERS} layers at full width: gradients "
            f"{row['grad_gap']:.3e} of each leaf's max from the single rank's (worst leaf "
            f"{row['grad_leaf']})"
            + (f", the int8 pod mean {row['compressed_gap']:.3e} from the exact mean"
               if "compressed_gap" in row else "")
            + f"; losses " + ", ".join(f"{x:.6f}" for x in row["losses"])
            + " (single " + ", ".join(f"{y:.6f}" for y in sl) + ")")
    # (e)-(h)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    families = {}
    for fk, frow in ranks[0]["families"].items():
        key, mkey = fk.split("/")
        remat = dict(MESH_TRAIN_FAMILIES[key][1])[mkey]
        rows = [r["families"][fk]["steps"] for r in ranks]
        fs = fam_single[key]
        _mesh_train_gates(f"{key} {mkey}", rows, fs["steps"], remat, frow["n_fwd"], problems)
        ms = [statistics.median(x["ms"] for x in r_[1:] or r_) for r_ in rows]
        last = rows[0][-1]
        families[fk] = dict(
            what=MESH_TRAIN_FAMILIES[key][4], layout=MESH_TRAIN_LAYOUTS[mkey][5], remat=remat,
            depth=frow["depth"], step_ms_median=ms, step_ms_all=[[x["ms"] for x in r_] for r_ in rows],
            losses=[x["loss"] for x in rows[0]], single_losses=[x["loss"] for x in fs["steps"]],
            grad_norms=[x["grad_norm"] for x in rows[0]],
            single_grad_norms=[x["grad_norm"] for x in fs["steps"]],
            single_step_ms=[x["ms"] for x in fs["steps"]], single_peak_gib=fs["peak_gib"],
            collectives_per_step=[x["collectives"] for x in rows[0]],
            wire_bytes_per_step=[x["wire_bytes"] for x in rows[0]],
            peak_gib=[r["families"][fk]["peak_gib"] for r in ranks],
            step_peak_gib=[r["families"][fk]["step_peak_gib"] for r in ranks],
            held_gib=[r["families"][fk]["held_gib"] for r in ranks],
            reserved_gib=[r["families"][fk]["reserved_gib"] for r in ranks],
            gemm_launches_per_step=[[x["launches"].get("block_gemm", 0) for x in r_]
                                    for r_ in rows],
            trans_a_per_step=[[x["trans_a"] for x in r_] for r_ in rows],
            n_fwd=frow["n_fwd"], params_local=frow["params_local"], card=smi)
        log(f"mesh train ({key}) {families[fk]['what']} at {mkey} ({families[fk]['layout']}, "
            f"remat {remat}, depth {frow['depth'] or 'whole'}), two ranks on one card over gloo "
            f"(not a scaling number; {smi}): step {ms[0]:.1f} / {ms[1]:.1f} ms a rank (step 2; "
            f"all: " + ", ".join(f"{x['ms']:.1f}" for x in rows[0]) + f"); single rank "
            + ", ".join(f"{x['ms']:.1f}" for x in fs["steps"]) + " ms; losses "
            + ", ".join(f"{x['loss']:.5f}" for x in rows[0]) + " (single rank "
            + ", ".join(f"{x['loss']:.5f}" for x in fs["steps"]) + ")")
        log(f"mesh train ({key}) {mkey}: {last['collectives']} collectives and "
            f"{last['wire_bytes'] / 1e9:.3f} GB handed to them a step a rank; peak "
            f"{families[fk]['peak_gib'][0]:.2f} / {families[fk]['peak_gib'][1]:.2f} GiB a rank "
            f"({families[fk]['reserved_gib'][0]:.2f} / {families[fk]['reserved_gib'][1]:.2f} "
            f"reserved; single rank {fs['peak_gib']:.2f} GiB); block_gemm "
            f"{last['launches'].get('block_gemm', 0)} launches a step a rank ({last['trans_a']} "
            f"trans_a, {frow['n_fwd']} forward GEMMs); {frow['params_local']:,} parameters held "
            f"a rank")
    # (i)
    for key, row in ranks[0]["families_f32"].items():
        other = ranks[1]["families_f32"][key]["loss"]
        if not row["grad_gap"] <= MESH_TRAIN_GRAD_RTOL:
            problems.append(f"mesh train (i) {key}: gradients {row['grad_gap']:.3e} from the "
                            f"single rank's at {row['grad_leaf']} (bound {MESH_TRAIN_GRAD_RTOL} "
                            f"of each leaf's max)")
        x, y = row["loss"], row["single_loss"]
        if not abs(x - y) <= 1e-4 * abs(y) or x != other:
            problems.append(f"mesh train (i) {key}: f32 loss {x} vs the single rank's {y} "
                            f"(1e-4 relative) and rank 1's {other}")
        log(f"mesh train (i) {key} f32 at {row['layout']}, {row['depth']} "
            f"{'period' if key == 'g' else 'layers'} at full width: gradients "
            f"{row['grad_gap']:.3e} of each leaf's max from the single rank's (worst leaf "
            f"{row['grad_leaf']}); loss {x:.6f} "
            f"(single {y:.6f})")
    # (j) qwen3-moe over the MoE meshes: three ranks of their own
    moe = _mesh_moe_train(opt, problems)
    if problems:
        fail("; ".join(problems))
    flush = L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(24)
    cases = [c for T, kns in MESH_TRAIN_GEMMS for c in _train_gemm_cases(T, kns)]
    err, gemm_rows = _gemm_case_rows(cases, flush, gen, "mesh shard")
    for key, groups in MESH_TRAIN_FAMILY_GEMMS.items():
        cases = [c for T, kns, head in groups for c in _train_gemm_cases(T, kns, head or -1)]
        ferr, frows = _gemm_case_rows(cases, flush, gen, f"mesh shard ({key})")
        launches = sum(row["launches"].get("block_gemm", 0) for fk in families
                       if fk.startswith(key + "/") for row in ranks[0]["families"][fk]["steps"])
        gemm_rows += [dict(row, family=key, launches=launches) for row in frows]
        err = max(err, ferr)
    del flush
    launches = sum(sum(x) for key in summary for x in summary[key]["gemm_launches_per_step"][:1])
    wall = time.time() - t_phase
    log(f"mesh train phase: {wall:.1f} s (the ranks {ranks_s:.1f} s; backend "
        f"{ranks[0]['backend']}, both ranks on cuda:0)")
    return dict(layouts=summary, d=ranks[0]["d"], d_single_losses=sl, single_step_ms=single_ms,
                families=families, families_f32=ranks[0]["families_f32"], moe=moe,
                gemm_rows=gemm_rows, gemm_max_abs_err=err, block_gemm_launches_rank0=launches,
                ranks_s=ranks_s, wall_s=wall)


def _mesh_train_gates(key, rows, single, remat, n_fwd, problems):
    """A bf16 layout's gates: each step's loss finite, the same on every
    rank and within ``MESH_TRAIN_LOSS_BOUND`` of the single rank's,
    grad_norm within ``MESH_TRAIN_GNORM_RTOL``; on each rank 3 block GEMM
    launches a forward GEMM a step (``full`` remat: 4 inside a layer group;
    the head's 3), ``n_fwd`` of them ``trans_a``, no other kernel (no
    attention kernel under autograd).  ``rows``: each rank's step rows."""
    per_gemm = 4 if remat == "full" else 3
    want_gemm = per_gemm * (n_fwd - 1) + 3
    for i in range(len(rows[0])):
        a, s = rows[0][i], single[i]
        losses = [r_[i]["loss"] for r_ in rows]
        if not math.isfinite(a["loss"]) or any(x != a["loss"] for x in losses):
            problems.append(f"mesh train ({key}) step {i}: losses {losses} (finite, equal on "
                            f"every rank)")
        if abs(a["loss"] - s["loss"]) > MESH_TRAIN_LOSS_BOUND:
            problems.append(f"mesh train ({key}) step {i}: loss {a['loss']:.6f} vs the single "
                            f"rank's {s['loss']:.6f} (bound {MESH_TRAIN_LOSS_BOUND})")
        if abs(a["grad_norm"] - s["grad_norm"]) > MESH_TRAIN_GNORM_RTOL * s["grad_norm"]:
            problems.append(f"mesh train ({key}) step {i}: grad_norm {a['grad_norm']:.6f} vs "
                            f"{s['grad_norm']:.6f} (relative bound {MESH_TRAIN_GNORM_RTOL})")
        for r, row in enumerate(r_[i] for r_ in rows):
            got = row["launches"].get("block_gemm", 0)
            if got != want_gemm or row["trans_a"] != n_fwd or set(row["launches"]) != {
                    "block_gemm"}:
                problems.append(f"mesh train ({key}) rank {r} step {i}: launches "
                                f"{row['launches']}, trans_a {row['trans_a']} (want "
                                f"block_gemm {want_gemm}, trans_a {n_fwd}, nothing else)")


# ---------------------------------------------------------------------------
# phase 10: the pod-scale dry run (launch/dryrun.py) held against the card
# ---------------------------------------------------------------------------

DRY_PEAK_RTOL = 0.10  # (a): the predicted peak of a step against the card's, relative
DRY_ACT_RTOL = 0.02  # (a): a forward + backward's peak above the state, relative
# (d): production cells printed from the 16x16 dry mesh (the full-depth pass)
DRY_CELLS = tuple((a, s) for a in ("olmo-1b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
                                   "jamba-v0.1-52b") for s in ("train_4k", "decode_32k"))


def dryrun_phase(train, options, mesh_train, vlm):
    """The dry run (``launch.cells.build_cell`` on meta tensors, counted by
    ``launch.dry_costs.DryCounter`` over a ``launch.mesh.DryMesh``: nothing
    allocated on any device) held against what this script measured on the
    card:

    (a) the training phase's own cell -- full olmo-1b, ``TRAIN_B`` x
        ``TRAIN_S`` tokens, ``remat_policy="none"``, f32 moments, one device:
        the predicted peak within ``DRY_PEAK_RTOL`` of that phase's
        ``max_memory_allocated``, the predicted block GEMM calls equal to its
        launches a step; and, under each ``REMAT`` policy, the predicted peak
        of a forward + backward alone above the parameters (the activations
        autograd saves, the recompute, the gradients) within
        ``DRY_ACT_RTOL`` of ``train_options_phase``'s measured peak above
        the state;
    (b) ``mesh_train_phase``'s (a) (full olmo-1b at 1x2) and (e) (mamba2-130m
        at 1x2 and 2x1 FSDP under ``full``) on dry meshes of their shapes:
        collectives and wire bytes a step of rank 0 equal to the ones measured
        at every step, exactly; the predicted arguments and a step's peak
        above them printed beside what each rank held before its steps and
        the steps' peak (not gated);
    (c) ``vlm_phase``'s bf16 decode step (llama-3.2-vision-11b, B 2, slot
        caches of ``VLM_CACHE`` rows): each kernel's predicted calls equal to
        its launches a replay;
    (d) ``DRY_CELLS`` on the 16x16 production mesh (full depth, no roofline
        passes, to keep the phase short): each record printed;
    (e) :func:`dry_fsdp_moe_cell`: qwen3-moe-30b-a3b ``train_4k`` under
        ``parallel_mode="fsdp"``, its dispatch groups over ranks, gathering
        their counts.

    A miss fails the run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dry_costs import DryCounter
    from repro_torch.launch.dryrun import count, run_cell, status
    from repro_torch.launch.mesh import DryMesh, dry_production_mesh
    from repro_torch.training import AdamWConfig
    from repro_torch.training.step import value_and_grad
    t_phase = time.time()
    problems, out = [], {}
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS, moments_dtype="f32")
    one = ("data", "model")
    # (a)
    cfg = get_config(TRAIN).with_(remat_policy="none")
    c = count(build_cell(cfg, ShapeConfig("train", TRAIN_S, TRAIN_B, "train"),
                         DryMesh((1, 1), one), opt=opt))
    meas = train["f32"]["peak_gib"]
    pred = c.peak / 2 ** 30
    calls = dict(c.kernel_calls)
    want = {"block_gemm": train["f32"]["gemm_launches_per_step"]}
    out["a"] = dict(predicted_peak_gib=pred, measured_peak_gib=meas, rel=pred / meas - 1,
                    predicted_calls=calls, measured_launches=want, memory=c.memory())
    if not abs(pred - meas) <= DRY_PEAK_RTOL * meas:
        problems.append(f"(a) predicted peak {pred:.3f} GiB vs measured {meas:.3f} GiB "
                        f"(bound {DRY_PEAK_RTOL:.0%})")
    if calls != want:
        problems.append(f"(a) predicted kernel calls {calls} vs launches a step {want}")
    log(f"dry run (a) {TRAIN} train {TRAIN_B} x {TRAIN_S}, one device: predicted peak "
        f"{pred:.3f} GiB vs measured {meas:.3f} GiB ({pred / meas - 1:+.2%}); predicted "
        f"{calls} vs {want} launches a step")
    # (a) the activations: a forward + backward alone, as _policy_run measures it
    for policy in REMAT:
        cell = build_cell(get_config(TRAIN).with_(remat_policy=policy),
                          ShapeConfig("train", TRAIN_S, TRAIN_B, "train"), DryMesh((1, 1), one))
        state, batch = cell.args
        c = DryCounter()
        c.arguments(state.params)
        with c:
            value_and_grad(cell.cfg, state.params, batch)
        pred = (c.peak - c.argument_bytes) / 2 ** 30
        meas = options[policy]["grad_peak_above_state_gib"]
        out[f"a/{policy}"] = dict(predicted_gib=pred, measured_gib=meas, rel=pred / meas - 1)
        if not abs(pred - meas) <= DRY_ACT_RTOL * meas:
            problems.append(f"(a) {policy}: predicted forward + backward peak {pred:.3f} GiB "
                            f"above the parameters vs measured {meas:.3f} GiB above the state "
                            f"(bound {DRY_ACT_RTOL:.0%})")
        log(f"dry run (a) {TRAIN} forward + backward {TRAIN_B} x {TRAIN_S}, remat {policy}: "
            f"predicted {pred:.3f} GiB above the parameters vs measured {meas:.3f} GiB above "
            f"the state ({pred / meas - 1:+.2%})")
    # (b) (family key or None for olmo-1b, layout key, the measured rows)
    cases = {"a": (None, "a", mesh_train["layouts"]["a"]),
             "e/a": ("e", "a", mesh_train["families"]["e/a"]),
             "e/b": ("e", "b", mesh_train["families"]["e/b"])}
    for key, (fam, lay, row) in cases.items():
        shape, axes, remat = MESH_TRAIN_LAYOUTS[lay][:3]
        arch, B, S = TRAIN, TRAIN_B, TRAIN_S
        if fam:
            arch, _, B, S = MESH_TRAIN_FAMILIES[fam][:4]
            remat = dict(MESH_TRAIN_FAMILIES[fam][1])[lay]
        m = DryMesh(shape, axes)
        c = count(build_cell(get_config(arch).with_(remat_policy=remat),
                             ShapeConfig("train", S, B, "train"), m, opt=opt))
        got = [m.collectives, m.wire_bytes]
        steps = [list(x) for x in zip(row["collectives_per_step"], row["wire_bytes_per_step"])]
        args, peak = c.argument_bytes / 2 ** 30, c.peak / 2 ** 30
        above = [p - h for p, h in zip(row["step_peak_gib"], row["held_gib"])]
        out[f"b/{key}"] = dict(predicted=got, measured=steps, predicted_arguments_gib=args,
                               predicted_peak_gib=peak, held_gib=row["held_gib"],
                               step_peak_gib=row["step_peak_gib"],
                               predicted_above_gib=peak - args, measured_above_gib=above)
        if any(x != got for x in steps):
            problems.append(f"(b) {key}: predicted {got} collectives and bytes a step, "
                            f"measured {steps}")
        log(f"dry run (b) {key} {arch} {shape} remat {remat}: predicted {got[0]} collectives "
            f"and {got[1]:,} bytes a step a rank; measured {steps}")
        log(f"dry run (b) {key} memory (not gated): predicted arguments {args:.3f} GiB and a "
            f"peak {peak:.3f} GiB ({peak - args:.3f} above them); ranks 0 / 1 held "
            + " / ".join(f"{h:.3f}" for h in row["held_gib"]) + " GiB before their steps, "
            "whose peak was " + " / ".join(f"{p:.3f}" for p in row["step_peak_gib"])
            + " GiB (" + " / ".join(f"{a:.3f}" for a in above) + " above)")
    # (c)
    c = count(build_cell(get_config(VLM), ShapeConfig("decode", VLM_CACHE, VLM_B, "decode"),
                         DryMesh((1, 1), one)))
    calls, want = dict(c.kernel_calls), vlm["vlm"]["bf16"]["per_replay"]
    out["c"] = dict(predicted=calls, measured=want)
    if calls != want:
        problems.append(f"(c) {VLM} decode step: predicted {calls}, launched {want}")
    log(f"dry run (c) {VLM} bf16 decode step, B {VLM_B}, slot caches of {VLM_CACHE}: "
        f"predicted {calls}; launched a replay {want}")
    # (d)
    mesh = dry_production_mesh()
    for arch, shape in DRY_CELLS:
        t0 = time.time()
        rec = run_cell(arch, shape, mesh, "pod16x16", overrides={}, opt=AdamWConfig(),
                       do_roofline=False)
        log(f"dry run (d) [{time.time() - t0:.1f} s] {arch} {shape} {status(rec)}")
        log(json.dumps({"dryrun_cell": rec}))
    out["e"] = dry_fsdp_moe_cell(problems)
    out["wall_s"] = time.time() - t_phase
    if problems:
        fail("dry run: " + "; ".join(problems))
    return out


def dry_fsdp_moe_cell(problems) -> dict:
    """Dry run (e): full qwen3-moe-30b-a3b ``train_4k`` under
    ``parallel_mode="fsdp"`` on the 16x16 mesh (full depth, no roofline
    passes), where its 16 dispatch groups each span a model line of 16
    ranks: the record printed, and each MoE layer's forward (and its
    recompute) all-gathers the rank's int32 counts [1, k, E] over model
    (the group's line) alone, in the mesh's collective records."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import count
    from repro_torch.launch.mesh import dry_production_mesh
    t0 = time.time()
    cfg = get_config("qwen3-moe-30b-a3b").with_(parallel_mode="fsdp")
    mesh = dry_production_mesh()
    c = count(build_cell(cfg, SHAPES["train_4k"], mesh, attn_chunk=2048))
    n = cfg.experts_per_token * cfg.num_experts * 4
    recs = mesh.records
    pairs = sum(x == ("all-gather", "model", 16, n) for x in recs)
    want = cfg.num_layers * (2 if cfg.remat_policy == "full" else 1)
    if pairs != want:
        problems.append(f"(e) qwen3-moe-30b-a3b train_4k fsdp: {pairs} count all-gathers "
                        f"(over model, {n} bytes a rank), want {want}")
    rec = dict(memory=c.memory(), kernel_calls=dict(c.kernel_calls),
               collectives=RL.collective_bytes(recs), count_gathers=pairs,
               mesh_counts={"collectives": mesh.collectives, "wire_bytes": mesh.wire_bytes})
    log(f"dry run (e) [{time.time() - t0:.1f} s] qwen3-moe-30b-a3b train_4k "
        f"parallel_mode=fsdp on 16x16: peak {rec['memory']['peak_per_device_gib']} GiB a "
        f"device, {pairs} count all-gathers of {n} bytes (want {want}), "
        f"{mesh.collectives} collectives and {mesh.wire_bytes:,} bytes a rank a step")
    log(json.dumps({"dryrun_cell": dict(rec, arch="qwen3-moe-30b-a3b", shape="train_4k",
                                        overrides={"parallel_mode": "fsdp"})}))
    return rec


# ---------------------------------------------------------------------------
# phase 11: the static analysis on the card (repro_torch.analysis)
# ---------------------------------------------------------------------------

def _nan_unread(t, rows_read, n_rows):
    """``t`` (rows first, [n_rows, ...]) with every row not in ``rows_read``
    set to NaN: a kernel that read one would turn its output non-finite."""
    keep = torch.zeros(n_rows, dtype=torch.bool, device=t.device)
    if rows_read:
        keep[torch.tensor(sorted(rows_read), device=t.device)] = True
    out = t.clone()
    out.view(n_rows, -1)[~keep] = float("nan")
    return out, int((~keep).sum())


def _sentinel_rows(spec, fill, op=1):
    from repro_torch.analysis.bounds import read_rows
    rows = set()
    for r in read_rows(spec, fill, op).values():
        rows |= r
    return rows


def sentinel_phase(gen):
    """The four attention routes with every row the bounds prover says is
    unread -- the pools' trash and spare pages, the rows of a slot outside
    [start, pos], a frozen slot's row S, the keys below a window's first
    tile -- filled with NaN, at hostile scalars (frozen, drained and empty
    slots): every output must be finite and equal to the plain version on
    the clean inputs.  Returns one summary per case."""
    from repro_torch.kernels import decode_attention as DA, flash_attention as FA, ref
    out = []

    def held(name, got, want, dtype, nan_rows):
        err, rel = check_attn(name, got, want, dtype)
        out.append(dict(case=name, nan_rows=nan_rows, max_abs_err=err, max_row_rel=rel))
        log(f"  sentinel {name}: {nan_rows} unread rows NaN, output finite, max_abs_err "
            f"{err:.3e}" + (f", row rel {rel:.3e}" if dtype == torch.bfloat16 else ""))

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        # slot caches, linear and ring: a live, a frozen (pos == S), a drained slot
        B, H, K, S, d = 3, 8, 4, 320, 128
        q = torch.randn(B, H, d, generator=gen, device="cuda").to(dtype)
        for layout, pos, start in (("linear", [200, S, 5], [37, 100, 90]),
                                   ("ring", [700, S - 1, 3], [300, 0, 9])):
            k = torch.randn(B * S, K, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(B * S, K, d, generator=gen, device="cuda").to(dtype)
            spec = DA.fd_dense_spec(B, H, K, S, d, d, layout=layout)
            fill = {"pos": np.array(pos), "start": np.array(start)}
            kn, n = _nan_unread(k, _sentinel_rows(spec, fill, 1), B * S)
            vn, _ = _nan_unread(v, _sentinel_rows(spec, fill, 2), B * S)
            p_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            s_t = torch.tensor(start, dtype=torch.int32, device="cuda")
            got = DA.flash_decode(q, kn.view(B, S, K, d), vn.view(B, S, K, d), p_t, s_t,
                                  layout=layout)
            want = ref.flash_decode_ref(q, k.view(B, S, K, d), v.view(B, S, K, d), p_t, s_t,
                                        layout=layout)
            held(f"slot {layout} {dn}", got, want, dtype, n)
        # pools: the engine's shape (olmo-1b, 16 heads, d 128, page 64 of 1024
        # rows) and MLA's latent call (40 heads over one, dq 288, dv 256, v is k)
        for name, (H, K, dq, dv, ps, npp) in (("engine", (16, 16, 128, 128, 64, 16)),
                                               ("mla", (40, 1, 288, 256, 16, 64))):
            B, P = 8, 8 * npp + 1
            q = torch.randn(B, H, dq, generator=gen, device="cuda").to(dtype)
            kv = torch.randn(P * ps, K, dq, generator=gen, device="cuda").to(dtype)
            pages = _tables(B, npp, P, 11)
            S = npp * ps
            pos = [S, 0, 100, S - 1, 37, 500 % S, 64, 3]
            start = [0, 5, 90, 0, 37, 0, 65, 0]
            spec = DA.fd_paged_spec(B, H, K, dq, dv, ps, npp, P, v_row=dq)
            fill = {"pos": np.array(pos), "start": np.array(start),
                    "pages": pages.cpu().numpy()}
            rows = _sentinel_rows(spec, fill, 1) | _sentinel_rows(spec, fill, 2)
            kvn, n = _nan_unread(kv, rows, P * ps)
            p_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            s_t = torch.tensor(start, dtype=torch.int32, device="cuda")
            pool, clean = kvn.view(P, ps, K, dq), kv.view(P, ps, K, dq)
            got = DA.flash_decode_paged(q, pool, pool, p_t, s_t, pages, dv=dv)
            want = ref.flash_decode_ref(q, clean, clean, p_t, s_t, pages=pages, dv=dv)
            held(f"paged decode {name} {dn}", got, want, dtype, n)
        # paged chunk: 64 rows over 1024 (bf16: 8 pieces), a normal, an empty,
        # a chunk whose keys run past its horizon and one at the table's end
        B, H, K, C, d, ps, npp = 4, 16, 16, 64, 128, 64, 16
        P, S = B * npp + 1, npp * ps
        q = torch.randn(B, H, C, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(P * ps, K, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(P * ps, K, d, generator=gen, device="cuda").to(dtype)
        pages = _tables(B, npp, P, 12)
        qs, kl = [448, 0, 100, S - C], [512, 0, 700, S]
        spec = FA.fa_paged_spec(B, H, K, C, d, ps, npp, P, dtype=dtype)
        fill = {"q_start": np.array(qs), "k_len": np.array(kl), "pages": pages.cpu().numpy()}
        kn, n = _nan_unread(k, _sentinel_rows(spec, fill, 1), P * ps)
        vn, _ = _nan_unread(v, _sentinel_rows(spec, fill, 2), P * ps)
        q_t = torch.tensor(qs, dtype=torch.int32, device="cuda")
        k_t = torch.tensor(kl, dtype=torch.int32, device="cuda")
        got = FA.flash_attention_paged(q, kn.view(P, ps, K, d), vn.view(P, ps, K, d), pages,
                                       q_t, k_t)
        want = ref.flash_attention_paged_ref(q, k.view(P, ps, K, d), v.view(P, ps, K, d),
                                             pages, q_t, k_t)
        held(f"paged chunk {dn}" + (" split" if dtype == torch.bfloat16 else ""), got, want,
             dtype, n)
        # dense with a window: 64 queries at the end of 512 keys, window 100
        B, H, K, Sq, Sk, d, W = 2, 8, 4, 64, 512, 128, 100
        q = torch.randn(B, H, Sq, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B * K * Sk, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B * K * Sk, d, generator=gen, device="cuda").to(dtype)
        spec = FA.fa_dense_spec(B, H, K, Sq, Sk, d, window=W, dtype=dtype)
        kn, n = _nan_unread(k, _sentinel_rows(spec, {}, 1), B * K * Sk)
        vn, _ = _nan_unread(v, _sentinel_rows(spec, {}, 2), B * K * Sk)
        got = FA.flash_attention(q, kn.view(B, K, Sk, d), vn.view(B, K, Sk, d), window=W)
        want = ref.flash_attention_ref(q, k.view(B, K, Sk, d), v.view(B, K, Sk, d), window=W)
        held(f"dense window {dn}", got, want, dtype, n)
    return out


def analysis_phase(gen):
    """``repro_torch.analysis`` on the card: ``run_analysis(modes=("cuda",))``
    over every config x quant (the entries on the card under
    ``torch.cuda.set_sync_debug_mode``, each tick's one device -> host
    copy, the kernels' bounds proofs through the host library built by the
    host compiler, the mesh entries, paging, resilience on the card) must
    report no finding; then :func:`sentinel_phase`."""
    from repro_torch.analysis import Report, run_analysis
    from repro_torch.analysis import runner as AR
    from repro_torch.kernels import _build
    t0 = time.time()
    lib = _build.host_library()
    # the card's own J003 checks must see a host read: a device -> host
    # read inside an entry, and a tick with a second copy
    canary = Report()
    x = torch.ones(4, device="cuda")
    AR._lint_entry(canary, lambda: x.sum().item(), "canary", "cuda", sync=True)
    AR._tick_copies(canary, lambda: (x.cpu(), x.sum().cpu()), "canary tick")
    msgs = [f.message for f in canary.findings if f.rule == "J003"]
    if not any("synchronising call" in m for m in msgs) or not any(
            "_local_scalar_dense" in m for m in msgs) or not any("2 device" in m for m in msgs):
        fail(f"analysis canary: the card's J003 checks missed a host read: {msgs}")
    log(f"analysis canary: {len(msgs)} J003 findings on a seeded host read, as expected")
    report = run_analysis(modes=("cuda",))
    for f in report.findings:
        log(f"  analysis finding: {f}")
    if report.findings:
        fail(f"analysis on the card: {len(report.findings)} findings")
    wall = time.time() - t0
    log(f"analysis (cuda): {len(report.checked)} surfaces checked, 0 findings, "
        f"{wall:.1f} s (host library {lib._name})")
    sentinel = sentinel_phase(gen)
    return dict(surfaces=len(report.checked), findings=0, analysis_s=wall,
                sentinel=sentinel, wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# kernel rows of several trees in one call (``--kernel-rows``)
# ---------------------------------------------------------------------------

KERNEL_ROW_PHASES = ("gemm_phase", "int8_phase", "quantize_phase", "rowpar_kernel_phase",
                     "dense_attention_phase", "slot_decode_phase", "decode_phase",
                     "chunk_phase")


def _kernel_rows_child(tree: str) -> None:
    """In a fresh process: build the kernels of checkout ``tree``, run its
    own ``chip_smoke.py``'s kernel phases (phase 2's six kernels and the
    added ones) and print one JSON line ``KERNEL_ROWS`` of every row's
    times and each kernel's ptxas registers and spills."""
    import importlib.util
    sys.path.insert(0, os.path.join(tree, "src"))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    res = {k: v for n in ("flash_attention", "block_gemm", "block_gemm_int8",
                          "decode_attention", "quantize")
           for k, v in _build.resources(n).items()}
    flush = cs.L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    for ph in KERNEL_ROW_PHASES:
        got = getattr(cs, ph)(flush, gen)
        got = got[1] if isinstance(got, tuple) else got
        if isinstance(got, dict) and "ms" not in got:  # rowpar: {name: rows}
            items = got.items()
        else:
            items = [(ph, got if isinstance(got, list) else [got])]
        for name, rs in items:
            for r in rs:
                if isinstance(r, dict) and "ms" in r:
                    rows[f"{name} | {r.get('shape', '')}"] = r["ms"]
    print("KERNEL_ROWS " + json.dumps({"tree": tree, "rows": rows, "ptxas": res}),
          flush=True)


def kernel_rows(trees) -> dict:
    """The kernel rows of each checkout in ``trees`` (run in that order,
    each in a process of its own, on this one card), and each row's ratio
    of the mean over the later trees to the mean over the first one's
    runs: ``python3 chip_smoke.py --kernel-rows PARENT CHANGE CHANGE
    PARENT`` compares a change with its parent in one call."""
    runs = []
    for tree in trees:
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernel-rows-child",
                               os.path.abspath(tree)], capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("KERNEL_ROWS ")),
                    None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            fail(f"kernel rows of {tree}: exit {proc.returncode}")
        runs.append(json.loads(line[len("KERNEL_ROWS "):]))
        log(f"kernel rows of {tree}: {len(runs[-1]['rows'])} rows, {time.time() - t0:.1f} s")
    first = os.path.abspath(trees[0])
    base = [r for r in runs if r["tree"] == first]
    other = [r for r in runs if r["tree"] != first]
    ratios = {}
    for key in base[0]["rows"]:
        b = statistics.mean(r["rows"][key] for r in base)
        o = [r["rows"][key] for r in other if key in r["rows"]]
        if o:
            ratios[key] = statistics.mean(o) / b
    ptxas = {k: (base[0]["ptxas"].get(k), other[0]["ptxas"].get(k)) for k in
             sorted(set(base[0]["ptxas"]) | set(other[0]["ptxas"]))} if other else {}
    changed = {k: v for k, v in ptxas.items() if v[0] != v[1]}
    out = dict(runs=runs, ratio=ratios, ptxas_changed=changed)
    log(json.dumps({"kernel_rows": out}))
    for key, r in sorted(ratios.items(), key=lambda kv: -abs(kv[1] - 1))[:12]:
        log(f"  {key}: {r:.4f} x the first tree's")
    log(f"ptxas lines that differ: {len(changed)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.time()
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
    rowpar_rows = rowpar_kernel_phase(flush, gen)
    rows.update(rowpar_rows)
    errs["flash_attention"], rows["flash_attention"] = dense_attention_phase(flush, gen)
    errs["flash_decode"], rows["flash_decode"] = slot_decode_phase(flush, gen)
    errs["flash_decode_paged"], rows["flash_decode_paged"] = decode_phase(flush, gen)
    errs["flash_attention_paged"], rows["flash_attention_paged"] = chunk_phase(flush, gen)
    mla_err, mla_rows = mla_decode_phase(flush, gen)
    mla_gemm_rows = mla_gemm_phase(flush, gen)
    moe_rows = moe_kernel_phase(flush, gen)
    ssm_rows = ssm_kernel_phase(flush, gen)
    vlm_rows = vlm_kernel_phase(flush, gen)
    train_err, train_rows = train_gemm_phase(flush, gen)
    del flush
    edge_launch, report["edge"] = edge_phase(counters, gen)
    for n in ("block_gemm_int8", "quantize_rows", "flash_attention", "flash_decode"):
        launches[n] = edge_launch[n]
    eng_launch, report["engine"] = engine_phase(
        counters, ["block_gemm", "flash_decode_paged", "flash_attention_paged"], gen)
    for n in ("block_gemm", "flash_decode_paged", "flash_attention_paged"):
        launches[n] = eng_launch[n]
    t_serve = time.time()
    served = serve_phase(counters)
    served["wall_s"] = time.time() - t_serve
    meshed = mesh_phase()
    _, report["mla"] = mla_engine_phase(counters, gen)
    report["mla"].update(decode_max_abs_err_bf16=mla_err, decode=mla_rows, gemm=mla_gemm_rows)
    gc.collect()  # every earlier phase's model, pools and graphs go before the 61 GB MoE
    torch.cuda.empty_cache()
    _, moe = moe_engine_phase(counters, gen)
    moe["rows"] = moe_rows
    gc.collect()  # the MoE model goes before the SSM phases
    torch.cuda.empty_cache()
    t_ssm = time.time()
    ssm = {"mamba2": ssm_engine_phase(counters, gen)}
    ssm["jamba"] = jamba_engine_phase(counters, gen)
    ssm.update(rows=ssm_rows, wall_s=time.time() - t_ssm)
    gc.collect()  # jamba goes before the VLM (20.2 GB of bf16 weights)
    torch.cuda.empty_cache()
    t_vlm = time.time()
    vlm = {"vlm": vlm_phase(counters, gen)}
    gc.collect()
    torch.cuda.empty_cache()
    vlm["encoder"] = encoder_phase(counters, gen)
    vlm["wall_s"] = time.time() - t_vlm
    gc.collect()  # hubert goes before the training phases
    torch.cuda.empty_cache()
    t_train = time.time()
    train, train_launch = train_phase(counters, gen)
    train["wall_s"] = time.time() - t_train
    gc.collect()
    torch.cuda.empty_cache()
    t_opt = time.time()
    options = train_options_phase(counters)
    options["wall_s"] = time.time() - t_opt
    gc.collect()
    torch.cuda.empty_cache()
    mesh_train = mesh_train_phase()
    dry = dryrun_phase(train, options, mesh_train, vlm)
    gc.collect()
    torch.cuda.empty_cache()
    analysis = analysis_phase(gen)

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
    # the row-parallel w8a8 GEMM's entries (the int8 GEMM's two halves and
    # the quantize's two passes) at w_down's K half of a 64-row chunk;
    # launches from rank 0's mesh (e) run
    M_, K_, N_ = ROWPAR_MAIN
    rowpar = [dict(name=n, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
                   replaces=rep_, launches=meshed["e"]["launches"][n], max_abs_err=0.0,
                   **pick(n, shape))
              for n, src, rep_, shape in (
                  ("block_gemm_int8_acc", "block_gemm_int8.cu", sources["block_gemm_int8"][1],
                   f"{M_}x{K_}x{N_}"),
                  ("int8_epilogue", "block_gemm_int8.cu", sources["block_gemm_int8"][1],
                   f"{M_}x{N_} bf16 out"),
                  ("row_amax", "quantize.cu", quant["replaces"], f"{M_}x{K_} bf16"),
                  ("quantize_rows_given", "quantize.cu", quant["replaces"], f"{M_}x{K_} bf16"))]
    kernels += [quant] + rowpar
    log(json.dumps({"kernel_shapes": rows, **report}))
    log(json.dumps({"added_kernels": [quant] + rowpar}))
    # the two decode kernels at minicpm3-4b's latent shape, launches from the
    # MLA engine run (paged) and the direct slot-cache loop (slot)
    mla = report["mla"]
    log(json.dumps({"mla_kernels": [
        dict(name="flash_decode_paged", launches=mla["launches"]["flash_decode_paged"],
             max_abs_err=mla_err, **mla_rows["paged"]),
        dict(name="flash_decode", launches=mla["direct"]["launches"]["flash_decode"],
             max_abs_err=mla_err, **mla_rows["slot"])]}))
    log(json.dumps({"moe": moe}))
    log(json.dumps({"ssm": ssm}))
    # the VLM's and the encoder's kernels at their shapes; launches: the
    # wrapper's count in the bf16 run of the path with that shape (the VLM's
    # prefill + warm-up + 32 replays, or one encoder forward)
    vrun, erun = vlm["vlm"]["bf16"]["run_launches"], vlm["encoder"]["bf16"]["launches"]
    n_cross = vlm["vlm"]["bf16"]["per_replay"]["flash_attention"]
    attn_launches = (erun["flash_attention"], n_cross, (VLM_STEPS + 1) * n_cross)
    fa = sources["flash_attention"]
    vlm_kernels = [dict(name="flash_attention", route="cuda",
                        source=f"src/repro_torch/kernels/csrc/{fa[0]}", replaces=fa[1],
                        launches=n, max_abs_err=errs["flash_attention"], **row)
                   for row, n in zip(vlm_rows["attention"], attn_launches)]
    fd = sources["flash_decode"]
    vlm_kernels.append(dict(name="flash_decode", route="cuda",
                            source=f"src/repro_torch/kernels/csrc/{fd[0]}", replaces=fd[1],
                            launches=vrun["flash_decode"], **vlm_rows["decode"]))
    bg = sources["block_gemm"]
    vlm_kernels += [dict(name="block_gemm", route="cuda",
                         source=f"src/repro_torch/kernels/csrc/{bg[0]}", replaces=bg[1],
                         launches=erun["block_gemm"] if row["shape"].startswith(
                             f"{ENC_B * ENC_T}x") else vrun["block_gemm"],
                         max_abs_err=vlm_rows["gemm_max_abs_err"], **row)
                    for row in vlm_rows["gemm"]]
    log(json.dumps({"vlm_encoder": vlm}))
    log(json.dumps({"vlm_encoder_kernels": vlm_kernels}))
    # the block GEMM at olmo-1b's training shapes: forward and both backward
    # products; launches from the 10-step full-width train run
    train_kernels = [dict(name="block_gemm", route="cuda",
                          source=f"src/repro_torch/kernels/csrc/{bg[0]}", replaces=bg[1],
                          launches=train_launch["block_gemm"], max_abs_err=train_err, **row)
                     for row in train_rows]
    log(json.dumps({"train": train}))
    log(json.dumps({"train_kernels": train_kernels}))
    log(json.dumps({"serve": served}))
    log(json.dumps({"mesh": meshed}))
    log(json.dumps({"train_options": options}))
    # the block GEMM at the mesh shards' training shapes; launches: rank 0's
    # over the bf16 mesh training steps (a)-(c)
    # ((e)-(h)'s rows: rank 0's over that family's bf16 steps)
    mesh_train_kernels = [dict(name="block_gemm", route="cuda",
                               source=f"src/repro_torch/kernels/csrc/{bg[0]}", replaces=bg[1],
                               max_abs_err=mesh_train["gemm_max_abs_err"],
                               **dict(row, launches=row.get(
                                   "launches", mesh_train["block_gemm_launches_rank0"])))
                          for row in mesh_train["gemm_rows"]]
    log(json.dumps({"mesh_train": mesh_train}))
    log(json.dumps({"mesh_train_kernels": mesh_train_kernels}))
    log(json.dumps({"dryrun": dry}))
    log(f"chip_smoke wall time {time.time() - t_start:.1f} s (the serve phase "
        f"{served['wall_s']:.1f} s, the mesh phase {meshed['wall_s']:.1f} s, the SSM engine phases {ssm['wall_s']:.1f} s, the VLM and "
        f"encoder phases {vlm['wall_s']:.1f} s, the training phases {train['wall_s']:.1f} s, "
        f"the training options {options['wall_s']:.1f} s, the mesh training phase "
        f"{mesh_train['wall_s']:.1f} s, the dry run {dry['wall_s']:.1f} s, the analysis "
        f"{analysis['wall_s']:.1f} s)")
    log(json.dumps({"analysis": analysis}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--kernel-rows-child":
        _kernel_rows_child(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) > 2 and sys.argv[1] == "--kernel-rows":
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available; this script runs on the card",
                  file=sys.stderr)
            sys.exit(2)
        kernel_rows(sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
