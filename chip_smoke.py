"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, and the kernels' build from ``src/repro_torch/kernels/csrc``;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serving path's shapes, in f32 and bf16, with its time,
   the plain version's time, the library call's time where one exists and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over the peak rate of their type);
3. engine: full-width, full-depth olmo-1b in bf16 with seeded random
   weights serves 8 greedy requests (four share a prefix, so radix hits
   and copy-on-write pages happen) through ``repro_torch.serving.Engine``;
   every kernel's launch count must rise during this phase, the page pool
   must reconcile, and two prompts served alone must give the same tokens;
4. a JSON ``kernels`` line, then the JSON result as the last line.

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
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type


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
    """Median CUDA-event time of ``fn`` over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_gemm import block_gemm
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
    torch.cuda.synchronize()
    log(f"block_gemm: {len(shapes)} shapes x (f32, bf16, bf16->f32) agree; "
        f"max_abs_err f32 {err_f32:.3e} bf16 {err_bf16:.3e}")
    rows = []
    for (M, K, N) in [(8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048),
                      (8, 2048, 50432), (64, 2048, 2048), (64, 2048, 8192),
                      (64, 8192, 2048), (1, 2048, 50432)]:
        a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        b = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)).bfloat16()
        out_dtype = torch.float32 if N == 50432 else torch.bfloat16
        ms = time_ms(lambda: block_gemm(a, b, out_dtype=out_dtype), flush)
        plain = time_ms(lambda: ref.block_gemm_ref(a, b, out_dtype), flush)
        lib = time_ms(lambda: torch.matmul(a, b), flush)
        out_bytes = M * N * (4 if out_dtype == torch.float32 else 2)
        bms, by = bound_ms(2 * (M * K + K * N) + out_bytes, 2 * M * N * K,
                           torch.bfloat16)
        rows.append(dict(shape=f"{M}x{K}x{N}", ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bms, bound_by=by))
        log(f"  block_gemm bf16 M={M} K={K} N={N}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return max(err_bf16, err_f32), rows


def _paged_pools(gen, P, ps, K, d, dtype):
    k = torch.randn(P, ps, K, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(P, ps, K, d, generator=gen, device="cuda").to(dtype)
    return k, v


def _tables(B, npp, P, seed):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(np.arange(1, P))[: B * npp]
    return torch.from_numpy(perm.reshape(B, npp).astype(np.int32)).cuda()


def decode_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode_paged
    # Tolerances.  f32: online vs two-pass softmax in f32, ~1e-6; 2e-5.
    # bf16: the kernel rounds the unnormalized P to bf16 before PV (as the
    # Pallas kernel does), the plain version the normalized P, and both
    # round the output: ~2^-8 of max|v| (~4 for randn), so 3e-2.
    B, H, K, d, ps, max_len = 8, 16, 16, 128, 64, 1024
    npp, P = max_len // ps, 8 * (max_len // ps) + 1
    # empty slot (start > pos), prefix-only, mid-page, window-like start,
    # page boundary, a full frozen slot (pos == npp * ps), a fresh slot
    pos = torch.tensor([3, 100, 257, 511, 700, 1024, 63, 0], dtype=torch.int32,
                       device="cuda")
    start = torch.tensor([5, 0, 0, 200, 0, 0, 0, 0], dtype=torch.int32,
                         device="cuda")
    pages = _tables(B, npp, P, 1)
    err = {}
    cases = [("mha", H, K, 0.0, None, False), ("gqa-softcap", 16, 4, 30.0, None, False),
             ("shared-kv-dv64", 16, 4, 0.0, 64, True)]
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        for name, Hc, Kc, cap, dv, shared in cases:
            k, v = _paged_pools(gen, P, ps, Kc, d, dtype)
            if shared:
                v = k
            q = torch.randn(B, Hc, d, generator=gen, device="cuda").to(dtype)
            got = flash_decode_paged(q, k, v, pos, start, pages, softcap=cap, dv=dv)
            want = ref.flash_decode_ref(q, k, v, pos, start, pages=pages,
                                        softcap=cap, dv=dv)
            err[(dtype, name)] = check_close(f"flash_decode_paged {dtype} {name}",
                                             got, want, atol, 0.0)
            if float(got[0].abs().max()) != 0.0:
                fail("flash_decode_paged: empty slot is not exactly zero")
    torch.cuda.synchronize()
    log(f"flash_decode_paged: {len(cases)} cases x (f32, bf16) agree; max_abs_err "
        + ", ".join(f"{str(dt)[6:]} {n} {e:.3e}" for (dt, n), e in err.items()))
    k, v = _paged_pools(gen, P, ps, K, d, torch.bfloat16)
    q = torch.randn(B, H, d, generator=gen, device="cuda").bfloat16()
    ms = time_ms(lambda: flash_decode_paged(q, k, v, pos, start, pages), flush)
    plain = time_ms(lambda: ref.flash_decode_ref(q, k, v, pos, start, pages=pages),
                    flush)
    live = sum(max(0, min(int(p), npp * ps - 1) - int(s) + 1)
               for p, s in zip(pos.tolist(), start.tolist()))
    n_bytes = 2 * (2 * live * K * d + 2 * B * H * d) + 4 * (B * npp + 2 * B)
    bms, by = bound_ms(n_bytes, 4 * live * (H // K) * K * d, torch.bfloat16)
    log(f"  flash_decode_paged bf16 B={B} H={H} d={d} ps={ps} live rows={live}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
    return max(e for (dt, _), e in err.items() if dt == torch.bfloat16), \
        dict(shape=f"B{B} H{H} d{d} ps{ps} live{live}", ms=ms, plain_ms=plain,
             library_ms=None, bound_ms=bms, bound_by=by)


def chunk_phase(flush, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_paged
    # Tolerances as for decode: f32 2e-5; bf16 3e-2 (P rounded to bf16 at
    # another point than the plain version, output rounded to bf16).
    H, d, ps, max_len, C = 16, 128, 64, 1024, 64
    npp, P = max_len // ps, 8 * (max_len // ps) + 1
    cases = [  # name, B, K, q_start, n valid rows, window, softcap
        ("first-chunk", 1, 16, [0], [64], 0, 0.0),
        ("q_start>0", 1, 16, [448], [64], 0, 0.0),
        ("partial-chunk", 1, 16, [200], [40], 0, 0.0),
        ("two-slots-gqa", 2, 4, [130, 700], [64, 64], 0, 0.0),
        ("window", 1, 16, [300], [64], 100, 0.0),
        ("softcap", 1, 16, [96], [64], 0, 30.0),
    ]
    err = {}
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        for name, B, K, qs, n, win, cap in cases:
            k, v = _paged_pools(gen, P, ps, K, d, dtype)
            q = torch.randn(B, H, C, d, generator=gen, device="cuda").to(dtype)
            pages = _tables(B, npp, P, 2)
            q_start = torch.tensor(qs, dtype=torch.int32, device="cuda")
            k_len = q_start + torch.tensor(n, dtype=torch.int32, device="cuda")
            got = flash_attention_paged(q, k, v, pages, q_start, k_len,
                                        window=win, softcap=cap)
            want = ref.flash_attention_paged_ref(q, k, v, pages, q_start, k_len,
                                                 window=win, softcap=cap)
            rows = min(n)  # rows past a slot's valid length are padding
            err[(dtype, name)] = check_close(
                f"flash_attention_paged {dtype} {name}",
                got[:, :, :rows], want[:, :, :rows], atol, 0.0)
    torch.cuda.synchronize()
    log(f"flash_attention_paged: {len(cases)} cases x (f32, bf16) agree; max_abs_err "
        + ", ".join(f"{str(dt)[6:]} {n} {e:.3e}" for (dt, n), e in err.items()))
    qs, n = 448, 64
    k, v = _paged_pools(gen, P, ps, H, d, torch.bfloat16)
    q = torch.randn(1, H, C, d, generator=gen, device="cuda").bfloat16()
    pages = _tables(1, npp, P, 3)
    q_start = torch.tensor([qs], dtype=torch.int32, device="cuda")
    k_len = q_start + n
    ms = time_ms(lambda: flash_attention_paged(q, k, v, pages, q_start, k_len), flush)
    plain = time_ms(lambda: ref.flash_attention_paged_ref(q, k, v, pages, q_start,
                                                          k_len), flush)
    keys = sum(min(qs + n, qs + i + 1) for i in range(C))  # causal pairs
    n_bytes = 2 * (2 * (qs + n) * H * d + 2 * H * C * d) + 4 * (npp + 2)
    bms, by = bound_ms(n_bytes, 4 * H * keys * d, torch.bfloat16)
    log(f"  flash_attention_paged bf16 C={C} H={H} d={d} q_start={qs} k_len={qs + n}: "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
    return max(e for (dt, _), e in err.items() if dt == torch.bfloat16), \
        dict(shape=f"C{C} H{H} d{d} q_start{qs} k_len{qs + n}", ms=ms, plain_ms=plain,
             library_ms=None, bound_ms=bms, bound_by=by)


# ---------------------------------------------------------------------------
# phase 3: the engine at full width
# ---------------------------------------------------------------------------

def engine_phase(counters):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig, FinishReason, check_invariants
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
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched during the engine phase")
    bad = check_invariants(eng.pool, eng.radix, tables=eng.sched.owned)
    if bad:
        fail("paging invariants: " + "; ".join(bad))
    st = eng.stats
    ttft = sorted(r.ttft_s for r in results.values())
    ticks = st.mixed_steps + st.chunks
    log(f"engine: {len(prompts)} requests, {st.tokens_out} tokens in {wall:.3f} s "
        f"({st.tokens_out / wall:.2f} tokens/s end to end), TTFT p50 "
        f"{statistics.median(ttft) * 1e3:.1f} ms, {ticks} ticks ({st.mixed_steps} "
        f"mixed at {st.prefill_s / max(st.mixed_steps, 1) * 1e3:.2f} ms, "
        f"{st.chunks} decode-only x{econf.decode_chunk} steps at "
        f"{st.decode_s / max(st.chunks, 1) * 1e3:.2f} ms), prefix hit rate "
        f"{st.prefix_hit_rate:.4f} ({st.prefix_hit_tokens} tokens)")
    log(f"engine launches: {json.dumps(launches)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"peak device memory {peak:.2f} GiB")
    batched = {tuple(p): results[rid].generated for rid, p in zip(rids, prompts)}
    del eng
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
                   mixed_tick_ms=st.prefill_s / max(st.mixed_steps, 1) * 1e3,
                   decode_tick_ms=st.decode_s / max(st.chunks, 1) * 1e3)
    summary["trace"] = trace_ticks(Engine(cfg, params, econf), prompts, max_new,
                                   summary)
    return launches, summary


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def trace_ticks(eng, prompts, max_new, summary):
    """Device time of one mixed tick and one decode-only tick under
    torch.profiler, by kernel, set against the untraced tick times of the
    main run: idle share = 1 - device time / untraced tick time."""
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        events = prof.key_averages()
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
                         top={e.key[:60]: _device_us(e) / 1e3 for e in top},
                         host_top={f"{e.key[:50]} x{e.count}":
                                   e.self_cpu_time_total / 1e3 for e in host})
        log(f"traced {kind} tick host self time (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in out[kind]["host_top"].items()))
        log(f"traced {kind} tick: device {dev_ms:.3f} ms of an untraced "
            f"{tick_ms:.3f} ms tick; top kernels (ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in out[kind]["top"].items())
            if dev_ms else f"traced {kind} tick: the profiler saw no device "
            "time (not measured)")
    eng.run()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
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
    from repro_torch.kernels.block_gemm import block_gemm
    from repro_torch.kernels.decode_attention import flash_decode_paged
    from repro_torch.kernels.flash_attention import flash_attention_paged
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

    flush = L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    gemm_err, gemm_rows = gemm_phase(flush, gen)
    dec_err, dec_row = decode_phase(flush, gen)
    fa_err, fa_row = chunk_phase(flush, gen)

    counters = [block_gemm, flash_decode_paged, flash_attention_paged]
    launches, eng = engine_phase(counters)

    main_gemm = next(r for r in gemm_rows if r["shape"] == "8x2048x8192")
    kernels = [
        dict(name="block_gemm", route="cuda",
             source="src/repro_torch/kernels/csrc/block_gemm.cu",
             replaces="src/repro/kernels/block_gemm.py:74",
             launches=launches["block_gemm"], max_abs_err=gemm_err, **main_gemm),
        dict(name="flash_decode_paged", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:234",
             launches=launches["flash_decode_paged"], max_abs_err=dec_err, **dec_row),
        dict(name="flash_attention_paged", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:172",
             launches=launches["flash_attention_paged"], max_abs_err=fa_err, **fa_row),
    ]
    log(json.dumps({"gemm_shapes": gemm_rows, "engine": eng}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
