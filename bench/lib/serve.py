"""Serving cells: closed-loop clients against the port's ``Engine``.

One process, one engine, one thread.  The run:

1. set-up: the weights drawn on the device from the seed, the engine
   built, and a *ramp* of ``ramp_s`` seconds in which the clients join one
   by one over its first half and send their closed loops -- it captures
   the decode graph, warms every shape the traffic uses and brings the
   batch, the page pool and the radix tree to their steady state;
2. the window of ``--seconds``: every token the engine emits and every
   request a client sends is counted;
3. the drain: clients keep sending (so the load stays as it was) until
   every request sent in the window has finished, at most a minute;
4. the check, after the peak memory is read and the engine freed: the
   plain reference over a sample of the window's requests.

The harness wraps the runner's three entries (``decode``, ``mixed``,
``whole_prefill``) to log each call's rows, and in a traced run records a
host span around each layer it calls into.
"""
from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench.lib import registry
from bench.lib import traffic as T
from bench.lib import weights as W
from bench.lib.stats import RequestRecord
from bench.lib.trace import Tracer

DRAIN_LIMIT_S = 60.0
#: length of the traced slice, centred in the window
TRACE_SLICE_S = 4.0


@dataclass
class Call:
    """One call into the model runner."""
    kind: str              # decode | mixed | prefill
    dec_rows: list         # live rows of each decode step it ran
    kv_rows: int           # cache rows those decode steps read
    chunk: int = 0         # prompt rows of a mixed tick's chunk
    prefill: int = 0       # rows of a whole prefill
    traced: bool = False


@dataclass
class ServeRun:
    kind: str
    cell: dict
    config: dict
    ref: object
    engine_config: dict
    window_s: float = 0.0
    setup_s: float = 0.0
    requests: list = field(default_factory=list)   # RequestRecord, sent in the window
    tokens_out: int = 0           # tokens emitted in the window
    host_s: float = 0.0           # the window less its traced slice
    flop_tokens: int = 0          # prompt rows (whole) + decoded tokens in host_s
    stats: dict = field(default_factory=dict)      # ServeStats deltas over host_s
    occupancy: list = field(default_factory=list)  # live slots before each step of host_s
    calls: list = field(default_factory=list)
    trace: object = None
    checks: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0


def live_rows(pos, remaining, steps: int):
    """(live rows of each of ``steps`` decode steps, cache rows they read):
    a slot with r tokens left decodes min(r, steps) steps, reading rows
    [0, pos + j] at step j."""
    rem = np.minimum(np.maximum(np.asarray(remaining, np.int64), 0), steps)
    pos = np.asarray(pos, np.int64)
    per_step = [int((rem > j).sum()) for j in range(steps)]
    kv = int((rem * (pos + 1) + rem * (rem - 1) // 2).sum())
    return per_step, kv


def port_arch(c: dict):
    from repro_torch.configs.base import ArchConfig
    kw = dict(c["port"])
    kw["compute_dtype"] = W.DTYPES[kw["compute_dtype"]]
    return ArchConfig(**kw)


class _Instruments:
    """The runner's entries wrapped to log each call (and, while the slice
    is traced, to record a host span)."""

    def __init__(self, eng, tracer: Tracer):
        self.calls: list[Call] = []
        r, s = eng.runner, eng.sched
        dec, mix, whole = r.decode, r.mixed, r.whole_prefill

        def decode(pages, cur, pos, remaining, nanmask, temps, gens, steps):
            rows, kv = live_rows(pos, remaining, steps)
            out = dec(pages, cur, pos, remaining, nanmask, temps, gens, steps)
            self.calls.append(Call("decode", rows, kv, traced=tracer.active))
            return out

        def mixed(buf, chunk_pages, past, n, chunk_temp, chunk_gen, chunk_nan, dec_pages,
                  cur, pos, remaining, nanmask, temps, gens):
            rows, kv = live_rows(pos, remaining, 1)
            out = mix(buf, chunk_pages, past, n, chunk_temp, chunk_gen, chunk_nan, dec_pages,
                      cur, pos, remaining, nanmask, temps, gens)
            self.calls.append(Call("mixed", rows, kv, chunk=int(n), traced=tracer.active))
            return out

        def whole_prefill(tokens, table, slot, temp, gen):
            out = whole(tokens, table, slot, temp, gen)
            self.calls.append(Call("prefill", [], 0, prefill=len(tokens), traced=tracer.active))
            return out

        r.decode = decode
        r.mixed = mixed
        r.whole_prefill = tracer.wrap("whole prefill", whole_prefill)
        r._sample = tracer.wrap("sample", r._sample)
        s.admit = tracer.wrap("admit", s.admit)
        eng._mixed_tick = tracer.wrap("mixed tick", eng._mixed_tick)
        eng._decode_tick = tracer.wrap("decode tick", eng._decode_tick)
        self.step = tracer.wrap("engine step", eng.step)


def _stats(eng) -> dict:
    s = eng.stats
    return {k: getattr(s, k) for k in ("prefill_s", "decode_s", "tokens_out", "prefills",
                                       "chunks", "mixed_steps", "prefix_hit_tokens",
                                       "prefix_lookup_tokens")}


def run(cell: dict, c: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        t_proc0: float, control: bool = False) -> ServeRun:
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import Engine, FinishReason

    ref = registry.reference(c["reference"])
    arch = port_arch(c)
    ecfg = EngineConfig(**cell["engine"])
    traffic = T.Traffic(mix, seed, c["vocab_size"])
    if traffic.max_request_rows > ecfg.max_len:
        raise ValueError(f"mix needs {traffic.max_request_rows} rows > max_len {ecfg.max_len}")
    w = W.draw(ref, c, seed, device)
    eng = Engine(arch, ref.port_tree(c, w), ecfg, device=device)
    tracer = Tracer(trace)
    tracer.warm()
    ins = _Instruments(eng, tracer)
    out = ServeRun("serve", cell, c, ref, cell["engine"])

    temp = float(mix.get("temperature", 0.0))
    sent: dict = {}        # rid -> (spec, sent in the window)
    done: dict = {}        # rid -> RequestResult
    phase = "ramp"

    def send(client: int):
        spec = traffic.next(client)
        rid = eng.submit(spec.prompt, max_new=spec.max_new, temperature=temp)
        sent[rid] = (spec, phase == "window")

    # clients join one by one over the first half of the ramp, so that the
    # window finds their requests at every stage and not in step
    t_ramp = time.time()
    ramp_s = float(cell.get("ramp_s", 0.0))
    joins = [t_ramp + 0.5 * ramp_s * cl / traffic.clients for cl in range(traffic.clients)]
    joined = 0
    ramp_end = t_ramp + ramp_s
    w0 = w1 = None
    snap: dict = {}        # ServeStats at the window's and the slice's edges
    slice_t0 = slice_t1 = None
    while True:
        now = time.time()
        while joined < traffic.clients and joins[joined] <= now:
            send(joined)
            joined += 1
        if phase == "ramp" and now >= ramp_end:
            phase, w0, snap["w0"] = "window", now, _stats(eng)
            out.setup_s = w0 - t_proc0
            slice_t0 = w0 + max(0.0, (seconds - TRACE_SLICE_S) / 2)
        if phase == "window":
            if trace and not tracer.active and not tracer.done and now >= slice_t0:
                snap["s0"] = _stats(eng)
                tracer.start()
                slice_t1 = tracer.t_start + min(TRACE_SLICE_S, seconds)
            elif tracer.active and (now >= slice_t1 or now >= w0 + seconds):
                tracer.stop()
                snap["s1"] = _stats(eng)
            if now >= w0 + seconds:
                phase, w1, snap["w1"] = "drain", now, _stats(eng)
        if phase == "drain":
            pending = [r for r, (_, inw) in sent.items() if inw and r not in done]
            if not pending or now - w1 > DRAIN_LIMIT_S:
                break
        if phase == "window" and not tracer.active:
            out.occupancy.append(eng.num_active)
        results = ins.step()
        with tracer.span("client loop"):
            for res in results:
                done[res.rid] = res
                spec, _ = sent[res.rid]
                send(spec.client)

    for res in eng.close():
        done.setdefault(res.rid, res)
    out.window_s = w1 - w0
    whole = {k: snap["w1"][k] - snap["w0"][k] for k in snap["w0"]}
    out.tokens_out = whole["tokens_out"]
    # the program's own counters and spans over the window less the traced
    # slice, whose profiler slows the host
    sliced = {k: snap["s1"][k] - snap["s0"][k] for k in whole} if tracer.done else {}
    out.stats = {k: v - sliced.get(k, 0) for k, v in whole.items()}
    out.host_s = out.window_s - tracer.slice_s
    out.calls = ins.calls
    out.trace = tracer.collect()

    # every request sent in the window, as its client saw it
    recs = []
    for rid, (spec, inw) in sent.items():
        if not inw:
            continue
        r = done.get(rid)
        if r is None or not r.generated:
            recs.append(RequestRecord(math.inf, None, None, 0, False))
            continue
        ok = r.finish_reason == FinishReason.LENGTH and len(r.generated) == spec.max_new
        recs.append(RequestRecord(r.arrival_s, r.first_token_s, r.finish_s, len(r.generated), ok))
    out.requests = recs
    out.attempted = len(recs)
    out.failed = sum(not r.ok for r in recs)
    # model work of the window outside the slice: each prompt whose first
    # token came then counted whole, and every token decoded after a first
    def untraced(t):
        return w0 <= t < w1 and not (tracer.done and tracer.t_start <= t < tracer.t_stop)
    firsts = [r for r in done.values() if r.generated and untraced(r.first_token_s)]
    out.flop_tokens = sum(len(r.prompt) for r in firsts) + out.stats["tokens_out"] - len(firsts)

    if torch.cuda.is_available() and torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    del eng, ins
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # the sample: requests that finished from the window's start on
    sample = pick_sample(cell, seed, [(sent[rid][0], done[rid]) for rid in sorted(done)
                                      if rid in sent and done[rid].finish_s >= w0],
                         FinishReason)
    out.checks = check(ref, c, w, sample, device, control)
    return out


def pick_sample(cell: dict, seed: int, finished: list, FinishReason) -> list:
    """(prompt, tokens) of a seeded sample of the window's finished
    requests, the one with the most tokens first, until ``sample_tokens``
    tokens or ``max_requests`` requests."""
    ok = [(spec, r) for spec, r in finished
          if r.finish_reason == FinishReason.LENGTH and len(r.generated) == spec.max_new]
    if not ok:
        return []
    want = int(cell["check"]["sample_tokens"])
    cap = int(cell["check"]["max_requests"])
    longest = max(range(len(ok)), key=lambda i: (len(ok[i][1].generated), -i))
    rest = [i for i in T.rng(seed, 3).permutation(len(ok)).tolist() if i != longest]
    picked, n = [], 0
    for i in [longest] + rest:
        if n >= want or len(picked) >= cap:
            break
        picked.append((list(ok[i][1].prompt), list(ok[i][1].generated)))
        n += len(ok[i][1].generated)
    return picked


def gaps(ref, c: dict, w: dict, sample: list, device, quant: str | None = None):
    """Per sampled request, the reference's logits at each served position
    and, with ``quant``, the control's pick there: [(ref logits [n, V],
    served tokens [n], control picks [n] or None)]."""
    from bench.reference.common import f32_only
    seqs = [torch.tensor(p + g[:-1], dtype=torch.long, device=device) for p, g in sample]
    rows = [torch.arange(len(p) - 1, len(p) - 1 + len(g), device=device) for p, g in sample]
    toks = [torch.tensor(g, dtype=torch.long, device=device) for _, g in sample]
    out = []
    with torch.no_grad(), f32_only():
        lfs = ref.logits(c, w, seqs, rows)
        lows = ref.logits(c, w, seqs, rows, quant=quant) if quant else [None] * len(seqs)
    for lf, t, lo in zip(lfs, toks, lows):
        out.append((lf, t, None if lo is None else lo.argmax(-1)))
    return out


def widest_gap(lf, picks) -> float:
    """How far the reference's logit of each picked token lies below its
    best, at the worst position."""
    best = lf.max(-1).values
    got = lf.gather(-1, picks[:, None])[:, 0]
    return float((best - got).max())


def check(ref, c: dict, w: dict, sample: list, device, control: bool = False) -> dict:
    """The numbers ``correct`` compares: ``logit_gap``, the widest gap by
    which a served token's reference logit lies below the reference's best
    over the sample (and with ``control``, ``control_gap``: the same for
    the token the fp8 control puts first at each position)."""
    if not sample:
        return {"logit_gap": math.inf, "tokens_checked": 0}
    res = gaps(ref, c, w, sample, device, quant="fp8" if control else None)
    out = {"logit_gap": max(widest_gap(lf, t) for lf, t, _ in res),
           "tokens_checked": sum(len(t) for _, t, _ in res)}
    if control:
        out["control_gap"] = max(widest_gap(lf, lo) for lf, _, lo in res)
    return out
