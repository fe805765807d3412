"""Training cells: the port's ``make_train_step`` on a packed document feed.

Set-up builds one object -- the train step with the model and its AdamW
state, from the benchmark's weights -- and drives it through its first
``checked_steps`` steps with the window's own call and feed (every row
new); those steps are also the warm-up.  The program's numbers are read
from that same state: each step's loss, the gradient the optimizer got at
step 1 (its first moment over ``1 - b1``) and the change of every weight
after the checked steps.  The window then steps the same state for
``--seconds``, reading each step's loss (one host read a step, as a
trainer's log does).  After the window the state is freed and the plain
float32 reference follows the checked steps from the same weights and
rows.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from dataclasses import dataclass, field

import torch

from bench.lib import registry
from bench.lib import traffic as T
from bench.lib import weights as W
from bench.lib.serve import TRACE_SLICE_S, port_arch
from bench.lib.trace import Tracer


@dataclass
class TrainRun:
    kind: str
    cell: dict
    config: dict
    ref: object
    job: dict
    window_s: float = 0.0
    setup_s: float = 0.0
    steps: int = 0
    tokens: int = 0
    host_tokens: int = 0          # tokens of the window's untraced steps
    host_s: float = 0.0           # those steps' seconds
    step_log: list = field(default_factory=list)   # (t0, t1, traced) a window step
    trace: object = None
    checks: dict = field(default_factory=dict)
    readings: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0


def named_leaves(ref, c: dict, tree) -> dict:
    """The leaves of a program tree (params or moments) by the reference's
    weight names (``ref.port_tree`` of the names themselves)."""
    names = ref.port_tree(c, {k: k for k in ref.weight_shapes(c, 1)})
    out: dict = {}

    def walk(n, t):
        if isinstance(n, str):
            out[n] = t
        elif isinstance(n, dict):
            for k in n:
                walk(n[k], t[k])
        else:
            for a, b in zip(n, t):
                walk(a, b)
    walk(names, tree)
    return out


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.to(torch.float32)))


def run(cell: dict, c: dict, job: dict, seed: int, seconds: float, trace: bool, device,
        t_proc0: float, control: bool = False) -> TrainRun:
    from repro_torch.training.optimizer import AdamWConfig, init_moments
    from repro_torch.training.step import TrainState, make_train_step

    ref = registry.reference(c["reference"])
    opt_d = cell["optimizer"]
    opt = AdamWConfig(**opt_d)
    feed = T.Documents(job, seed, c["vocab_size"])
    out = TrainRun("train", cell, c, ref, job)

    def batch(i: int) -> dict:
        return {k: torch.from_numpy(v).to(device) for k, v in feed.batch(i).items()}

    w = W.draw(ref, c, seed, device)  # the benchmark's; the program gets its own copy
    params = ref.port_tree(c, {k: v.clone() for k, v in w.items()})
    mu, nu = init_moments(params, opt)
    state = TrainState(torch.zeros((), dtype=torch.int32, device=device), params, mu, nu)
    del params, mu, nu
    step_fn = make_train_step(port_arch(c), opt)
    tracer = Tracer(trace)
    tracer.warm()

    n_check = int(cell["checked_steps"])
    prog = {"loss": [], "grad": {}, "update": {}}
    for i in range(n_check):
        state, m = step_fn(state, batch(i))
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad"] = {k: _norm(t) / (1 - opt.b1)
                            for k, t in named_leaves(ref, c, state.mu).items()}
    prog["update"] = {k: _norm(t.to(torch.float32) - w[k].to(torch.float32))
                      for k, t in named_leaves(ref, c, state.params).items()}

    i = n_check
    w0 = time.time()
    out.setup_s = w0 - t_proc0
    slice_t0 = w0 + max(0.0, (seconds - TRACE_SLICE_S) / 2)
    slice_t1 = None
    losses = []
    while True:
        now = time.time()
        if now >= w0 + seconds:
            break
        if trace and not tracer.active and not tracer.done and now >= slice_t0:
            tracer.start()
            slice_t1 = tracer.t_start + min(TRACE_SLICE_S, seconds)
        elif tracer.active and now >= slice_t1:
            tracer.stop()
        t0 = time.time()
        traced = tracer.active
        with tracer.span("train step"):
            state, m = step_fn(state, batch(i))
            losses.append(float(m["loss"]))
        out.step_log.append((t0, time.time(), traced))
        i += 1
    if tracer.active:
        tracer.stop()
    out.window_s = time.time() - w0
    out.steps = len(losses)
    out.tokens = out.steps * feed.rows * feed.seq
    untraced = [s_ for s_ in out.step_log if not s_[2]]
    out.host_tokens = len(untraced) * feed.rows * feed.seq
    out.host_s = sum(t1 - t0 for t0, t1, _ in untraced)
    out.attempted = out.steps
    out.failed = sum(not math.isfinite(x) for x in losses)
    out.trace = tracer.collect()
    if torch.cuda.is_available() and torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    del state, step_fn, m
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    rows = [batch(j) for j in range(n_check)]
    want = follow(ref, c, opt_d, w, rows)
    out.readings = {"program": prog, "reference": want}
    out.checks = compare(prog, want)
    if control:
        lo = follow(ref, c, opt_d, w, rows, quant="fp8")
        half = follow(ref, c, opt_d, w, [{k: v[: v.shape[0] // 2] for k, v in r.items()}
                                         for r in rows])
        out.checks.update({f"control_{k}": v for k, v in compare(lo, want).items()})
        out.checks.update({f"half_batch_{k}": v for k, v in compare(half, want).items()})
    return out


def follow(ref, c: dict, opt: dict, w: dict, rows: list, quant: str | None = None) -> dict:
    """The plain reference's first steps from the weights ``w`` on ``rows``:
    each step's loss, each leaf's clipped gradient norm at step 1 and each
    leaf's change after the last step, in float32 (``quant``: the control's
    precision)."""
    from bench.reference import adamw
    from bench.reference.common import f32_only
    p = {k: v.to(torch.float32).clone().requires_grad_() for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    got = {"loss": [], "grad": {}, "update": {}}
    with f32_only():
        for i, r in enumerate(rows):
            with torch.enable_grad():
                loss = ref.loss(c, p, r["tokens"], r["labels"], quant)
                grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            got["loss"].append(float(loss.detach()))
            if i == 0:
                got["grad"] = {k: _norm(g) for k, g in adamw.clipped(opt, grads).items()}
            adamw.update(opt, p, grads, m, v2, i)
            del grads
    got["update"] = {k: _norm(p[k].detach() - w[k].to(torch.float32)) for k in p}
    return got


def _leaf_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf's gap between the two norms, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


def compare(got: dict, want: dict) -> dict:
    """The training cell's three numbers.  Leaves whose reference gradient
    is under a thousandth of the median leaf's (nought to rounding) are
    left out of the two leaf numbers."""
    med = statistics.median(want["grad"].values())
    keep = [k for k, g in want["grad"].items() if g >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) for a, b in zip(got["loss"], want["loss"])),
            "grad_norm_gap": _leaf_gap(got["grad"], want["grad"], keep),
            "update_norm_gap": _leaf_gap(got["update"], want["update"], keep)}
