"""The serving engine's profiler ranges and each request's admission time
(CPU, reduced olmo-1b and minicpm3-4b, seed-0 weights).

- ``core.span`` while no profiler records: the shared no-op context, and no
  ``record_function`` is made, on a whole engine run too;
- under ``torch.profiler.profile``, a chunked olmo engine with a shared
  prefix records ``serve.chunk_forward`` once a mixed tick and an MLA engine
  (whole prefills) ``serve.whole_forward`` once a prefill; neither lies
  inside another program range or holds one: the card's trace ties a kernel
  to the innermost range open at its launch, so a range inside would take
  kernels out of theirs;
- greedy tokens are the same with the profiler on and off;
- ``arrival_s <= admitted_s <= first_token_s <= finish_s`` on both
  admission paths, after a preemption too, which keeps the first admission.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as TC
from repro_torch import core
from repro_torch.models import model as TM
from repro_torch.serving import Engine, EngineConfig

#: every range the program opens; the serving ones are leaves that no
#: program range holds
LEAVES = {"serve.chunk_forward", "serve.whole_forward"}
PROGRAM = LEAVES | {"plain_attention", "adamw_update"}
CHUNKED = {"serve.chunk_forward"}
WHOLE = {"serve.whole_forward"}


@pytest.fixture(scope="module")
def olmo():
    cfg = TC.reduce_config(TC.get_config("olmo-1b"))
    return cfg, TM.init(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def mla():
    cfg = TC.reduce_config(TC.get_config("minicpm3-4b"))
    return cfg, TM.init(cfg, seed=0, device="cpu")


def _prompts(vocab, shared: bool, n=3, seed=0):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab, 32).tolist() if shared else []
    return [prefix + rng.randint(1, vocab, 4 + 5 * i).tolist() for i in range(n)]


def _serve(model, prompts, max_new=6, **kw):
    """Greedy tokens by prompt and the engine's results, drained."""
    cfg, params = model
    kw = {"max_batch": 2, "max_len": 96, "page_size": 16, "decode_chunk": 4, **kw}
    eng = Engine(cfg, params, EngineConfig(**kw), device="cpu")
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = {r.rid: r for r in eng.run()}
    res.update({r.rid: r for r in eng.close()})
    return [res[r] for r in rids], eng


def _ranges(prof) -> list:
    """(name, start, end) of each program range the profiler recorded."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name in PROGRAM or e.name.startswith("serve.")]


def _check_nesting(ranges, want: set):
    assert {r[0] for r in ranges} == want
    for rng in ranges:
        _, a, b = rng
        held = [r for r in ranges if r is not rng and r[1] <= a and b <= r[2]]
        inside = [r for r in ranges if r is not rng and a <= r[1] and r[2] <= b]
        assert not held and not inside, (rng, held, inside)


def test_span_is_the_shared_noop_while_no_profiler_records(olmo, monkeypatch):
    made = []

    def record_function(*a, **k):
        made.append(a)
        raise AssertionError("a RecordFunction made while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", record_function)
    assert not torch.autograd._profiler_enabled()
    assert core.span("serve.chunk_forward") is core.NO_SPAN
    assert core.span("adamw_update") is core.span("plain_attention")
    with core.span("a"), core.span("b"):
        pass
    res, _ = _serve(olmo, _prompts(olmo[0].vocab_size, True), chunk_tokens=16)
    assert all(r.ok for r in res) and made == []


def test_span_records_while_a_profiler_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert core.span("x") is not core.NO_SPAN
        with core.span("adamw_update"):
            torch.ones(4).add_(1)
    assert [e.name for e in prof.events() if e.name == "adamw_update"] == ["adamw_update"]


@pytest.mark.parametrize("path", ["chunked", "whole"])
def test_serving_ranges_nest_and_forwards_are_leaves(olmo, mla, path):
    """The path's forward range, once a forward and nested with no other;
    the tokens are the untraced run's."""
    model, kw, want = ((olmo, {"chunk_tokens": 16, "prefix_cache": True}, CHUNKED)
                       if path == "chunked" else (mla, {}, WHOLE))
    prompts = _prompts(model[0].vocab_size, shared=path == "chunked")
    plain, _ = _serve(model, prompts, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced, eng = _serve(model, prompts, **kw)
    ranges = _ranges(prof)
    _check_nesting(ranges, want)
    if path == "chunked":
        assert eng.stats.prefix_hit_tokens > 0 and eng.stats.mixed_steps > 1
        n_fwd = sum(r[0] == "serve.chunk_forward" for r in ranges)
        assert n_fwd == eng.stats.mixed_steps
    else:
        n_fwd = sum(r[0] == "serve.whole_forward" for r in ranges)
        assert n_fwd == eng.stats.prefills == len(prompts)
    assert [r.generated for r in traced] == [r.generated for r in plain]
    assert all(r.ok for r in traced)


def _ordered(r):
    return r.arrival_s <= r.admitted_s <= r.first_token_s <= r.finish_s


@pytest.mark.parametrize("path", ["chunked", "whole"])
def test_admission_time_orders_each_request(olmo, mla, path):
    model, kw = ((olmo, {"chunk_tokens": 16}) if path == "chunked" else (mla, {}))
    prompts = _prompts(model[0].vocab_size, shared=False, n=4)
    res, _ = _serve(model, prompts, max_batch=2, **kw)
    assert all(r.ok and r.admitted_s is not None and _ordered(r) for r in res)
    # two slots, four requests: the later two waited for a slot
    assert max(r.admitted_s - r.arrival_s for r in res[2:]) > 0.0


@pytest.mark.parametrize("path", ["chunked", "whole"])
def test_a_preempted_request_keeps_its_first_admission(olmo, mla, path):
    """A small pool preempts (recompute) a decoding request, which had its
    first token; admitted again later, it keeps its first admission, so
    ``admitted_s`` still comes before that token."""
    model, kw = ((olmo, {"chunk_tokens": 16, "prefix_cache": True}) if path == "chunked"
                 else (mla, {}))
    prompts = _prompts(model[0].vocab_size, shared=True)  # 12 pages wanted, 7 held
    res, eng = _serve(model, prompts, max_new=16, max_batch=3, n_pages=8,
                      preemption="recompute", **kw)
    assert eng.stats.preempted >= 1
    assert all(r.ok and _ordered(r) for r in res)


def test_a_request_that_never_gets_a_slot_has_no_admission_time(olmo):
    cfg, params = olmo
    eng = Engine(cfg, params, EngineConfig(max_batch=1, max_len=96, page_size=16,
                                           max_queue=1), device="cpu")
    first = eng.submit([1, 2, 3], max_new=8)
    res = {r.rid: r for r in eng.step()}      # admitted
    queued = eng.submit([4, 5, 6], max_new=4)  # waits behind it
    rejected = eng.submit([7, 8, 9], max_new=4)  # the queue is full
    res.update({r.rid: r for r in eng.step()})
    res.update({r.rid: r for r in eng.close()})
    assert res[rejected].finish_reason.value == "rejected"
    assert res[first].admitted_s is not None and _ordered(res[first])
    assert res[queued].admitted_s is None and res[rejected].admitted_s is None
