"""The port's serving resilience and chaos harness against the JAX engine's
(CPU, reduced olmo-1b, seed-0 JAX weights through ``params_from_numpy``).

Each scenario of ``tests/test_resilience.py`` and ``tests/test_chaos.py``
runs on both engines with the same prompts, configuration and chaos
schedule.  The original assertions hold on the port, and the port's
outcome — finish reasons, greedy tokens, resilience counters and the
injector's ``events`` — equals the JAX engine's.  Deadlines fire from the
injected clock (``clock.skew``), with budgets far from the wall time a run
takes, so no scenario depends on how fast the machine is.

``test_whole_prefill_models_cancel_and_deadline`` runs on reduced
mamba2-130m (the ``mamba_sides`` fixture): SSM prefills whole prompts at
admission.  One scenario waits for its module, and is not ported here:
``test_failure_injector_is_a_chaos_specialization`` needs the training
slice's ``FailureInjector`` (ROADMAP Queue 1 item 12).
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.serving as JS
from repro.checkpoint.manager import _flatten
from repro.models import model as JM
from repro.serving.paging import check_invariants as j_check_invariants
import repro_torch.configs as TC
import repro_torch.serving as TS
from repro_torch.core import gemm as TG
from repro_torch.core.gemm import cgra_gemm_w8a8, quantize_act
from repro_torch.models import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.graph import DecodeGraph


class Side:
    """One package's engine surface, so a scenario is written once."""

    def __init__(self, name, cfg, params, mod, check_invariants, engine_kw):
        self.name, self.cfg, self.params = name, cfg, params
        self.mod, self.check_invariants = mod, check_invariants
        self.engine_kw = engine_kw

    def engine(self, chaos=None, **kw):
        kw.setdefault("max_len", 96)
        kw.setdefault("page_size", 16)
        kw.setdefault("decode_chunk", 4)
        return self.mod.Engine(self.cfg, self.params, self.mod.EngineConfig(**kw),
                               chaos=chaos, **self.engine_kw)

    def chaos(self, **kw):
        return self.mod.ChaosInjector(**kw)

    @property
    def FR(self):
        return self.mod.FinishReason


@pytest.fixture(scope="module")
def sides():
    jcfg = JC.reduce_config(JC.get_config("olmo-1b"))
    tcfg = TC.reduce_config(TC.get_config("olmo-1b"))
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(tcfg, _flatten(params), device="cpu")
    return (Side("jax", jcfg, params, JS, j_check_invariants, {}),
            Side("torch", tcfg, tparams, TS, TS.check_invariants, {"device": "cpu"}))


@pytest.fixture(scope="module")
def mamba_sides():
    jcfg = JC.reduce_config(JC.get_config("mamba2-130m"))
    tcfg = TC.reduce_config(TC.get_config("mamba2-130m"))
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(tcfg, _flatten(params), device="cpu")
    return (Side("jax", jcfg, params, JS, j_check_invariants, {}),
            Side("torch", tcfg, tparams, TS, TS.check_invariants, {"device": "cpu"}))


def _both(sides, scenario, *args):
    """Run ``scenario(side, *args)`` on both engines; the outcomes (plain
    data) must be equal.  Returns the port's."""
    jout, tout = (scenario(s, *args) for s in sides)
    assert tout == jout
    return tout


def _prompts(side, texts):
    return [side.mod.bytes_tokenizer_encode(t, side.cfg.vocab_size) for t in texts]


def _drain(eng):
    results = []
    while eng.num_queued or eng.num_active:
        results.extend(eng.step())
    results.extend(eng.run())
    return {r.rid: r for r in results}


def _outcome(res, rids):
    return [(res[r].finish_reason.value, list(res[r].generated)) for r in rids]


def _counters(eng):
    s = eng.stats
    return (s.preempted, s.rejected, s.deadline_expired, s.cancelled, s.faults_isolated)


def _reconciled(side, eng):
    bad = side.check_invariants(eng.pool, eng.radix, tables=eng.sched.owned)
    assert not bad, bad
    return True


# ---------------------------------------------------------------------------
# FinishReason: healthy exits
# ---------------------------------------------------------------------------

def _healthy(side):
    FR = side.FR
    p = _prompts(side, ["healthy"])[0]
    eng = side.engine(max_batch=1)
    r0 = eng.submit(p, max_new=6)
    res = {r.rid: r for r in eng.run()}
    assert res[r0].finish_reason == FR.LENGTH and res[r0].ok
    first = res[r0].generated[0]
    eng2 = side.engine(max_batch=1, eos_id=first)
    r1 = eng2.submit(p, max_new=6)
    res2 = {r.rid: r for r in eng2.run()}
    assert res2[r1].finish_reason == FR.STOP and res2[r1].ok
    assert res2[r1].generated == [first]
    return _outcome(res, [r0]) + _outcome(res2, [r1])


def test_finish_reason_healthy_exits(sides):
    _both(sides, _healthy)


# ---------------------------------------------------------------------------
# Deadlines (deterministic via injected clock skew)
# ---------------------------------------------------------------------------

def _deadlines(side):
    FR = side.FR
    pa, pb, pc = _prompts(side, ["deadline aa", "deadline bb", "deadline cc"])
    chaos = side.chaos(schedule={"clock.skew": {3}}, skew_s=1000.0)
    eng = side.engine(max_batch=1, deadline_s=500.0, chaos=chaos)
    ra = eng.submit(pa, max_new=20)                     # config default
    rb = eng.submit(pb, max_new=4)                      # queued behind ra
    rc = eng.submit(pc, max_new=4, deadline_s=2000.0)   # outlives the skew
    res = _drain(eng)
    assert res[ra].finish_reason == FR.DEADLINE
    assert len(res[ra].generated) > 0          # in-flight: partial kept
    assert res[rb].finish_reason == FR.DEADLINE
    assert res[rb].generated == []             # queued: never ran
    assert res[rc].finish_reason == FR.LENGTH
    assert eng.stats.deadline_expired == 2
    assert eng.pool.num_free == eng.pool.n_pages - 1
    with pytest.raises(ValueError):
        eng.submit(pa, max_new=4, deadline_s=-1.0)
    with pytest.raises(ValueError):
        side.mod.EngineConfig(deadline_s=0.0)
    return _outcome(res, [ra, rb, rc]), _counters(eng), list(chaos.events)


def test_deadline_default_override_and_partial_output(sides):
    _both(sides, _deadlines)


# ---------------------------------------------------------------------------
# Cancellation
# ---------------------------------------------------------------------------

def _cancel(side):
    FR = side.FR
    pa, pb = _prompts(side, ["cancel me aa", "cancel me bb"])
    eng = side.engine(max_batch=1)
    ra = eng.submit(pa, max_new=20)
    rb = eng.submit(pb, max_new=20)
    eng.step()
    eng.step()
    assert eng.cancel(rb)          # still queued: exits empty-handed
    assert eng.cancel(ra)          # in flight: partial output kept
    assert not eng.cancel(999)     # unknown rid
    assert not eng.cancel(ra)      # already retired
    res = _drain(eng)
    assert res[ra].finish_reason == FR.CANCELLED
    assert len(res[ra].generated) > 0
    assert res[rb].finish_reason == FR.CANCELLED
    assert res[rb].generated == []
    assert eng.stats.cancelled == 2
    assert eng.pool.num_free == eng.pool.n_pages - 1
    return _outcome(res, [ra, rb]), _counters(eng)


def test_cancel_queued_and_inflight(sides):
    _both(sides, _cancel)


def _whole_prefill_cancel_deadline(side):
    """SSM prefill is not chunkable; deadlines and cancellation must still
    work through the inline whole-prompt admission path."""
    FR = side.FR
    pa, pb = _prompts(side, ["state space aa", "state space bb"])
    chaos = side.chaos(schedule={"clock.skew": {4}}, skew_s=1000.0)
    eng = side.engine(max_batch=1, chaos=chaos)
    assert eng.radix is None
    ra = eng.submit(pa, max_new=30)
    rb = eng.submit(pb, max_new=30, deadline_s=500.0)  # expires at the skew (tick 4)
    eng.step()
    assert eng.cancel(ra)          # in flight (decoding after whole prefill)
    res = _drain(eng)
    assert res[ra].finish_reason == FR.CANCELLED
    assert len(res[ra].generated) > 0
    assert res[rb].finish_reason == FR.DEADLINE
    assert eng.stats.cancelled == 1 and eng.stats.deadline_expired == 1
    assert eng.pool.num_free == eng.pool.n_pages - 1
    return _outcome(res, [ra, rb]), _counters(eng), list(chaos.events)


def test_whole_prefill_models_cancel_and_deadline(mamba_sides):
    _both(mamba_sides, _whole_prefill_cancel_deadline)


# ---------------------------------------------------------------------------
# Admission: impossible requests still raise, even with preemption on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["off", "recompute"])
def test_submit_time_capacity_errors_with_preemption(sides, mode):
    for side in sides:
        eng = side.engine(max_len=64, max_batch=1, n_pages=3, preemption=mode)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(list(range(40)), max_new=32)
        with pytest.raises(ValueError, match="pool capacity"):
            eng.submit(list(range(20)), max_new=20)  # 3 pages > 2 usable


def test_config_checks_match_jax(sides):
    """The resilience fields of ``EngineConfig`` take and refuse what the
    JAX config takes and refuses."""
    for side in sides:
        EC = side.mod.EngineConfig
        with pytest.raises(ValueError, match="preemption"):
            EC(preemption="sometimes")
        with pytest.raises(ValueError, match="deadline_s"):
            EC(deadline_s=-1.0)
        c = EC(max_queue=3, deadline_s=2.5, preemption="drop")
        assert (c.max_queue, c.deadline_s, c.preemption) == (3, 2.5, "drop")
        assert EC().max_queue == 1024 and EC().preemption == "off"


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

def _recompute(side):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, side.cfg.vocab_size, 16).tolist() for _ in range(2)]
    big = side.engine(max_len=64, max_batch=2, prefix_cache=False)
    want, _ = big.generate(prompts, max_new=20)
    small = side.engine(max_len=64, max_batch=2, n_pages=4, prefix_cache=False,
                        preemption="recompute")
    rids = [small.submit(p, max_new=20) for p in prompts]
    res = _drain(small)
    assert small.stats.preempted >= 1
    for rid, p, w in zip(rids, prompts, want):
        assert res[rid].ok
        assert p + res[rid].generated == w   # bit-identical to no-pressure run
    assert small.pool.num_free == small.pool.n_pages - 1
    return _outcome(res, rids), _counters(small), want


def test_preemption_recompute_bit_parity(sides):
    """Greedy tokens after a recompute preemption equal the never-preempted
    run's and the JAX engine's."""
    _both(sides, _recompute)


def _drop(side):
    FR = side.FR
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, side.cfg.vocab_size, 16).tolist() for _ in range(2)]
    eng = side.engine(max_len=64, max_batch=2, n_pages=4, prefix_cache=False,
                      preemption="drop")
    rids = [eng.submit(p, max_new=20) for p in prompts]
    res = _drain(eng)
    assert eng.stats.preempted == 1
    assert sorted(res[r].finish_reason.value for r in rids) == ["length", "preempted"]
    dropped = next(r for r in rids if res[r].finish_reason == FR.PREEMPTED)
    assert not res[dropped].ok
    assert eng.pool.num_free == eng.pool.n_pages - 1
    return _outcome(res, rids), _counters(eng), dropped


def test_preemption_drop_sheds_lowest_priority(sides):
    """``preemption="drop"`` sheds the same victim, with the same partial
    output, as the JAX engine."""
    _both(sides, _drop)


def _victim(side):
    FR = side.FR
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, side.cfg.vocab_size, 16).tolist() for _ in range(3)]
    eng = side.engine(max_len=32, max_batch=3, n_pages=6, prefix_cache=False,
                      preemption="drop")
    rids = [eng.submit(p, max_new=8) for p in prompts]
    res = _drain(eng)
    assert eng.stats.preempted == 1
    assert res[rids[2]].finish_reason == FR.PREEMPTED
    assert res[rids[0]].ok and res[rids[1]].ok
    return _outcome(res, rids), _counters(eng)


def test_victim_policy_prefers_fewest_tokens_latest_arrival(sides):
    _both(sides, _victim)


def _overrun(side):
    FR = side.FR
    eng = side.engine(max_len=32, max_batch=1, preemption="recompute")
    rid = eng.submit(_prompts(side, ["overrun"])[0], max_new=8)
    eng.step()
    assert eng.num_active == 1
    eng.sched.remaining[0] = 1000  # corrupted length accounting
    res = _drain(eng)              # must not raise
    assert eng.stats.preempted >= 1
    assert res[rid].finish_reason == FR.PREEMPTED
    assert eng.pool.num_free == eng.pool.n_pages - 1
    return _outcome(res, [rid]), _counters(eng)


def test_capacity_overrun_degrades_instead_of_raising(sides):
    _both(sides, _overrun)


# ---------------------------------------------------------------------------
# Fault isolation
# ---------------------------------------------------------------------------

def _fault(side):
    FR = side.FR
    pa, pb = _prompts(side, ["poison target!", "healthy neighbor"])
    healthy = side.engine(max_batch=2, prefix_cache=False)
    want, _ = healthy.generate([pa, pb], max_new=8)
    chaos = side.chaos(schedule={"logits.nan": {2}})
    eng = side.engine(max_batch=2, prefix_cache=False, chaos=chaos)
    ra = eng.submit(pa, max_new=8)   # lowest slot index: the nan target
    rb = eng.submit(pb, max_new=8)
    res = _drain(eng)
    assert res[ra].finish_reason == FR.FAULT and not res[ra].ok
    assert len(res[ra].generated) < 8          # truncated at the bad step
    assert res[rb].finish_reason == FR.LENGTH
    assert pb + res[rb].generated == want[1]   # neighbour unaffected
    assert eng.stats.faults_isolated == 1
    assert eng.pool.num_free == eng.pool.n_pages - 1
    return _outcome(res, [ra, rb]), _counters(eng), list(chaos.events)


def test_fault_isolates_poisoned_slot_only(sides):
    """An injected NaN retires only the poisoned slot, as FAULT, with the
    tokens it had before; the neighbour's output is the healthy run's."""
    _both(sides, _fault)


def test_non_finite_weights_fault_only_the_poisoned_request(sides):
    """A real non-finite value (no chaos): a prompt token whose embedding row
    is NaN poisons only its own request, which retires FAULT on its chunk,
    while the neighbour decodes to the healthy run's tokens."""
    def run(side, poison):
        params = side.params
        if poison:
            emb = np.array(params["embed"], dtype=np.float32)
            emb[7] = np.nan
            if side.name == "jax":
                params = dict(params, embed=jax.numpy.asarray(emb, params["embed"].dtype))
            else:
                params = dict(params, embed=torch.from_numpy(emb).to(params["embed"].dtype))
        eng = side.mod.Engine(side.cfg, params, side.mod.EngineConfig(
            max_len=96, page_size=16, decode_chunk=4, max_batch=2, prefix_cache=False),
            **side.engine_kw)
        rb = eng.submit([9, 10, 11], max_new=6)  # admitted first: own pages
        ra = eng.submit([1, 2, 3, 7, 5], max_new=6)
        res = _drain(eng)
        return _outcome(res, [ra, rb]), _counters(eng)

    for side in sides:
        (a, b), counters = run(side, True)
        assert a == ("fault", []) and b[0] == "length"
        assert counters[-1] == 1
        assert b == run(side, False)[0][1]
    assert run(sides[1], True) == run(sides[0], True)


# ---------------------------------------------------------------------------
# Shutdown
# ---------------------------------------------------------------------------

def _close(side):
    FR = side.FR
    pa, pb = _prompts(side, ["close one", "close two"])
    eng = side.engine(max_batch=1)
    ra = eng.submit(pa, max_new=20)
    rb = eng.submit(pb, max_new=20)
    eng.step()
    eng.step()
    res = {r.rid: r for r in eng.close()}
    assert res[ra].finish_reason == FR.CANCELLED
    assert len(res[ra].generated) > 0          # partial output preserved
    assert res[rb].finish_reason == FR.CANCELLED
    assert eng.stats.cancelled == 2
    assert eng.pool.num_free == eng.pool.n_pages - 1
    assert eng.close() == []                   # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(pa, max_new=4)
    with pytest.raises(RuntimeError, match="closed"):
        eng.step()
    return _outcome(res, [ra, rb]), _counters(eng)


def test_close_retires_inflight_and_reconciles(sides):
    _both(sides, _close)


def _context(side):
    rng = np.random.RandomState(3)
    prefix = rng.randint(1, side.cfg.vocab_size, 32).tolist()
    prompts = [prefix + rng.randint(1, side.cfg.vocab_size, 4).tolist()
               for _ in range(3)]
    with side.engine(max_batch=2, preemption="recompute") as eng:
        out, _ = eng.generate(prompts[:2], max_new=4)   # publishes prefix pages
        eng.submit(prompts[2], max_new=20)
        eng.step()
        pool = eng.pool
    assert eng._closed
    assert pool.num_free == pool.n_pages - 1
    return out, _counters(eng)


def test_context_manager_closes_with_radix_state(sides):
    _both(sides, _context)


# ---------------------------------------------------------------------------
# Counters: exactly once per event, chunked and unchunked
# ---------------------------------------------------------------------------

def _counters_once(side, chunk_tokens):
    FR = side.FR
    rng = np.random.RandomState(4)
    mk = lambda: rng.randint(1, side.cfg.vocab_size, 20).tolist()  # noqa: E731
    chaos = side.chaos(schedule={"logits.nan": {2}, "clock.skew": {6}}, skew_s=1000.0)
    eng = side.engine(max_batch=1, max_queue=2, prefix_cache=False,
                      chunk_tokens=chunk_tokens, chaos=chaos)
    ra = eng.submit(mk(), max_new=6)                    # will FAULT (tick 2)
    rb = eng.submit(mk(), max_new=6)                    # cancelled in queue
    rc = eng.submit(mk(), max_new=6)                    # queue full: REJECTED
    assert eng.cancel(rb)
    rd = eng.submit(mk(), max_new=30, deadline_s=500.0)  # expires at tick 6
    res = _drain(eng)
    assert res[ra].finish_reason == FR.FAULT
    assert res[rb].finish_reason == FR.CANCELLED
    assert res[rc].finish_reason == FR.REJECTED
    assert res[rc].retry_after_s > 0
    assert res[rd].finish_reason == FR.DEADLINE
    s = eng.stats
    assert (s.rejected, s.cancelled, s.faults_isolated,
            s.deadline_expired, s.preempted) == (1, 1, 1, 1, 0)
    assert len(res) == 4
    assert eng.pool.num_free == eng.pool.n_pages - 1
    return _outcome(res, [ra, rb, rc, rd]), _counters(eng), list(chaos.events)


@pytest.mark.parametrize("chunk_tokens", [None, 8])
def test_counters_increment_exactly_once(sides, chunk_tokens):
    """Every degraded exit increments exactly one counter, on both prefill
    paths, as in the JAX engine."""
    _both(sides, _counters_once, chunk_tokens)


# ---------------------------------------------------------------------------
# Chaos: injector unit behaviour (no engine)
# ---------------------------------------------------------------------------

def _injector(side):
    with pytest.raises(ValueError):
        side.chaos(schedule={"no.such.point": {0}})
    ch = side.chaos(seed=7, schedule={"pool.alloc": {1, 3}},
                    rates={"logits.nan": 0.5}, skew_s=10.0)
    assert [ch.fire("pool.alloc") for _ in range(5)] == [False, True, False, True, False]
    assert ch.count("pool.alloc") == 2
    with pytest.raises(ValueError):
        ch.fire("bogus")
    before = ch.now()
    assert not ch.fire("clock.skew")  # not scheduled, no rate
    ch.schedule["clock.skew"] = frozenset({1})
    assert ch.fire("clock.skew")
    assert ch.now() - before >= 10.0
    assert ("clock.skew", 1) in ch.events
    # a seeded storm over every point: the consults that fire
    storm = side.chaos(seed=123, rates={"pool.alloc": 0.15, "runner.mixed": 0.15,
                                        "logits.nan": 0.1, "clock.skew": 0.3},
                       schedule={"clock.skew": {25}})
    fired = [(p, storm.fire(p)) for _ in range(60) for p in side.mod.FAULT_POINTS]
    return list(ch.events), fired, list(storm.events), storm.skew


def test_injector_schedule_rates_and_clock(sides):
    """Same seed and schedule: the same consults fire as in JAX's injector."""
    _, fired, events, _ = _both(sides, _injector)
    assert any(hit for _, hit in fired) and len(events) > 4


# ---------------------------------------------------------------------------
# Chaos: transient faults leave outputs bit-identical
# ---------------------------------------------------------------------------

def _run(side, prompts, max_new=10, chaos=None, **ekw):
    eng = side.engine(chaos=chaos, **ekw)
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = _drain(eng)
    assert _reconciled(side, eng)
    return eng, [res[r] for r in rids]


def _pool_alloc(side):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, side.cfg.vocab_size, 16).tolist() for _ in range(3)]
    kw = dict(max_batch=2, prefix_cache=False, preemption="recompute")
    _, want = _run(side, prompts, **kw)
    chaos = side.chaos(seed=11, rates={"pool.alloc": 0.3})
    eng, got = _run(side, prompts, chaos=chaos, **kw)
    assert chaos.count("pool.alloc") > 0  # the storm actually fired
    for w, g in zip(want, got):
        assert g.ok and g.generated == w.generated
    return [g.generated for g in got], _counters(eng), list(chaos.events)


def test_pool_alloc_faults_are_survived(sides):
    _both(sides, _pool_alloc)


def _mixed_retry(side):
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, side.cfg.vocab_size, 20).tolist() for _ in range(2)]
    kw = dict(max_batch=2, chunk_tokens=8, prefix_cache=False)
    _, want = _run(side, prompts, **kw)
    chaos = side.chaos(schedule={"runner.mixed": {0, 2, 3}})
    eng, got = _run(side, prompts, chaos=chaos, **kw)
    assert chaos.count("runner.mixed") == 3
    for w, g in zip(want, got):
        assert g.ok and g.generated == w.generated
    return [g.generated for g in got], list(chaos.events)


def test_mixed_tick_transient_failures_retry(sides):
    _both(sides, _mixed_retry)


def _escapes_nothing(side):
    chaos = side.chaos(rates={"runner.mixed": 1.0})
    eng = side.engine(max_batch=1, chaos=chaos)
    eng.submit(list(range(1, 9)), max_new=4)
    for _ in range(5):
        eng.step()  # every tick is injected-failed; nothing dispatches
    assert eng.stats.tokens_out == 0
    res = eng.close()
    assert [r.finish_reason for r in res] == [side.FR.CANCELLED]
    return [r.finish_reason.value for r in res], list(chaos.events)


def test_chaos_error_escapes_nothing(sides):
    _both(sides, _escapes_nothing)


def _shared_prefix_resume(side):
    rng = np.random.RandomState(2)
    prefix = rng.randint(1, side.cfg.vocab_size, 32).tolist()
    prompts = [prefix + rng.randint(1, side.cfg.vocab_size, 4).tolist()
               for _ in range(3)]
    kw = dict(max_batch=3, prefix_cache=True)
    _, want = _run(side, prompts, max_new=16, **kw)
    eng, got = _run(side, prompts, max_new=16, n_pages=8, preemption="recompute", **kw)
    assert eng.stats.preempted >= 1  # the small pool actually preempted
    assert eng.prefix_hit_rate > 0.0
    for w, g in zip(want, got):
        assert g.ok and g.generated == w.generated
    return [g.generated for g in got], _counters(eng), eng.stats.prefix_hit_tokens


def test_preempt_resume_with_shared_prefix_pages(sides):
    _both(sides, _shared_prefix_resume)


# ---------------------------------------------------------------------------
# Chaos: the seeded storm, everything at once
# ---------------------------------------------------------------------------

def _storm(side, seed):
    rng = np.random.RandomState(3)  # same workload every run
    prompts = [rng.randint(1, side.cfg.vocab_size, 16).tolist() for _ in range(5)]
    chaos = side.chaos(seed=seed, rates={"pool.alloc": 0.15, "runner.mixed": 0.15,
                                         "logits.nan": 0.1},
                       schedule={"clock.skew": {25}}, skew_s=30.0)
    eng = side.engine(max_batch=2, n_pages=6, max_queue=3, prefix_cache=False,
                      preemption="recompute", chaos=chaos)
    rids = [eng.submit(p, max_new=8, deadline_s=600.0) for p in prompts]
    res = _drain(eng)
    assert _reconciled(side, eng)
    assert set(res) == set(rids)  # no request lost, none invented
    assert eng.close() == []
    return _outcome(res, rids), list(chaos.events), _counters(eng)


def test_seeded_storm_is_deterministic_and_lossless(sides):
    """The port's storm is the same twice and the same as JAX's storm:
    events, finish reasons, tokens and counters."""
    tside = sides[1]
    out1 = _both(sides, _storm, 123)
    assert _storm(tside, 123) == out1
    assert len(out1[1]) > 0
    out3 = _storm(tside, 124)
    assert out3[1] != out1[1]  # a different seed draws a different storm
    reasons = {r for r, _ in out1[0]}
    assert reasons <= {f.value for f in TS.FinishReason}
    if out1[2][-1] == 0:
        assert "fault" not in reasons


def test_fault_points_catalog_is_closed():
    assert TS.FAULT_POINTS == JS.FAULT_POINTS == (
        "pool.alloc", "runner.mixed", "logits.nan", "clock.skew")
    assert issubclass(TS.ChaosError, RuntimeError)


# ---------------------------------------------------------------------------
# The decode step the engine replays, and one quantize per activation
# ---------------------------------------------------------------------------

def test_decode_graph_runs_decode_step_on_the_cpu(sides):
    """On the CPU ``DecodeGraph.run`` is ``model.decode_step`` eagerly: the
    same logits from the static buffers, rows in ``nanmask`` all NaN and
    flagged, and the KV row written in place."""
    side = sides[1]
    cfg, params = side.cfg, side.params
    B, ps, npp = 2, 16, 4
    caches = TM.init_paged_cache(cfg, B, B * npp + 1, ps, device="cpu")
    ref_caches = TM.init_paged_cache(cfg, B, B * npp + 1, ps, device="cpu")
    pages = torch.arange(1, B * npp + 1, dtype=torch.int32).reshape(B, npp)
    cur = torch.tensor([5, 9], dtype=torch.int32)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    g = DecodeGraph(cfg, params, caches, B, npp, device="cpu")
    g.load(cur, pos, pages, np.array([False, True]))
    lf, finite = g.run()
    want, _ = TM.decode_step(cfg, params, ref_caches, cur[:, None], pos, pages=pages)
    assert torch.equal(lf[0], want[0, -1, : cfg.vocab_size])
    assert torch.isnan(lf[1]).all()
    assert finite.tolist() == [True, False]
    for a, b in zip(_leaves(caches), _leaves(ref_caches)):
        assert torch.equal(a, b)
    assert g.replays == 0 and g.graph is None  # nothing captured off the card


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_shared_quantize_is_bit_equal_to_separate_projections(sides):
    """w8a8: one ``quantize_act`` shared by wq/wk/wv (w_gate/w_up) gives
    outputs bit-equal to separate ``dense_proj`` calls on the float input,
    and ``_qkv`` / ``ffn_forward`` quantize each distinct activation once
    (one ``quantize_rows`` for q/k/v, one for gate/up, one for w_down)."""
    side = sides[1]
    cfg = side.cfg
    qp = TM.quantize_params(cfg, side.params)
    layer = TM._unstack(qp["stages"][0], 1)[0]["0"]
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 3, cfg.d_model)
                         .astype(np.float32)).to(cfg.compute_dtype)
    xq = quantize_act(x)
    for name, p in (("wq", layer["mixer"]), ("wk", layer["mixer"]), ("wv", layer["mixer"]),
                    ("w_gate", layer["ffn"]), ("w_up", layer["ffn"])):
        assert torch.equal(cgra_gemm_w8a8(xq, p[name], out_dtype=cfg.compute_dtype),
                           TL.dense_proj(cfg, x, p[name]))
    H, K, dh = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    calls = []
    orig = TG.quantize_rows

    def counting(v):
        calls.append(tuple(v.shape))
        return orig(v)
    TG.quantize_rows = counting
    try:
        q, k, v = TL._qkv(cfg, layer["mixer"], x)
        ffn = TL.ffn_forward(cfg, layer["ffn"], x)
    finally:
        TG.quantize_rows = orig
    assert len(calls) == 3  # one for q/k/v, one for gate/up, one for w_down
    m = layer["mixer"]
    assert torch.equal(q, TL.dense_proj(cfg, x, m["wq"], (H, dh)))
    assert torch.equal(k, TL.dense_proj(cfg, x, m["wk"], (K, dh)))
    assert torch.equal(v, TL.dense_proj(cfg, x, m["wv"], (K, dh)))
    f = layer["ffn"]
    g, u = TL.dense_proj(cfg, x, f["w_gate"]), TL.dense_proj(cfg, x, f["w_up"])
    assert torch.equal(ffn, TL.dense_proj(cfg, torch.nn.functional.silu(g) * u,
                                          f["w_down"]))
