"""The port's paged serving engine against the JAX ``Engine`` on the same
weights and prompts (CPU, plain kernel versions).

Greedy tokens must be identical — token for token — for ``chunk_tokens``
in {8, 32, None}, with radix prefix hits (full pages shared by reference,
a partial page copy-on-write), and the page pool must reconcile after
``run()``.  ``tests/test_serving.py`` and ``tests/test_chunked_prefill.py``
are the templates."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
import repro_torch.configs as TC
from repro_torch.models import bridge
from repro_torch.serving import (Engine, EngineConfig, FinishReason,
                                 bytes_tokenizer_encode, check_invariants)


def _load(name):
    jcfg = JC.reduce_config(JC.get_config(name))
    tcfg = TC.reduce_config(TC.get_config(name))
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, bridge.params_from_numpy(
        tcfg, _flatten(params), device="cpu")


@pytest.fixture(scope="module")
def olmo():
    return _load("olmo-1b")


@pytest.fixture(scope="module")
def deepseek():
    return _load("deepseek-67b")


def _kw(**kw):
    kw.setdefault("max_len", 96)
    kw.setdefault("page_size", 16)
    kw.setdefault("decode_chunk", 4)
    return kw


def _both(pair, prompts, max_new, **kw):
    """(JAX sequences, port sequences, port engine) for one closed batch."""
    jcfg, tcfg, params, tparams = pair
    jout, jstats = JEngine(jcfg, params, JEngineConfig(**_kw(**kw))).generate(
        prompts, max_new=max_new)
    eng = Engine(tcfg, tparams, EngineConfig(**_kw(**kw)), device="cpu")
    tout, tstats = eng.generate(prompts, max_new=max_new)
    assert tstats.prefix_hit_tokens == jstats.prefix_hit_tokens
    assert tstats.prefills == jstats.prefills == len(prompts)
    return jout, tout, eng


def _prefix_prompts(V, seed=0):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(3, V, 40).tolist()  # 2.5 pages of 16
    return [prefix + [1] * 8,                # exactly 3 full pages
            rng.randint(1, V, 5).tolist(),
            prefix + [2] * 6,                # shares 2 pages + 8 rows (COW)
            rng.randint(1, V, 30).tolist()]


@pytest.mark.parametrize("chunk_tokens", [8, 32, None])
def test_greedy_matches_jax_engine(olmo, chunk_tokens):
    """Identical greedy tokens for every chunk schedule, including the
    radix hit (2 full pages + an 8-row copy-on-write share); the pool
    reconciles after the run."""
    prompts = _prefix_prompts(olmo[0].vocab_size)
    jout, tout, eng = _both(olmo, prompts, 6, max_batch=3,
                            chunk_tokens=chunk_tokens)
    assert tout == jout
    assert eng.stats.prefix_hit_tokens == 40
    assert check_invariants(eng.pool, eng.radix, tables=eng.sched.owned) == []
    assert eng.num_active == 0 and eng.pool.num_used == len(
        [n for n in _radix_pages(eng)])


def _radix_pages(eng):
    stack, out = list(eng.radix.root.children.values()), []
    while stack:
        n = stack.pop()
        out.append(n.page)
        stack.extend(n.children.values())
    return out


def test_greedy_matches_jax_engine_gqa(deepseek):
    """GQA (4 query heads over 2 kv-heads) through the whole engine."""
    prompts = [bytes_tokenizer_encode(t, 256) for t in
               ("hello world", "x", "a prompt long enough to span chunks")]
    jout, tout, _ = _both(deepseek, prompts, 5, max_batch=2, chunk_tokens=8)
    assert tout == jout


def test_radix_hit_lands_mid_chunk(olmo):
    """Follow-up requests whose prefix hit is not chunk-aligned (a full
    page, and a copy-on-write share of 10 rows) still match JAX."""
    jcfg, tcfg, params, tparams = olmo
    rng = np.random.RandomState(7)
    base = rng.randint(1, 256, 20).tolist()
    follow = [base[:16] + rng.randint(1, 256, 9).tolist(),
              base[:10] + rng.randint(1, 256, 7).tolist()]
    kw = _kw(max_batch=2, chunk_tokens=32)
    je = JEngine(jcfg, params, JEngineConfig(**kw))
    te = Engine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    for eng in (je, te):
        eng.generate([base], max_new=4)
    jout, _ = je.generate(follow, max_new=4)
    tout, _ = te.generate(follow, max_new=4)
    assert tout == jout
    assert te.stats.prefix_hit_tokens == je.stats.prefix_hit_tokens >= 26
    assert check_invariants(te.pool, te.radix, tables=te.sched.owned) == []


def test_decode_retires_on_mixed_tick(olmo):
    """A decoding slot that finishes on a tick that also runs a prompt
    chunk retires that tick; both outputs match JAX."""
    jcfg, tcfg, params, tparams = olmo
    short = bytes_tokenizer_encode("hi", 256)
    long = bytes_tokenizer_encode("a sixty-ish byte prompt padded " + "y" * 30, 256)
    kw = _kw(max_batch=2, chunk_tokens=8)
    results = []
    for eng in (JEngine(jcfg, params, JEngineConfig(**kw)),
                Engine(tcfg, tparams, EngineConfig(**kw), device="cpu")):
        ra = eng.submit(short, max_new=2)
        eng.step()
        rb = eng.submit(long, max_new=3)
        mixed = eng.step()
        assert [r.rid for r in mixed] == [ra]
        done = {r.rid: r for r in mixed}
        while eng.num_active or eng.num_queued:
            done.update({r.rid: r for r in eng.step()})
        results.append((done[ra].generated, done[rb].generated))
    assert results[0] == results[1]


def test_eos_stops_like_jax(olmo):
    """With ``eos_id`` set to a token the model emits, requests retire
    STOP at the same token as the JAX engine."""
    jcfg, tcfg, params, tparams = olmo
    prompts = [bytes_tokenizer_encode(t, 256) for t in ("alpha", "beta gamma")]
    free, _ = JEngine(jcfg, params, JEngineConfig(**_kw())).generate(
        prompts, max_new=8)
    eos = free[0][len(prompts[0]) + 2]  # the first prompt's third token
    kw = _kw(eos_id=int(eos))
    je = JEngine(jcfg, params, JEngineConfig(**kw))
    te = Engine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    for p in prompts:
        je.submit(p, max_new=8)
        te.submit(p, max_new=8)
    jr = sorted(je.run(), key=lambda r: r.rid)
    tr = sorted(te.run(), key=lambda r: r.rid)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert tr[0].finish_reason == FinishReason.STOP
    assert tr[0].generated[-1] == eos
    assert [r.finish_reason.value for r in tr] == [r.finish_reason.value for r in jr]


def test_solo_equals_batched_greedy(olmo):
    """A request's greedy tokens do not depend on what shares its batch."""
    _, tcfg, _, tparams = olmo
    prompts = _prefix_prompts(tcfg.vocab_size, seed=3)
    kw = EngineConfig(**_kw(max_batch=4, chunk_tokens=8))
    batched, _ = Engine(tcfg, tparams, kw, device="cpu").generate(prompts, 5)
    for p, seq in zip(prompts, batched):
        solo, _ = Engine(tcfg, tparams, kw, device="cpu").generate([p], 5)
        assert solo[0] == seq


def test_temperature_sampling_is_seeded(olmo):
    """Temperature > 0 draws from a per-request generator: the same seed
    gives the same tokens, in any batch; the JAX streams are not
    reproduced (different PRNG), only self-determinism is asked."""
    _, tcfg, _, tparams = olmo
    p = bytes_tokenizer_encode("sample me", 256)
    kw = EngineConfig(**_kw(max_batch=3, chunk_tokens=8))

    def run(seed, others=()):
        eng = Engine(tcfg, tparams, kw, device="cpu")
        rid = eng.submit(p, max_new=12, temperature=1.5, seed=seed)
        for o in others:
            eng.submit(o, max_new=6)
        return next(r for r in eng.run() if r.rid == rid).generated

    a = run(11)
    assert a == run(11)
    assert a == run(11, others=[[5, 6, 7], [9] * 20])
    assert a != run(12)
    greedy, _ = Engine(tcfg, tparams, kw, device="cpu").generate([p], 12)
    assert a != greedy[0][len(p):]


def test_submit_validation(olmo):
    _, tcfg, _, tparams = olmo
    eng = Engine(tcfg, tparams, EngineConfig(**_kw(max_batch=1)), device="cpu")
    for bad, match in ((dict(prompt=[]), "empty prompt"),
                       (dict(prompt=[1, 2], max_new=0), "max_new"),
                       (dict(prompt=[1, 2], max_new=2.5), "max_new"),
                       (dict(prompt=[1, 256]), "tokens"),
                       (dict(prompt=[1, -1]), "tokens"),
                       (dict(prompt=[1, 2], temperature=-0.5), "temperature"),
                       (dict(prompt=[1] * 90, max_new=8), "max_len")):
        with pytest.raises(ValueError, match=match):
            eng.submit(**bad)
    assert eng.num_queued == 0
    eng.submit([1, 2], max_new=4)
    (r,) = eng.run()
    assert r.finish_reason == FinishReason.LENGTH and len(r.generated) == 4


def test_engine_config_validation():
    with pytest.raises(ValueError, match="page_size"):
        EngineConfig(page_size=12)
    with pytest.raises(ValueError, match="chunk_tokens"):
        EngineConfig(chunk_tokens=0)
    c = EngineConfig(max_len=100, page_size=16, max_batch=2)
    assert c.max_len == 112 and c.n_pages == 2 * 7 + 1
    assert c.cache_spec().pages_per_seq == 7


def test_engine_refuses_params_on_another_device(olmo):
    _, tcfg, _, tparams = olmo
    with pytest.raises(ValueError, match="params live on"):
        Engine(tcfg, tparams, EngineConfig(**_kw()), device=torch.device("meta"))
