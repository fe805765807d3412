"""The traffic generator: deterministic per seed, within its stated
ranges, and the same set of sizes under every seed."""
import numpy as np
import pytest

from bench.lib import registry
from bench.lib.traffic import Traffic, draw_lengths, rng

MIXES = ["chat_shared", "chat_short"]
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = registry.traffic(mix)
    a, b = Traffic(m, BIG, 50304), Traffic(m, BIG, 50304)
    for c in range(m["clients"]):
        for k in range(3):
            ra, rb = a.next(c), b.next(c)
            assert ra.prompt == rb.prompt and ra.max_new == rb.max_new


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_order_same_sizes(mix):
    m = registry.traffic(mix)
    a, b = Traffic(m, 7, 50304), Traffic(m, 8, 50304)
    assert (a.user_len == b.user_len).all() and (a.out_len == b.out_len).all()
    sa = [a.request(c, 0) for c in range(m["clients"])]
    sb = [b.request(c, 0) for c in range(m["clients"])]
    assert [s.prompt for s in sa] != [s.prompt for s in sb]
    pool = set(a.out_len.tolist())
    assert all(s.max_new in pool for s in sa + sb)


@pytest.mark.parametrize("mix", MIXES)
def test_any_stretch_of_requests_does_the_pools_work(mix):
    """100 consecutive requests of any seed, from any point, carry the
    pool's mean lengths within 6 %: the seed orders the work, it does not
    change it (a shuffle of the lognormal pool strays by 9 % as one
    standard deviation at 100)."""
    m = registry.traffic(mix)
    C = m["clients"]
    for seed in (1, 2, 2 ** 40 + 7):
        t = Traffic(m, seed, 50304)
        for start in (0, 37, 501):
            reqs = [t.request(i % C, i // C) for i in range(start, start + 100)]
            pre = m["prefix_tokens"] if m["shared_prefixes"] else 0
            user = np.mean([len(r.prompt) - pre for r in reqs])
            out = np.mean([r.max_new for r in reqs])
            assert abs(user / t.user_len.mean() - 1) < 0.06
            assert abs(out / t.out_len.mean() - 1) < 0.06


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_within_stated_ranges(mix):
    m = registry.traffic(mix)
    t = Traffic(m, 3, 73448)
    pre = m["prefix_tokens"] if m["shared_prefixes"] else 0
    for c in range(m["clients"]):
        for k in range(8):
            r = t.request(c, k)
            user = len(r.prompt) - pre
            assert m["prompt_tokens"]["min"] <= user <= m["prompt_tokens"]["max"]
            assert m["output_tokens"]["min"] <= r.max_new <= m["output_tokens"]["max"]
            assert all(0 <= x < 73448 for x in r.prompt)
    med = np.median(t.user_len)
    assert 0.8 * m["prompt_tokens"]["median"] <= med <= 1.2 * m["prompt_tokens"]["median"]


def test_shared_prefixes_are_shared_by_their_clients():
    m = registry.traffic("chat_shared")
    t = Traffic(m, 11, 50304)
    P, n = m["shared_prefixes"], m["prefix_tokens"]
    firsts = [t.request(c, 0).prompt[:n] for c in range(m["clients"])]
    for c in range(m["clients"]):
        assert firsts[c] == firsts[c % P]
    assert len({tuple(f) for f in firsts}) == P


def test_seeds_of_any_size_and_sign():
    for s in (0, 1, -1, 2 ** 31, 2 ** 40 + 3, -(2 ** 63)):
        rng(s).integers(0, 10)
    assert rng(2 ** 32).integers(0, 2 ** 30) != rng(0).integers(0, 2 ** 30)


def test_uniform_and_lognormal_clip():
    g = np.random.default_rng(0)
    u = draw_lengths({"dist": "uniform", "min": 3, "max": 5}, 1000, g)
    assert set(u.tolist()) == {3, 4, 5}
    ln = draw_lengths({"dist": "lognormal", "median": 100, "sigma": 3, "min": 10, "max": 200},
                      1000, g)
    assert ln.min() == 10 and ln.max() == 200
