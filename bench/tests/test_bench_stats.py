"""Rate and tail arithmetic: over every request and the whole window, so
that a stall injected into synthetic records moves it."""
import math

import pytest

from bench.lib import registry
from bench.lib.serve import ServeRun, live_rows
from bench.lib.stats import RequestRecord, percentile, rate


def _records(n=100, stall_at=None, stall=0.0):
    """n requests sent 0.1 s apart, first token after 50 ms, 10 tokens 20 ms
    apart; a stall of ``stall`` s delays every request from ``stall_at`` on."""
    out = []
    for i in range(n):
        d = stall if stall_at is not None and i >= stall_at else 0.0
        sent = 0.1 * i
        first = sent + 0.05 + d
        out.append(RequestRecord(sent, first, first + 0.18, 10, True))
    return out


def _run(records, tokens=1000, window=10.0):
    run = ServeRun("serve", {}, {}, None, {"max_batch": 8})
    run.requests, run.tokens_out, run.window_s = records, tokens, window
    return run


def _read(name, run):
    return registry.metric(name).read(run)


def test_percentile_matches_numpy_linear():
    import numpy as np
    xs = [float(x) for x in np.random.default_rng(0).exponential(size=101)]
    for q in (50, 90, 99):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_ttft_and_tpot_of_steady_records():
    run = _run(_records())
    assert _read("ttft_p90_ms", run) == pytest.approx(50.0)
    assert _read("tpot_p90_ms", run) == pytest.approx(20.0)


def test_a_stall_in_a_tenth_of_requests_moves_the_p90():
    base = _read("ttft_p90_ms", _run(_records()))
    stalled = _read("ttft_p90_ms", _run(_records(stall_at=89, stall=1.0)))
    assert stalled > base + 900
    # a stall in fewer requests than the tail holds leaves p90 alone: it is a tail, not a mean
    assert _read("ttft_p90_ms", _run(_records(stall_at=99, stall=1.0))) == pytest.approx(base)


def test_missing_requests_are_infinite_latencies():
    recs = _records()
    for r in recs[:11]:
        r.ok = False
    assert math.isinf(_read("ttft_p90_ms", _run(recs)))
    assert math.isinf(_read("tpot_p90_ms", _run(recs)))
    assert math.isfinite(_read("ttft_p90_ms", _run(_records()[:]))) 


def test_rate_is_all_tokens_over_all_the_window():
    assert _read("output_tokens_per_s", _run(_records(), tokens=1234, window=10.0)) == 123.4
    # a stall lengthens the window: the same tokens over more seconds
    assert _read("output_tokens_per_s", _run(_records(), tokens=1234, window=12.0)) < 123.4
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_live_rows_counts_each_slot_until_its_budget():
    per_step, kv = live_rows([10, 5, 0], [3, 1, 0], 2)
    assert per_step == [2, 1]
    assert kv == (11 + 12) + 6
