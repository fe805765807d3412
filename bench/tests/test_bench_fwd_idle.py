"""The two readers of the card's idle time inside the program's forward
ranges (``chunk_fwd_idle_ms``: ``serve.chunk_forward``; ``whole_fwd_idle_ms``:
``serve.whole_forward``) on a synthetic trace, against sums made by hand;
nothing to read (no trace, no such range, a training run, a range outside
the slice) reads None."""
import pytest

from bench.lib import registry
from bench.lib.serve import ServeRun
from bench.lib.trace import TraceData

READERS = {"chunk_fwd_idle_ms": "serve.chunk_forward",
           "whole_fwd_idle_ms": "serve.whole_forward"}


def _trace(rng: str) -> TraceData:
    """A 0-100 ms slice (microseconds) with two device spans of ``rng``:
    [10, 30] ms holding kernels over [10, 14] and [20, 30] (6 ms idle), and
    [50, 60] ms holding kernels over [50, 52], [51, 53] and [58, 60] (5 ms
    idle); a span of another range and one past the slice's end beside
    them."""
    ms = 1e3
    td = TraceData(start_us=0.0, end_us=100 * ms)
    td.ops = [("k", 10 * ms, 14 * ms), ("k", 20 * ms, 30 * ms),
              ("k", 50 * ms, 52 * ms), ("k", 51 * ms, 53 * ms), ("k", 58 * ms, 60 * ms),
              ("k", 70 * ms, 71 * ms), ("k", 95 * ms, 96 * ms), ("k", 105 * ms, 106 * ms)]
    td.ranges = [(rng, 10 * ms, 30 * ms), (rng, 50 * ms, 60 * ms),
                 ("plain_attention", 70 * ms, 90 * ms), (rng, 95 * ms, 106 * ms),
                 ("bench:mixed tick", 0.0, 40 * ms)]
    return td


def _run(kind="serve", trace=None) -> ServeRun:
    run = ServeRun(kind, {}, {}, None, {"max_batch": 8})
    run.trace = trace
    return run


@pytest.mark.parametrize("name", sorted(READERS))
def test_idle_within_the_forward_spans_by_hand(name):
    read = registry.metric(name).read
    # (6 + 5) ms idle over the two spans inside the slice
    assert read(_run(trace=_trace(READERS[name]))) == pytest.approx(5.5)


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_reads_none(name):
    read = registry.metric(name).read
    other = [r for r in READERS.values() if r != READERS[name]][0]
    assert read(_run(trace=None)) is None
    assert read(_run(trace=_trace(other))) is None           # the other kind of cell
    assert read(_run("train", trace=_trace(READERS[name]))) is None
    td = _trace(READERS[name])
    td.ranges = [r for r in td.ranges if r[1] >= 95e3]       # only past the slice's end
    assert read(_run(trace=td)) is None
    assert read(_run(trace=TraceData())) is None              # a trace without ranges


def test_entries_and_readers_agree():
    bj = registry.benchmark()
    entries = {m["name"]: m for m in bj["per_layer"]}
    for name, cell, moves in (("chunk_fwd_idle_ms", "olmo-1b.chat", "ttft_p90_ms"),
                              ("whole_fwd_idle_ms", "minicpm3-4b.chat", "tpot_p90_ms")):
        m, mod = entries[name], registry.metric(name)
        assert m["workloads"] == [cell] and m["moves"] == moves == mod.MOVES
        assert (m["layer"], m["source"], m["better"]) == ("model step", "device_trace", "lower")
        assert name in {e["name"] for e in registry.cell_metrics(bj, cell)[1]}
