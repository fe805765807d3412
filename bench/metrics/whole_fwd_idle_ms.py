"""Milliseconds a whole-prompt prefill in which the card waits while the
host dispatches the eager forward (MLA's ``model.prefill``, inline at
admission): the idle time inside the device spans of the program's
``serve.whole_forward`` profiler range (a leaf, so every kernel launched in
it is its own), a span (:func:`bench.lib.ranges.range_idle_ms`)."""
from bench.lib.ranges import range_idle_ms

LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "tpot_p90_ms"
KERNELS = ()
RANGE = "serve.whole_forward"


def read(run):
    return range_idle_ms(run, RANGE) if run.kind == "serve" else None
