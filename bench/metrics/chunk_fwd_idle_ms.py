"""Milliseconds a mixed tick in which the card waits while the host
dispatches the eager chunk forward: the idle time inside the device spans
of the program's ``serve.chunk_forward`` profiler range (``chunk_step`` and
the last-row logits slice of ``ModelRunner.mixed``; a leaf, so every kernel
launched in it is its own), a span (:func:`bench.lib.ranges.range_idle_ms`)."""
from bench.lib.ranges import range_idle_ms

LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "ttft_p90_ms"
KERNELS = ()
RANGE = "serve.chunk_forward"


def read(run):
    return range_idle_ms(run, RANGE) if run.kind == "serve" else None
