"""Readings of the program's own profiler ranges (``TraceData.ranges``: each
range's device span, first to last kernel inside, gaps included)."""


def range_idle_ms(run, name: str):
    """Milliseconds the card waits inside a device span of the program's
    profiler range ``name``: over each such span in the traced slice, its
    length less the busy time within it, over their number.  None without a
    trace or without such a span in the slice."""
    tr = run.trace
    if tr is None:
        return None
    spans = [(a, b) for n, a, b in tr.ranges
             if n == name and tr.start_us <= a and b <= tr.end_us]
    if not spans:
        return None
    return 1e3 * sum((b - a) / 1e6 - tr.busy_within(a, b) for a, b in spans) / len(spans)
