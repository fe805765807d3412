"""Every token the engine emitted in the window (mixed ticks, whole
prefills and decode ticks alike) over the window's seconds."""
from bench.lib.stats import rate

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    if run.kind != "serve":
        return None
    return rate(run.tokens_out, run.window_s)
