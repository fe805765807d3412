"""Every token the window's training steps trained on, over the window's
seconds (each step ends in its loss's host read)."""
from bench.lib.stats import rate

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    if run.kind != "train":
        return None
    return rate(run.tokens, run.window_s)
