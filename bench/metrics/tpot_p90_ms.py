"""Each request's (finish - first token) / (tokens - 1), then the 90th
percentile over every request sent in the window; a failed or unfinished
request is missing (infinite)."""
from bench.lib.stats import percentile

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    return 1e3 * percentile([r.tpot for r in run.requests], 90)
