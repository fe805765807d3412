"""The 90th percentile of first-token time minus send time over every
request sent in the window; a failed or unfinished request is missing
(infinite)."""
from bench.lib.stats import percentile

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    return 1e3 * percentile([r.ttft for r in run.requests], 90)
