"""Device milliseconds a step inside the program's ``adamw_update``
profiler range (``training/step.py``), as the device ran it: the busy time
within each of the range's device spans in the traced slice, over their
number."""
LAYER = "optimizer"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "train_tokens_per_s"
KERNELS = ()
RANGE = "adamw_update"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    spans = [(a, b) for name, a, b in run.trace.ranges if name == RANGE]
    if not spans:
        return None
    return 1e3 * sum(run.trace.busy_within(a, b) for a, b in spans) / len(spans)
