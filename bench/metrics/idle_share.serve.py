"""The share of the traced slice in which no operation ran on the card:
1 - the union of the device operations' intervals over the slice."""
LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "output_tokens_per_s"
KERNELS = ()


def read(run):
    if run.kind != "serve" or run.trace is None or run.trace.window_s <= 0:
        return None
    if not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
