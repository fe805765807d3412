"""From the process's start to the window's: loading, drawing the
weights, building (or loading) the kernels, warming up and the ramp."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
