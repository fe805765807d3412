"""The model's work over the window on the card's bf16 peak: 2 x the
weights a token multiplies through x (every prompt whose first token came
in the window, counted whole whatever the prefix cache saved, plus every
token decoded), over the window's seconds x 989 TFLOP/s.  In a traced run
the traced slice is left out of both."""
from bench.lib import flops, peaks

LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "output_tokens_per_s"
KERNELS = ()


def read(run):
    if run.kind != "serve" or run.host_s <= 0:
        return None
    work = 2.0 * flops.matmul_params(run.ref, run.config) * run.flop_tokens
    return 100.0 * work / run.host_s / peaks.PEAK_BF16_FLOPS
