"""The training step's model work over the window on the card's bf16
peak: 6 x the weights a token multiplies through x the trained tokens,
over their seconds x 989 TFLOP/s, over the window's untraced steps."""
from bench.lib import flops, peaks

LAYER = "train step"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "train_tokens_per_s"
KERNELS = ()


def read(run):
    if run.kind != "train" or run.host_s <= 0:
        return None
    work = 6.0 * flops.matmul_params(run.ref, run.config) * run.host_tokens
    return 100.0 * work / run.host_s / peaks.PEAK_BF16_FLOPS
