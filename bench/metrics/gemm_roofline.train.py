"""The roofline bound of the GEMMs of the training steps in the traced
slice (each projection and the head forward, ``g @ W^T`` and ``A^T @ g``
at the step's rows x seq_len tokens; ``bench.lib.flops``), over the device
time of the GEMM kernels in the slice."""
from bench.lib import flops

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "train_tokens_per_s"
KERNELS = ("gemm_bf16_kernel",)


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = sum(1 for _, _, traced in run.step_log if traced)
    dev = run.trace.seconds(run.trace.ops_named(KERNELS))
    if steps == 0 or dev <= 0:
        return None
    bound = steps * flops.train_gemm_bound(run.ref, run.config,
                                           run.job["rows"] * run.job["seq_len"])
    return 100.0 * bound / dev
