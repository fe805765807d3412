"""The roofline bound of the GEMMs the traced slice's tokens needed, over
the device time of the GEMM kernels in the slice.  Each runner call in the
slice contributes every layer's projections and the head: a decode step
at its live rows (the head too), a mixed tick's prompt chunk at its valid
rows (the head at one row) plus its decode step, a whole prefill at its
prompt rows (the head at one row).  Bounds from the configuration's widths
(``bench.lib.flops``)."""
from bench.lib import flops

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "output_tokens_per_s"
KERNELS = ("gemm_bf16_kernel",)


def bound_s(run) -> float:
    ref, c, t = run.ref, run.config, 0.0
    for call in run.calls:
        if not call.traced:
            continue
        for m in call.dec_rows:
            t += flops.forward_gemm_bound(ref, c, "decode", m, m)
        if call.chunk:
            t += flops.forward_gemm_bound(ref, c, "prefill", call.chunk, 1)
        if call.prefill:
            t += flops.forward_gemm_bound(ref, c, "prefill", call.prefill, 1)
    return t


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    dev = run.trace.seconds(run.trace.ops_named(KERNELS))
    bound = bound_s(run)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
