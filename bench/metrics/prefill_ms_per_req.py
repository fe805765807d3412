"""The engine's prefill wall time (mixed ticks and whole prefills,
``ServeStats.prefill_s``) over the requests it prefilled, both
differenced over the window (less a traced slice)."""
LAYER = "engine tick"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ttft_p90_ms"
KERNELS = ()


def read(run):
    if run.kind != "serve" or not run.stats.get("prefills"):
        return None
    return 1e3 * run.stats["prefill_s"] / run.stats["prefills"]
