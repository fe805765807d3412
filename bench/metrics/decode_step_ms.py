"""The engine's decode-tick wall time (``ServeStats.decode_s``) over the
decode steps those ticks ran (ticks x ``decode_chunk``), over the
window less a traced slice."""
LAYER = "engine tick"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "tpot_p90_ms"
KERNELS = ()


def read(run):
    if run.kind != "serve" or not run.stats.get("chunks"):
        return None
    steps = run.stats["chunks"] * run.engine_config.get("decode_chunk", 8)
    return 1e3 * run.stats["decode_s"] / steps
