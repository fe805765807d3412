"""The engine's whole-prompt prefills at admission (``ServeStats.prefill_s``
over ``prefills``, both differenced over the window less a traced slice),
in an engine whose model prefills whole (MLA): each runs inline in its tick
and holds every decoding slot meanwhile, so it sets the pace of answers."""
LAYER = "engine tick"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "tpot_p90_ms"
KERNELS = ()


def read(run):
    if run.kind != "serve" or not run.stats.get("prefills") or run.stats.get("mixed_steps"):
        return None
    return 1e3 * run.stats["prefill_s"] / run.stats["prefills"]
