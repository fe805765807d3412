"""Prompt tokens served from the radix cache over prompt tokens looked up
(the engine's ``prefix_hit_tokens`` and ``prefix_lookup_tokens``
counters), differenced over the window less a traced slice."""
LAYER = "scheduler and radix cache"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "program_counter", "ttft_p90_ms"
KERNELS = ()


def read(run):
    if run.kind != "serve" or not run.stats.get("prefix_lookup_tokens"):
        return None
    return 100.0 * run.stats["prefix_hit_tokens"] / run.stats["prefix_lookup_tokens"]
