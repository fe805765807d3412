"""Live slots over ``max_batch``, read by the harness before each engine
step of the window outside a traced slice, averaged."""
LAYER = "scheduler and radix cache"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "program_counter", "output_tokens_per_s"
KERNELS = ()


def read(run):
    if run.kind != "serve" or not run.occupancy:
        return None
    return 100.0 * sum(run.occupancy) / len(run.occupancy) / run.engine_config["max_batch"]
