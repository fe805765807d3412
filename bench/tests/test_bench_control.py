"""The control of ``correct``: the plain reference put in the program's
place one precision below the configuration's (bf16 -> fp8 e4m3: every
projection's input rounded by row and its weight by output column).  For a
served model it need not decode: at each position of the prompts and tokens
the program served, the token the fp8 control puts first is judged by the
float32 reference's gap, as the program's served token is.

On the card at the cell's own size (a short window at the cell's load) the
control must fail the cell's limit on every seed while the program passes
it; on the CPU at reduced widths, the control must depart further than the
program."""
import json
import math

import pytest

from bench.lib import harness, registry
from bench.tests.tiny import tiny_cell, tiny_config, tiny_mix

CELLS = ["olmo-1b.chat", "minicpm3-4b.chat"]
CONTROL_SEEDS = (3000001001, 3000001002, 3000001003)
CONTROL_SECONDS = 10.0


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_on_the_card(card, cell):
    limit = registry.workload(cell)["limits"]["logit_gap"]
    readings = []
    for seed in CONTROL_SEEDS:
        res, run = harness.run_cell(cell, seed, CONTROL_SECONDS, False, "cuda", control=True)
        readings.append(run.checks)
        print(json.dumps({"cell": cell, "seed": seed, **run.checks}), flush=True)
    assert all(r["logit_gap"] <= limit for r in readings)
    assert all(r["control_gap"] > limit for r in readings)


@pytest.mark.parametrize("cell", CELLS)
def test_control_departs_further_than_the_program_on_the_cpu(cell):
    name = registry.workload(cell)["config"]
    res, run = harness.run_cell(cell, 17, 3.0, False, "cpu", config=tiny_config(name),
                                mix=tiny_mix(registry.workload(cell)["traffic"]),
                                overrides=tiny_cell(cell), control=True)
    assert run.checks["tokens_checked"] > 0
    assert math.isfinite(run.checks["control_gap"])
    assert run.checks["control_gap"] > run.checks["logit_gap"]


@pytest.mark.chip
def test_train_control_and_faults_fail_the_limits_on_the_card(card):
    """The training cell's control (the fp8 reference in the program's
    place) and its half-batch fault (the reference on half the rows) each
    fail one of the cell's numbers; a state left unchanged reads 1 by the
    leaf measure and needs no run."""
    cell = "olmo-1b.train"
    limits = registry.workload(cell)["limits"]
    readings = []
    for seed in CONTROL_SEEDS:
        res, run = harness.run_cell(cell, seed, CONTROL_SECONDS, False, "cuda", control=True)
        readings.append(run.checks)
        print(json.dumps({"cell": cell, "seed": seed, **run.checks,
                          "losses": {k: v["loss"] for k, v in run.readings.items()}}), flush=True)
    for r in readings:
        assert all(r[k] <= v for k, v in limits.items())
        for kind in ("control", "half_batch"):
            assert any(r[f"{kind}_{k}"] > v for k, v in limits.items())
