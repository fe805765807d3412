"""The benchmark's one entry:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It reads the cell's file, its configuration and its mix (found by name,
:mod:`bench.lib.registry`), runs the cell's kind (``bench/lib/<kind>.py``:
``serve`` or ``train``), reads each metric ``BENCHMARK.json`` gives the
cell through its own reader (``bench/metrics/<metric>.py``), and prints
one JSON line: the end-to-end metrics with ``--trace 0``, the per-layer
ones with ``--trace 1``.  Each number ``correct`` compares is printed
beside its limit as the last lines on standard error and under
``checks``, the line's last key: the cell's own numbers and ``failed``,
the window's requests (or steps) that did not finish healthily, limit 0.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_proc0: float | None = None, config: dict | None = None,
             bench_json: dict | None = None, control: bool = False,
             mix: dict | None = None, overrides: dict | None = None):
    """Run cell ``name`` and return (result line as a dict, the run).
    ``config`` and ``mix`` replace the cell's configuration and traffic
    files (the CPU tests run a cell at reduced widths and lengths),
    ``overrides`` some of the cell's own keys (its ramp); ``control`` also
    reads the fp8 control."""
    import time

    from bench.lib import registry
    t_proc0 = time.time() if t_proc0 is None else t_proc0
    bench_json = bench_json or registry.benchmark()
    cell = {**registry.workload(name), **(overrides or {})}
    c = config or registry.config(cell["config"])
    if mix is None and cell.get("traffic"):
        mix = registry.traffic(cell["traffic"])
    kind = importlib.import_module(f"bench.lib.{cell['kind']}")
    run = kind.run(cell, c, mix, seed, seconds, trace, device, t_proc0, control=control)

    e2e, per_layer = registry.cell_metrics(bench_json, name)
    metrics = {}
    for entry in (per_layer if trace else e2e):
        value = registry.metric(entry["name"]).read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {entry['name']} read nothing")
            continue
        metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}

    limits = cell["limits"]
    checks = {k: {"value": run.checks[k], "limit": limits[k]} for k in limits}
    # a request of the window that never finished healthily (or a step whose
    # loss is not finite) never came or said the wrong thing: none may
    checks["failed"] = {"value": int(run.failed), "limit": 0}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checks.values())
    device_info = {"platform": "gpu" if str(device).startswith("cuda") else str(device),
                   "kind": _device_name(device), "count": int(cell["chips"]),
                   "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result, run


def _device_name(device) -> str:
    import torch
    if str(device).startswith("cuda"):
        return torch.cuda.get_device_name(0)
    return str(device)


def main(argv: list[str], t_proc0: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.lib import registry
    bench_json = registry.benchmark()
    entry = {w["name"]: w for w in bench_json["workloads"]}.get(args.workload)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result, run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                         "cuda", t_proc0, bench_json=bench_json)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that must not be: {', '.join(bad)}", file=sys.stderr)
        return 4
    line = json.dumps(result)
    for k, v in run.checks.items():
        if k not in result["checks"]:
            print(f"read {k} = {v!r}", file=sys.stderr)
    for side, got in getattr(run, "readings", {}).items():
        print(f"read {side} losses = {got['loss']!r}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0
