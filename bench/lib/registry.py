"""Find the benchmark's pieces by name.

Every piece lives in a file of its own, named after the piece:

- ``bench/configs/<config>.json``: a model configuration as it is run
  (the source's keys, the port's ``ArchConfig`` fields under ``"port"``,
  and the plain reference module under ``"reference"``);
- ``bench/traffic/<mix>.json``: the parameters of one traffic mix, read by
  the one generator in :mod:`bench.lib.traffic`;
- ``bench/workloads/<cell>.json``: a cell -- its configuration, its mix,
  the engine or trainer settings, ``chips`` and the limits of ``correct``;
- ``bench/metrics/<metric>.py``: one metric's reader, with its layer,
  unit, ``moves`` and cells.

Nothing here lists them: a piece added as a file is found by its name, and
``BENCHMARK.json`` at the root says which metrics each cell reports.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def _dir(bench: Path | None) -> Path:
    """The benchmark's folder: ``bench`` or this module's :data:`BENCH`, read
    at call time."""
    return Path(bench) if bench is not None else BENCH


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return json.loads(path.read_text())


def benchmark(root: Path | None = None) -> dict:
    return _json((Path(root) if root is not None else _dir(None).parent) / "BENCHMARK.json")


def config(name: str, bench: Path | None = None) -> dict:
    return _json(_dir(bench) / "configs" / f"{name}.json")


def traffic(name: str, bench: Path | None = None) -> dict:
    return _json(_dir(bench) / "traffic" / f"{name}.json")


def workload(name: str, bench: Path | None = None) -> dict:
    cell = _json(_dir(bench) / "workloads" / f"{name}.json")
    cell.setdefault("name", name)
    return cell


def load_module(path: Path, name: str):
    """Import a file by path under a private module name (a metric's file
    name may hold dots, which an import statement cannot spell)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, bench: Path | None = None):
    """The reader module of metric ``name``: ``read(run) -> float | None``
    (None where the run holds nothing to read) and its declared ``UNIT``,
    ``BETTER`` and ``SOURCE``; a per-layer one also ``LAYER``, ``MOVES`` and
    the device ops it reads (``KERNELS``).  Which cells report it is
    ``BENCHMARK.json``'s to say, so that a later cell needs no edit here."""
    path = _dir(bench) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    return load_module(path, f"bench_metric_{name.replace('.', '_').replace('-', '_')}")


_REFS: dict = {}


def reference(name: str, bench: Path | None = None):
    """The plain reference module ``bench/reference/<name>.py``."""
    path = _dir(bench) / "reference" / f"{name}.py"
    if path not in _REFS:
        if not path.is_file():
            raise FileNotFoundError(f"no plain reference {name!r}: {path}")
        _REFS[path] = load_module(path, f"bench_reference_{name.replace('-', '_')}")
    return _REFS[path]


def _applies(entry: dict, cell: str, reported: set[str] | None = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry.get("moves") in reported


def cell_metrics(bench_json: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metric entries of ``BENCHMARK.json``
    that cell ``cell`` reports: an entry with a ``workloads`` key where it
    names the cell; a per-layer one without it wherever the cell reports
    the end-to-end metric it ``moves``."""
    e2e = [m for m in bench_json["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench_json["per_layer"] if _applies(m, cell, names)]
    return e2e, per_layer
