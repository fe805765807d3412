"""``BENCHMARK.json`` against the benchmark's contract, and every piece it
names against its own file."""
import json
import re
from pathlib import Path

import pytest

from bench.lib import registry

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bj():
    return registry.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bj):
    assert set(bj) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    assert bj["command"] == ["python3", "bench/run.py"] and bj["paths"] == ["bench"]
    assert isinstance(bj["run_seconds"], int) and 1 <= bj["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells(bj):
    cells = 24
    total = (2 + 14 * cells) * (bj["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_configs_name_their_files_and_cuts(bj):
    used = {w["config"] for w in bj["workloads"]}
    for c in bj["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert c["file"] == f"bench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in data and k in data.get("changed", {})
            assert not (k.endswith("_dim") or k.endswith("_rank") or "size" in k), k


def test_cells(bj):
    names = [w["name"] for w in bj["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bj["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bj["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        cell = registry.workload(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        registry.traffic(w["traffic"])


def test_metrics_and_their_readers(bj):
    cells = {w["name"] for w in bj["workloads"]}
    names = [m["name"] for m in bj["end_to_end"] + bj["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in bj["end_to_end"]}
    for m in bj["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        mod = registry.metric(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (m["unit"], m["better"], m["source"])
        assert UNIT.match(m["unit"]) and set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bj["end_to_end"]}
    for m in bj["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        mod = registry.metric(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == \
            (m["unit"], m["better"], m["source"], m["layer"], m["moves"])
        assert set(m["workloads"]) <= e2e[m["moves"]]
        if m["name"].endswith("_roofline") or m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bj):
    for w in bj["workloads"]:
        e2e, per_layer = registry.cell_metrics(bj, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        assert any("mfu" in m["name"] for m in per_layer)

