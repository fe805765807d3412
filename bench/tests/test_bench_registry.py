"""The harness finds every piece by its name: a configuration, a traffic
mix, a cell and a per-layer metric added as files alone, with no edit to a
file that is there, run end to end (on the CPU, at reduced widths)."""
import json
import shutil

import pytest

from bench.lib import harness, registry
from bench.tests.tiny import tiny_config, tiny_mix

NEW_METRIC = '''"""Requests that finished healthily in the window, as a share of those sent."""
LAYER = "scheduler and radix cache"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "program_counter", "output_tokens_per_s"
KERNELS = ()


def read(run):
    if not run.requests:
        return None
    return 100.0 * sum(r.ok for r in run.requests) / len(run.requests)
'''


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A copy of ``bench/`` with one configuration, mix, cell and metric
    added as new files, and the ``BENCHMARK.json`` that names them."""
    bench = tmp_path / "bench"
    shutil.copytree(registry.BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    c = tiny_config("olmo-1b")
    c["name"] = c["port"]["name"] = "olmo-tiny"
    (bench / "configs" / "olmo-tiny.json").write_text(json.dumps(c))
    mix = tiny_mix("chat_short")
    mix["clients"] = 6
    (bench / "traffic" / "tiny_burst.json").write_text(json.dumps(mix))
    cell = {"config": "olmo-tiny", "traffic": "tiny_burst", "kind": "serve", "chips": 1,
            "engine": {"max_batch": 4, "max_len": 64, "page_size": 8, "chunk_tokens": 16,
                       "decode_chunk": 2, "prefix_cache": True},
            "ramp_s": 0.3, "check": {"sample_tokens": 20, "max_requests": 3},
            "limits": {"logit_gap": 1e-3}}
    (bench / "workloads" / "olmo-tiny.burst.json").write_text(json.dumps(cell))
    (bench / "metrics" / "ok_share.py").write_text(NEW_METRIC)
    bj = registry.benchmark()
    bj["configs"].append({"name": "olmo-tiny",
                          "source": "https://huggingface.co/allenai/OLMo-1B-hf",
                          "file": "bench/configs/olmo-tiny.json", "reduced": [], "why": "test"})
    bj["workloads"].append({"name": "olmo-tiny.burst", "config": "olmo-tiny",
                            "traffic": "tiny_burst", "chips": 1, "why": "test"})
    for m in bj["end_to_end"]:
        if m["name"] in ("output_tokens_per_s", "ttft_p90_ms", "tpot_p90_ms"):
            m["workloads"].append("olmo-tiny.burst")
    bj["per_layer"].append({"name": "ok_share", "unit": "%", "better": "higher",
                            "source": "program_counter", "layer": "scheduler and radix cache",
                            "moves": "output_tokens_per_s", "workloads": ["olmo-tiny.burst"]})
    monkeypatch.setattr(registry, "BENCH", bench)
    return bench, bj, before


def test_pieces_added_as_files_are_found_by_name(added):
    bench, bj, before = added
    assert registry.config("olmo-tiny")["hidden_size"] == 64
    assert registry.traffic("tiny_burst")["clients"] == 6
    assert registry.workload("olmo-tiny.burst")["config"] == "olmo-tiny"
    assert registry.metric("ok_share").UNIT == "%"
    e2e, per_layer = registry.cell_metrics(bj, "olmo-tiny.burst")
    assert {m["name"] for m in e2e} == {"output_tokens_per_s", "ttft_p90_ms", "tpot_p90_ms",
                                        "setup_s"}
    assert "ok_share" in {m["name"] for m in per_layer}
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()
             if p.relative_to(bench) in before}
    assert after == before  # nothing that was there changed


def test_an_added_cell_runs_end_to_end(added):
    _, bj, _ = added
    res, run = harness.run_cell("olmo-tiny.burst", 2 ** 32 + 9, 3.0, False, "cpu", bench_json=bj)
    assert set(res["metrics"]) == {"output_tokens_per_s", "ttft_p90_ms", "tpot_p90_ms", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is True and list(res)[-1] == "checks"
    res, run = harness.run_cell("olmo-tiny.burst", 3, 3.0, True, "cpu", bench_json=bj)
    assert res["metrics"]["ok_share"]["value"] == 100.0
    assert "output_tokens_per_s" not in res["metrics"]
