"""What a run loads: no module whose top-level name, compared whole, is
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` (the port's
``repro_torch`` begins with that name and is not it), and nothing of the
program under test in the plain references."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_LOAD_ALL = r"""
import json, sys
from pathlib import Path
sys.path[:0] = [{root!r}, {src!r}]
from bench.lib import registry
loaded = []
for p in sorted(Path({bench!r}).rglob("*.py")):
    rel = p.relative_to(Path({bench!r}))
    if rel.parts[0] == "tests" or p.name == "run.py":
        continue
    if rel.parts[0] == "metrics":
        registry.metric(p.stem)
    elif rel.parts[0] == "reference":
        registry.reference(p.stem)
    else:
        __import__(".".join(("bench",) + rel.with_suffix("").parts).replace(".__init__", ""))
    loaded.append(str(rel))
print(json.dumps({{"loaded": loaded, "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

_LOAD_REFERENCE = r"""
import json, sys
from pathlib import Path
sys.path[:0] = [{root!r}, {src!r}]
import importlib.util
for p in sorted(Path({bench!r}, "reference").glob("*.py")):
    __import__("bench.reference." + p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), src=str(ROOT / "src"),
                                                            bench=str(BENCH))],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_bench_module_loads_without_jax_or_the_jax_package():
    got = _run(_LOAD_ALL)
    assert any(p.startswith("reference") for p in got["loaded"])
    assert any(p.startswith("metrics") for p in got["loaded"])
    assert not FORBIDDEN & set(got["top"]), FORBIDDEN & set(got["top"])


def test_the_references_load_nothing_of_the_program():
    top = set(_run(_LOAD_REFERENCE))
    assert "torch" in top
    assert "repro_torch" not in top and not FORBIDDEN & top


def test_the_harness_check_compares_whole_top_level_names():
    from bench.lib import harness
    before = dict(sys.modules)
    try:
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_lookalike"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.serving"] = sys
        assert harness.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_a_run_on_the_cpu_loads_neither(tmp_path):
    code = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from bench.lib import harness
from bench.tests.tiny import tiny_cell, tiny_config, tiny_mix
res, run = harness.run_cell("olmo-1b.chat", 5, 3.0, False, "cpu", config=tiny_config("olmo-1b"),
                            mix=tiny_mix("chat_shared"), overrides=tiny_cell("olmo-1b.chat"))
print(json.dumps(harness.forbidden_modules()))
"""
    assert _run(code) == []


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """With only ``BENCHMARK.json`` and ``bench/`` (no program), a run exits
    with another code than 0 and prints no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    for argv in (["bench/run.py", "--workload", "olmo-1b.chat", "--seed", "1", "--seconds", "1"],
                 ["-c", "import sys; sys.path.insert(0, '.'); from bench.lib import harness; "
                        "harness.run_cell('olmo-1b.chat', 1, 1.0, False, 'cpu')"]):
        out = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                             timeout=300, cwd=tmp_path)
        assert out.returncode != 0
        assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
