"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor
anything of ``repro``, its entry points run on the card unless asked for the
CPU, and ``chip_smoke.py`` refuses to run without a card."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    import repro_torch
    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]


def test_import_pulls_in_no_jax_and_no_repro():
    """A fresh interpreter imports every port module; afterwards no
    ``jax*`` or ``repro``/``repro.*`` module is loaded."""
    mods = _modules()
    assert {"repro_torch.serving.engine", "repro_torch.core.quant",
            "repro_torch.configs.gemma3_4b", "repro_torch.kernels.block_gemm",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention", "repro_torch.launch.serve",
            "repro_torch.core.cgra", "repro_torch.launch.roofline",
            "repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.launch.dist", "repro_torch.core.torus",
            "repro_torch.launch.cells", "repro_torch.training.compress",
            "repro_torch.kernels.spec", "repro_torch.analysis",
            "repro_torch.analysis.__main__", "repro_torch.analysis.findings",
            "repro_torch.analysis.bounds", "repro_torch.analysis.op_lints",
            "repro_torch.analysis.mesh_lints", "repro_torch.analysis.donation",
            "repro_torch.analysis.runner"} <= set(mods)
    assert len(mods) >= 28
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_import_statement_names_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (f, n)


def test_entry_points_refuse_cpu_without_being_asked():
    """With no card, the entry points raise unless ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import bridge
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, EngineConfig
    cfg = reduce_config(get_config("cgra-edge"))
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_paged_cache(cfg, 2, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_numpy(cfg, {})
    params = M.init(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, EngineConfig(max_len=32, page_size=8))
    Engine(cfg, params, EngineConfig(max_len=32, page_size=8), device="cpu")


def test_chip_smoke_needs_a_card():
    """Without CUDA, chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, text=True, capture_output=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
