"""The port's serving surface and driver (``repro_torch.launch.serve``)
against the reference (CPU, plain kernel versions): ``ServeStats.
tokens_per_s``, ``bytes_tokenizer_decode`` and ``CacheSpec.max_rows`` equal
JAX's on the same inputs; ``make_prompts`` is the reference driver's
recipe; ``run()`` on reduced olmo-1b with bridged JAX weights at ``--rate
0 --temperature 0`` gives JAX's ``Engine``'s tokens for the same prompts
and ``EngineConfig`` (whole-suffix and chunked prefill), token for token;
``main`` prints the reference's summary fields, serves Poisson arrivals,
refuses ``--mesh`` without ``--backend``, and with ``--mesh 1x2 --backend
gloo`` spawns two ranks whose rank 0 prints the reference's summary line
(also under ``--quant w8a8`` and for ``--arch mamba2-130m``)."""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.config import CacheSpec as JCacheSpec
from repro.serving.engine import ServeStats as JServeStats
from repro.serving.engine import bytes_tokenizer_decode as j_decode
from repro.serving.engine import bytes_tokenizer_encode as j_encode
import repro_torch.configs as TC
from repro_torch.launch import serve
from repro_torch.models import bridge
from repro_torch.serving import ServeStats, bytes_tokenizer_decode
from repro_torch.serving.config import CacheSpec

# the reference driver's summary line (repro/launch/serve.py:127-133)
J_FIELDS = ["arch", "kernel_mode", "quant", "requests", "ok", "batch", "pages", "prefill",
            "decode", "throughput", "prefix_hit", "p50", "p99"]


def test_stats_tokenizer_and_cache_spec_equal_the_reference():
    for tokens_out, decode_s in ((0, 0.0), (37, 0.0), (37, 1.25), (1000, 3.0)):
        assert (ServeStats(tokens_out=tokens_out, decode_s=decode_s).tokens_per_s
                == JServeStats(tokens_out=tokens_out, decode_s=decode_s).tokens_per_s)
    for toks in ([], [104, 105], [0xE2, 0x82, 0xAC, 300, 255], list(range(0, 600, 7))):
        assert bytes_tokenizer_decode(toks) == j_decode(toks)
    assert bytes_tokenizer_decode(np.array([72, 105])) == j_decode(np.array([72, 105])) == "Hi"
    for ps, n, ml in ((64, 65, 512), (16, 2, 96), (8, 1000, 100)):
        assert CacheSpec(page_size=ps, n_pages=n, max_len=ml).max_rows == JCacheSpec(
            page_size=ps, n_pages=n, max_len=ml).max_rows


def test_make_prompts_is_the_reference_recipe():
    for n, vocab in ((16, 256), (5, 50304)):
        rng = np.random.RandomState(0)
        want = [j_encode(f"request {i}: " + "x" * rng.randint(4, 40), vocab) for i in range(n)]
        assert serve.make_prompts(n, vocab) == want


@pytest.fixture(scope="module")
def olmo():
    jcfg = JC.reduce_config(JC.get_config("olmo-1b"))
    tcfg = TC.reduce_config(TC.get_config("olmo-1b"))
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, bridge.params_from_numpy(tcfg, _flatten(params), device="cpu")


@pytest.mark.parametrize("chunk_tokens", [None, 16])
def test_run_gives_the_jax_engines_tokens(olmo, chunk_tokens):
    jcfg, tcfg, params, tparams = olmo
    argv = ["--requests", "6", "--max-new", "8", "--temperature", "0", "--batch", "4",
            "--max-len", "128", "--page-size", "16", "--device", "cpu"]
    if chunk_tokens:
        argv += ["--chunk-tokens", str(chunk_tokens)]
    args = serve.parser().parse_args(argv)
    results, stats, eng = serve.run(tcfg, tparams, args)
    assert all(r.ok for r in results) and len(results) == 6
    assert eng.pool.num_free == eng.pool.n_pages - 1  # closed: every page back
    jeng = JEngine(jcfg, params, JEngineConfig(max_len=128, max_batch=4, page_size=16,
                                              chunk_tokens=chunk_tokens))
    prompts = serve.make_prompts(6, jcfg.vocab_size)
    for i, p in enumerate(prompts):
        jeng.submit(p, 8, 0.0, seed=i)
    want = {r.rid: r.generated for r in jeng.run()}
    assert {r.rid: r.generated for r in results} == want
    assert stats.tokens_out == 6 * 8 and stats.tokens_per_s > 0


def test_main_prints_the_reference_summary_and_streams(capsys):
    serve.main(["--device", "cpu", "--requests", "3", "--max-new", "4"])
    line = capsys.readouterr().out.strip().splitlines()[0]
    keys = re.findall(r"(\w+)=", line)
    assert keys == [("device" if k == "kernel_mode" else k) for k in J_FIELDS]
    assert "arch=olmo-1b-smoke device=cpu quant=none requests=3 ok=3" in line
    results = serve.main(["--device", "cpu", "--requests", "4", "--max-new", "4",
                          "--rate", "200", "--preemption", "recompute", "--pages", "3",
                          "--page-size", "16", "--max-len", "64"])
    out = capsys.readouterr().out
    assert len(results) == 4 and all(r.ok and len(r.generated) == 4 for r in results)
    assert "requests=4 ok=4" in out


def test_mesh_is_refused():
    """A mesh has no default backend: ``--mesh`` alone is refused, naming
    the two."""
    with pytest.raises(ValueError, match="--backend: nccl .* or gloo"):
        serve.main(["--device", "cpu", "--mesh", "1x2"])


def test_mesh_1x2_over_gloo_prints_the_reference_summary():
    """``--mesh 1x2 --backend gloo --device cpu``: ``main`` spawns two
    ranks; rank 0 alone prints the reference's summary line (every request
    ok) and the mesh line (the ranks agree; the decode step eager)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--mesh", "1x2", "--backend", "gloo", "--requests", "3",
                          "--max-new", "4"], env=env, text=True, capture_output=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 2, res.stdout
    keys = re.findall(r"(\w+)=", lines[0])
    assert keys == [("device" if k == "kernel_mode" else k) for k in J_FIELDS]
    assert "arch=olmo-1b-smoke device=cpu quant=none requests=3 ok=3" in lines[0]
    assert lines[1] == ("mesh=1x2 backend=gloo ranks=2 ranks_agree=True "
                        "decode_graph=False")


@pytest.mark.parametrize("extra,head", [
    (["--quant", "w8a8"], "arch=olmo-1b-smoke device=cpu quant=w8a8 requests=3 ok=3"),
    (["--arch", "mamba2-130m"], "arch=mamba2-130m-smoke device=cpu quant=none requests=3 ok=3"),
])
def test_mesh_1x2_over_gloo_serves_w8a8_and_ssd(extra, head):
    """The same command line serves w8a8 on the model axis (the row-parallel
    int8 GEMMs) and a Mamba-2 SSD model (head-parallel): every request ok,
    the ranks agree."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--mesh", "1x2", "--backend", "gloo", "--requests", "3",
                          "--max-new", "4", *extra], env=env, text=True, capture_output=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 2 and head in lines[0], res.stdout
    assert lines[1] == ("mesh=1x2 backend=gloo ranks=2 ranks_agree=True "
                        "decode_graph=False")
