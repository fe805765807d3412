"""Mesh-sharded serving in the port against the JAX single-device engine.

The scenarios of ``tests/test_mesh_serving.py`` on reduced ``cgra-edge``
and reduced qwen3-moe, with the reference's weights crossed as numpy
(``bridge.params_from_numpy``): four gloo ranks on the CPU, spawned once
for the module, serve them on meshes 1x2, 1x4, 2x1 and 2x2 (a rank outside
a scenario's mesh sits it out), each rank writing what it served.  Each
test case reads one scenario: greedy tokens equal to the JAX engine's
(whole-suffix and chunked prefill, the batch over the data group at 2x1 and
2x2), radix reuse, a prompt joining mid-stream, the composed resilience
scenario (one REJECTED / CANCELLED / FAULT / DEADLINE, every counter moved
once: the rank-0 clock broadcast carries the chaos skew), expert-parallel
MoE at 1x2 and 2x2 (tokens equal, prefill logits within 1e-4 in f32),
FFN-parallel MoE (3 experts, each expert's FFN cut over the model axis) at
1x2 and 2x2 (the same checks), the same tokens on every rank, and the
refusals.  In the same four ranks: w8a8
on the model axis (reduced cgra-edge at 1x2 and 2x2: 4 heads, 4 KV heads
and an ffn of 128 over 2 ranks, the row-parallel int8 GEMMs exact, prefill
logits equal to the port's single rank bit for bit), head-parallel Mamba-2
SSD (reduced mamba2-130m, 8 SSD heads of 16, at 1x2, 2x1 and 2x2, and w8a8
at 1x2) and the jamba hybrid (reduced: 8 SSD heads, 4 attention heads over
2 KV heads, 4 experts) at 1x2."""
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
import repro_torch.configs as TC
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import count
from repro_torch.launch.mesh import DryMesh
from repro_torch.models import model as TM
from repro_torch.models.graph import DecodeGraph
from repro_torch.serving import Engine, EngineConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = dict(max_batch=4, max_len=128, page_size=16)
SHAPES = ("1x2", "1x4", "2x1", "2x2")


def _prompts(V):
    return [[(7 * i + j) % V for j in range(5 + 3 * i)] for i in range(4)]


def _moe_prompts(V):
    return [[(3 * i + j) % V for j in range(6 + 2 * i)] for i in range(3)]


SSD_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")


def _ssd_prompts(V):
    """Two lengths (two whole-prefill compilations on the JAX side), each at
    least the ``ssm_conv_width - 1`` rows an SSD prefill needs."""
    return [[(5 * i + j) % V for j in range((6, 11)[i % 2])] for i in range(4)]


RANKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch

    import repro_torch.configs as TC
    from repro_torch.launch import dist as D
    from repro_torch.launch.cells import prepare_arch
    from repro_torch.launch.sharding import activation_mesh, batch_entry, profile_for
    from repro_torch.models import bridge
    from repro_torch.models import model as M
    from repro_torch.serving import ChaosInjector, Engine, EngineConfig, MeshSpec

    KW = dict(max_batch=4, max_len=128, page_size=16)

    def body(rank, tmp):
        torch.set_num_threads(1)
        shapes = [MeshSpec.parse(s) for s in ("1x2", "1x4", "2x1", "2x2")]
        for spec in shapes:  # every rank makes every mesh's groups, in order
            spec.build()
        out = {}

        def record(key, eng, results, **extra):
            out[key] = dict(tokens=sorted([r.rid, list(r.generated), r.finish_reason.value]
                                          for r in results),
                            agree=eng.ranks_agree(results),
                            graphed=eng.runner.graph.graphed, **extra)

        cfg = TC.reduce_config(TC.get_config("cgra-edge"))
        params = bridge.params_from_numpy(cfg, dict(np.load(f"{tmp}/edge.npz")), "cpu")
        prompts = [[(7 * i + j) % cfg.vocab_size for j in range(5 + 3 * i)] for i in range(4)]
        for spec in shapes:
            if spec.build().coords is None:
                continue
            for chunk in (None, 8):
                eng = Engine(cfg, params, EngineConfig(mesh=spec, chunk_tokens=chunk, **KW),
                             device="cpu")
                for i, p in enumerate(prompts):
                    eng.submit(p, 12, 0.0, seed=i)
                record(f"dense/{spec.data}x{spec.model}/{chunk}", eng, eng.run(),
                       collectives=eng.mesh.collectives)

        mcfg = TC.reduce_config(TC.get_config("qwen3-moe-30b-a3b"))
        mparams = bridge.params_from_numpy(mcfg, dict(np.load(f"{tmp}/moe.npz")), "cpu")
        mp = [[(3 * i + j) % mcfg.vocab_size for j in range(6 + 2 * i)] for i in range(3)]
        # expert-parallel over model and the decode batch over data at once
        meng = Engine(mcfg, mparams, EngineConfig(mesh="2x2", **KW), device="cpu")
        for i, p in enumerate(mp):
            meng.submit(p, 8, 0.0, seed=i)
        record("moe_2x2", meng, meng.run(), shard_map=meng.cfg.moe_shard_map)

        # 3 experts over a model axis of 2: every expert's FFN cut over it
        m3cfg = mcfg.with_(num_experts=3)
        m3params = bridge.params_from_numpy(m3cfg, dict(np.load(f"{tmp}/moe3.npz")), "cpu")
        for shape in ("1x2", "2x2"):
            if MeshSpec.parse(shape).build().coords is None:
                continue
            eng = Engine(m3cfg, m3params, EngineConfig(mesh=shape, **KW), device="cpu")
            for i, p in enumerate(mp):
                eng.submit(p, 8, 0.0, seed=i)
            record(f"moe3/{shape}", eng, eng.run(), shard_map=eng.cfg.moe_shard_map,
                   w_gate=list(eng.params["stages"][0]["0"]["ffn"]["w_gate"].shape))
            with eng.runner.on_mesh():
                lg = M.prefill(eng.cfg, eng.runner.params,
                               torch.tensor([mp[0]], dtype=torch.int32))[0]
            np.save(f"{tmp}/moe3_{shape}_logits_r{rank}.npy", lg.numpy())

        one_by_two = shapes[0].build().coords is not None
        if one_by_two:
            shared = prompts[0] * 7
            family = [shared + [t] for t in (1, 2, 3)]
            warm = Engine(cfg, params, EngineConfig(mesh="1x2", **KW), device="cpu")
            rids = [warm.submit(p, 8) for p in family]
            res = warm.run()
            record("radix", warm, res, hit_rate=warm.prefix_hit_rate,
                   pages_back=warm.pool.num_free)
            cold = Engine(cfg, params, EngineConfig(mesh="1x2", prefix_cache=False, **KW),
                          device="cpu")
            for p in family:
                cold.submit(p, 8)
            record("radix_cold", cold, cold.run())

            seng = Engine(cfg, params, EngineConfig(mesh="1x2", chunk_tokens=8, **KW),
                          device="cpu")
            seng.submit(prompts[0], 16, 0.0, seed=0)
            res = seng.step()
            seng.submit(prompts[1], 16, 0.0, seed=1)
            while seng.num_queued or seng.num_active:
                res.extend(seng.step())
            record("midstream", seng, res, mixed=seng.stats.mixed_steps)

            chaos = ChaosInjector(schedule={"logits.nan": {2}, "clock.skew": {6}},
                                  skew_s=1000.0)
            reng = Engine(cfg, params, EngineConfig(mesh="1x2", max_batch=1, max_len=128,
                                                    page_size=16, decode_chunk=4,
                                                    max_queue=2, prefix_cache=False),
                          device="cpu", chaos=chaos)
            mk = lambda i: [(11 * i + j) % cfg.vocab_size for j in range(20)]
            ra = reng.submit(mk(1), 6)
            rb = reng.submit(mk(2), 6)
            rc = reng.submit(mk(3), 6)
            cancelled = reng.cancel(rb)
            rd = reng.submit(mk(4), 30, deadline_s=500.0)  # expires at the skew (tick 6)
            res = []
            while reng.num_queued or reng.num_active:
                res.extend(reng.step())
            res.extend(reng.run())
            s = reng.stats
            record("resilience", reng, res, rids=[ra, rb, rc, rd], cancelled=cancelled,
                   counters=[s.rejected, s.cancelled, s.faults_isolated,
                             s.deadline_expired, s.preempted],
                   pages_free=reng.pool.num_free, pages=reng.pool.n_pages,
                   events=[list(e) for e in chaos.events])

            meng = Engine(mcfg, mparams, EngineConfig(mesh="1x2", **KW), device="cpu")
            for i, p in enumerate(mp):
                meng.submit(p, 8, 0.0, seed=i)
            record("moe", meng, meng.run(), shard_map=meng.cfg.moe_shard_map,
                   experts_held=int(meng.runner.params["stages"][0]["0"]["ffn"]["w_gate"]
                                    .shape[1]))
            scfg = mcfg.with_(moe_shard_map=True)
            sp = M.shard_params(scfg, mparams, meng.mesh)
            with activation_mesh(meng.mesh):
                lg = M.prefill(scfg, sp, torch.tensor([mp[0]], dtype=torch.int32))[0]
            np.save(f"{tmp}/moe_logits_r{rank}.npy", lg.numpy())

            # one prefill (B 2, S 8) and one decode step on its slot caches
            # (16 rows): the collectives and bytes each issues on this rank
            m12 = shapes[0].build()
            pcfg = prepare_arch(cfg, m12)
            psh = M.shard_params(pcfg, params, m12)
            toks = torch.tensor([p[:8] for p in prompts[1:3]], dtype=torch.int32)
            counts = {}
            with activation_mesh(m12, profile_for(pcfg), batch_entry(m12, 2, profile_for(pcfg))):
                c0, w0 = m12.collectives, m12.wire_bytes
                _, caches = M.prefill(pcfg, psh, toks, cache_len=16)
                counts["prefill"] = [m12.collectives - c0, m12.wire_bytes - w0]
                c0, w0 = m12.collectives, m12.wire_bytes
                M.decode_step(pcfg, psh, caches, toks[:, :1], 8)
                counts["decode"] = [m12.collectives - c0, m12.wire_bytes - w0]
            with open(f"{tmp}/step_counts_r{rank}.json", "w") as f:
                json.dump(counts, f)

        # w8a8 on the model axis: the row-parallel int8 GEMMs (wo, w_down)
        toks = torch.tensor([prompts[2]], dtype=torch.int32)
        single = None
        for shape in ("1x2", "2x2"):
            spec = MeshSpec.parse(shape)
            if spec.build().coords is None:
                continue
            eng = Engine(cfg, params, EngineConfig(mesh=spec, quant="w8a8", **KW),
                         device="cpu")
            for i, p in enumerate(prompts):
                eng.submit(p, 12, 0.0, seed=i)
            record(f"w8a8/{shape}", eng, eng.run(),
                   wo=list(eng.params["stages"][0]["0"]["mixer"]["wo"].q.shape))
            with eng.runner.on_mesh():
                lg = M.prefill(eng.cfg, eng.runner.params, toks)[0]
            if single is None:
                single = M.prefill(cfg, M.quantize_params(cfg, params), toks)[0]
            out[f"w8a8/{shape}"]["logits_equal_single"] = bool(torch.equal(lg, single))
            np.save(f"{tmp}/w8a8_{shape}_logits_r{rank}.npy", lg.numpy())

        # head-parallel Mamba-2 SSD, and the jamba hybrid
        for arch, runs in (("mamba2-130m", (("1x2", None), ("2x1", None), ("2x2", None),
                                            ("1x2", "w8a8"))),
                           ("jamba-v0.1-52b", (("1x2", None),))):
            scfg = TC.reduce_config(TC.get_config(arch))
            sparams = bridge.params_from_numpy(scfg, dict(np.load(f"{tmp}/{arch}.npz")), "cpu")
            sp = [[(5 * i + j) % scfg.vocab_size for j in range((6, 11)[i % 2])]
                  for i in range(4)]
            for shape, quant in runs:
                spec = MeshSpec.parse(shape)
                if spec.build().coords is None:
                    continue
                eng = Engine(scfg, sparams, EngineConfig(mesh=spec, quant=quant, **KW),
                             device="cpu")
                for i, p in enumerate(sp):
                    eng.submit(p, 8, 0.0, seed=i)
                ssm = next(g for g in eng.runner.caches[0].values() if "h" in g)
                record(f"ssd/{arch}/{shape}/{quant}", eng, eng.run(),
                       h=list(ssm["h"].shape), shard_map=eng.cfg.moe_shard_map)
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)

    if __name__ == "__main__":
        D.spawn(body, 4, "gloo", args=(sys.argv[1],))
""")


def _jax_tokens(eng, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, 0.0, seed=i)
    return sorted([r.rid, list(r.generated), r.finish_reason.value] for r in eng.run())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(what each rank served, keyed by scenario; the JAX single-device
    engine's answers to the same scenarios)."""
    tmp = tmp_path_factory.mktemp("mesh")
    ecfg = JC.reduce_config(JC.get_config("cgra-edge"))
    eparams = JM.init(ecfg, jax.random.PRNGKey(0))
    mcfg = JC.reduce_config(JC.get_config("qwen3-moe-30b-a3b"))
    mparams = JM.init(mcfg, jax.random.PRNGKey(1))
    np.savez(tmp / "edge.npz", **_flatten(eparams))
    np.savez(tmp / "moe.npz", **_flatten(mparams))
    m3cfg = mcfg.with_(num_experts=3)
    m3params = JM.init(m3cfg, jax.random.PRNGKey(3))
    np.savez(tmp / "moe3.npz", **_flatten(m3params))
    ssd = {}
    for arch in SSD_ARCHS:
        scfg = JC.reduce_config(JC.get_config(arch))
        ssd[arch] = (scfg, JM.init(scfg, jax.random.PRNGKey(2)))
        np.savez(tmp / f"{arch}.npz", **_flatten(ssd[arch][1]))
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(script), str(tmp)], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    # the JAX engine's answers, computed while the ranks serve
    prompts = _prompts(ecfg.vocab_size)
    want = {f"dense/{c}": _jax_tokens(JEngine(ecfg, eparams, JEngineConfig(
        chunk_tokens=c, **KW)), prompts, 12) for c in (None, 8)}
    family = [prompts[0] * 7 + [t] for t in (1, 2, 3)]
    want["radix"] = _jax_tokens(JEngine(ecfg, eparams, JEngineConfig(**KW)), family, 8)
    ref = JEngine(ecfg, eparams, JEngineConfig(chunk_tokens=8, **KW))
    ref.submit(prompts[0], 16, 0.0, seed=0)
    res = ref.step()
    ref.submit(prompts[1], 16, 0.0, seed=1)
    while ref.num_queued or ref.num_active:
        res.extend(ref.step())
    want["midstream"] = sorted([r.rid, list(r.generated), r.finish_reason.value] for r in res)
    mp = _moe_prompts(mcfg.vocab_size)
    want["moe"] = _jax_tokens(JEngine(mcfg, mparams, JEngineConfig(**KW)), mp, 8)
    want["moe_logits"] = np.asarray(JM.prefill(mcfg, mparams, {"tokens": jnp.asarray(
        np.array([mp[0]]), jnp.int32)})[0])
    want["moe3"] = _jax_tokens(JEngine(m3cfg, m3params, JEngineConfig(**KW)), mp, 8)
    want["moe3_logits"] = np.asarray(JM.prefill(m3cfg, m3params, {"tokens": jnp.asarray(
        np.array([mp[0]]), jnp.int32)})[0])
    want["w8a8"] = _jax_tokens(JEngine(ecfg, eparams, JEngineConfig(quant="w8a8", **KW)),
                               prompts, 12)
    qcfg = ecfg.with_(quant="w8a8")
    want["w8a8_logits"] = np.asarray(JM.prefill(qcfg, JM.quantize_params(qcfg, eparams), {
        "tokens": jnp.asarray(np.array([prompts[2]]), jnp.int32)})[0])
    for arch, (scfg, sparams) in ssd.items():
        sp = _ssd_prompts(scfg.vocab_size)
        for quant in (None, "w8a8") if arch == "mamba2-130m" else (None,):
            want[f"ssd/{arch}/{quant}"] = _jax_tokens(
                JEngine(scfg, sparams, JEngineConfig(quant=quant, **KW)), sp, 8)

    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]
    logits = [np.load(tmp / f"moe_logits_r{r}.npy") for r in range(2)]
    # rank 0's collectives and bytes of one prefill and one decode step at 1x2
    want["step_counts_1x2"] = json.loads((tmp / "step_counts_r0.json").read_text())
    for shape, n in (("1x2", 2), ("2x2", 4)):
        want[f"w8a8/{shape}/ranks"] = [np.load(tmp / f"w8a8_{shape}_logits_r{r}.npy")
                                       for r in range(n)]
        want[f"moe3/{shape}/ranks"] = [np.load(tmp / f"moe3_{shape}_logits_r{r}.npy")
                                       for r in range(n)]
    return ranks, want, logits


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_greedy_tokens_equal_the_jax_engine(served, shape, chunk):
    """1x2 / 1x4: tensor-parallel layers, KV pools over KV heads, the vocab-
    parallel head; 2x1 / 2x2: the decode batch (4 slots) split over the data
    group as well.  Whole-suffix and chunked prefill."""
    ranks, want, _ = served
    got = ranks[0][f"dense/{shape}/{chunk}"]
    assert got["tokens"] == want[f"dense/{chunk}"]
    assert got["agree"] and not got["graphed"] and got["collectives"] > 0


def test_radix_reuse_under_the_mesh(served):
    ranks, want, _ = served
    warm, cold = ranks[0]["radix"], ranks[0]["radix_cold"]
    assert warm["hit_rate"] > 0
    assert warm["tokens"] == cold["tokens"] == want["radix"]


def test_prompt_joins_mid_stream(served):
    """A second prompt submitted while the first decodes streams in through
    mixed ticks under the mesh, with the JAX engine's tokens."""
    ranks, want, _ = served
    got = ranks[0]["midstream"]
    assert got["tokens"] == want["midstream"] and got["mixed"] > 0


def test_resilience_counters_move_once(served):
    """FAULT (a NaN-poisoned step), CANCELLED, REJECTED and DEADLINE (the
    chaos clock skew, read by rank 0 and broadcast) each once; the pool
    reconciles."""
    ranks, _, _ = served
    got = ranks[0]["resilience"]
    ra, rb, rc, rd = got["rids"]
    reasons = {rid: reason for rid, _, reason in got["tokens"]}
    assert reasons == {ra: "fault", rb: "cancelled", rc: "rejected", rd: "deadline"}
    assert got["cancelled"] and got["counters"] == [1, 1, 1, 1, 0]
    assert got["pages_free"] == got["pages"] - 1
    assert ranks[1]["resilience"]["events"] == got["events"]


@pytest.mark.parametrize("key", ["moe", "moe_2x2"])
def test_moe_expert_parallel_tokens_equal_the_jax_engine(served, key):
    """1x2: 2 of the 4 experts a rank; 2x2: the same, and the decode batch
    split over the data group (gathered whole before routing: capacity is
    shared by every row of a call)."""
    ranks, want, _ = served
    got = ranks[0][key]
    assert got["shard_map"] and got["tokens"] == want["moe"]
    if key == "moe":
        assert got["experts_held"] == 2


def test_moe_expert_parallel_prefill_logits(served):
    """The expert-parallel prefill (one f32 all-reduce of the partial
    outputs a MoE layer) within 1e-4 of JAX's single-device prefill, f32,
    and the same bytes on both ranks."""
    _, want, logits = served
    assert float(np.max(np.abs(logits[0] - want["moe_logits"]))) <= 1e-4
    assert np.array_equal(logits[0], logits[1])


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_moe_ffn_parallel_equals_the_jax_engine(served, shape):
    """3 experts over a model axis of 2: no expert-parallel split; every
    rank runs all 3 experts on its 16 of each expert's 32 FFN columns and
    one f32 all-reduce sums the layer's output (at 2x2 the decode batch is
    split over data too).  Greedy tokens equal the JAX single-device
    engine's; a prefill's logits within 1e-4 of JAX's, the same on every
    rank."""
    ranks, want, _ = served
    got = ranks[0][f"moe3/{shape}"]
    assert got["tokens"] == want["moe3"] and got["agree"] and not got["shard_map"]
    assert got["w_gate"][1:] == [3, 64, 16]  # [layers, E, D, F / 2]
    lg = want[f"moe3/{shape}/ranks"]
    assert all(np.array_equal(lg[0], x) for x in lg[1:])
    assert float(np.max(np.abs(lg[0] - want["moe3_logits"]))) <= 1e-4


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_w8a8_on_the_model_axis_equals_the_single_device(served, shape):
    """w8a8 with wo and w_down row-parallel (each rank's K slice quantized
    with the whole row's scale, the int32 partials summed exactly): greedy
    tokens equal the JAX single-device w8a8 engine's; a prefill's logits
    equal the port's single rank bit for bit on every rank, and sit within
    1e-4 of JAX's."""
    ranks, want, _ = served
    got = ranks[0][f"w8a8/{shape}"]
    assert got["tokens"] == want["w8a8"] and got["agree"]
    assert got["wo"][-1] == 64 // 2  # K = H * dh = 64, cut over the model axis
    n = 2 if shape == "1x2" else 4
    assert all(ranks[r][f"w8a8/{shape}"]["logits_equal_single"] for r in range(n))
    lg = want[f"w8a8/{shape}/ranks"]
    assert all(np.array_equal(lg[0], x) for x in lg[1:])
    assert float(np.max(np.abs(lg[0] - want["w8a8_logits"]))) <= 1e-4


@pytest.mark.parametrize("arch,shape,quant", [
    ("mamba2-130m", "1x2", None), ("mamba2-130m", "2x1", None), ("mamba2-130m", "2x2", None),
    ("mamba2-130m", "1x2", "w8a8"), ("jamba-v0.1-52b", "1x2", None)])
def test_ssd_on_a_mesh_equals_the_jax_engine(served, arch, shape, quant):
    """Head-parallel SSD (4 of the 8 heads a rank on a model axis of 2; the
    state's slots over the data group at 2x1 and 2x2) through whole-prefill
    admission and decode ticks: greedy tokens equal the JAX single-device
    engine's.  jamba at 1x2 also splits its attention heads and runs its
    MoE expert-parallel."""
    ranks, want, _ = served
    got = ranks[0][f"ssd/{arch}/{shape}/{quant}"]
    assert got["tokens"] == want[f"ssd/{arch}/{quant}"] and got["agree"]
    data, model = (int(v) for v in shape.split("x"))
    _, slots, heads = got["h"][:3]
    assert (slots, heads) == (KW["max_batch"] // data, 8 // model)
    assert got["shard_map"] == (arch == "jamba-v0.1-52b")


def test_every_rank_emits_the_same_tokens(served):
    """Each rank of a scenario's mesh recorded the same tokens, and the
    engine's own digest check agreed on every rank."""
    ranks, _, _ = served
    n = {"1x2": 2, "1x4": 4, "2x1": 2, "2x2": 4}
    checked = 0
    for key, got in ranks[0].items():
        shape = key.split("/")[2] if key.startswith("ssd/") else key.split("/")[-1]
        size = (n[key.split("/")[1]] if key.startswith("dense/")
                else n[shape] if key.startswith(("w8a8/", "ssd/", "moe3/"))
                else 4 if key == "moe_2x2" else 2)
        for r in range(1, size):
            assert ranks[r][key]["tokens"] == got["tokens"], (key, r)
            assert ranks[r][key]["agree"]
            checked += 1
        for r in range(size, 4):
            assert key not in ranks[r]
    assert checked >= 16 + 3 + 5 + 4 + 7 + 4


def test_a_mesh_without_a_process_group_is_refused():
    """No group started: the engine names how to start the ranks, for w8a8
    on a model axis and for SSD on a mesh too -- both are served on a
    mesh, so they reach the same refusal as any other model."""
    assert not torch.distributed.is_initialized()
    cfg = TC.reduce_config(TC.get_config("cgra-edge"))
    params = TM.init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        Engine(cfg, params, EngineConfig(mesh="1x2", **KW), device="cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        Engine(cfg, params, EngineConfig(mesh="1x2", quant="w8a8", **KW), device="cpu")
    scfg = TC.reduce_config(TC.get_config("mamba2-130m"))
    with pytest.raises(ValueError, match="init_process_group"):
        Engine(scfg, TM.init(scfg, seed=0, device="cpu"), EngineConfig(mesh="2x1", **KW),
               device="cpu")


def test_a_graph_under_gloo_on_the_card_is_refused():
    """Asked for on a CUDA device of a gloo mesh, the decode graph raises
    before it allocates anything (gloo collectives cannot be captured);
    not asked for, it is eager there by rule, and graphed under NCCL."""
    gloo = types.SimpleNamespace(backend="gloo")
    with pytest.raises(ValueError, match="gloo.*cannot be captured"):
        DecodeGraph(None, None, None, 4, 8, device="cuda", mesh=gloo, capture=True)
    cfg = TC.reduce_config(TC.get_config("cgra-edge"))
    params = TM.init(cfg, seed=0, device="cpu")
    caches = TM.init_paged_cache(cfg, 2, 5, 8, device="cpu")
    g = DecodeGraph(cfg, params, caches, 2, 4, device="cpu", mesh=gloo)
    assert not g.graphed


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_dry_mesh_counts_equal_live_mesh(served, step):
    """The dry run of reduced cgra-edge's prefill (B 2, S 8) and of a decode
    step on 16-row slot caches, on meta arguments over a ``DryMesh`` 1x2
    (rank 0), issues rank 0's collectives and wire bytes of the same step
    on the live gloo mesh, exactly."""
    _, want, _ = served
    cfg = TC.reduce_config(TC.get_config("cgra-edge"))
    shape = ShapeConfig("t", 8 if step == "prefill" else 16, 2, step)
    mesh = DryMesh((1, 2), ("data", "model"))
    count(build_cell(cfg, shape, mesh))
    assert [mesh.collectives, mesh.wire_bytes] == want["step_counts_1x2"][step]
    assert mesh.collectives > 0

