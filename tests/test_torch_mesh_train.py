"""Training over a mesh in the port against the JAX package on one device.

Four gloo ranks on the CPU, spawned once for the module, train reduced
olmo-1b at 1x2 ("2d": tensor parallel), 2x1 (FSDP over ``data``), 2x2
("2d" with FSDP) and 2x2 ``parallel_mode="fsdp"``, and reduced
qwen3-moe-30b-a3b at 2x1 (the aux loss across data ranks), 1x2
(expert-parallel backward), 2x2 and 1x2 under ``"fsdp"`` (each dispatch
group over two ranks, which place their choices' slots together from each
other's counts; capacity drops choices; 1x2 under ``remat_policy="full"``,
so the recompute gathers the counts again) and, with 3 experts in both
packages, at 1x2 and 2x2 (every expert's FFN cut over the model axis); 2x1 again with bf16 and int8 moments and with
``accum_steps=2``, and 2x2 under ``remat_policy="full"``.  A rank outside a scenario's mesh sits it out.  The
weights come from the JAX package (``bridge.params_from_numpy``), each
config passed through both packages' ``prepare_arch`` for the scenario's
mesh, f32, 2 steps on ``SyntheticLM`` batches of 4 x 16 tokens.  Each rank
writes what it trained, gathered whole; each test reads one scenario:

- gradients of every leaf within 1e-5 (of the leaf's largest entry) of
  ``jax.grad(repro.models.model.loss_fn)`` on the global batch;
- loss and ``grad_norm`` within 1e-5 (relative) of the JAX step's, at both
  steps, and equal on every rank;
- moments after the first step equal to the JAX step's (f32 within 1e-5 of
  the leaf's largest entry; bf16 within that or one bf16 rounding step; int8 scales
  within 1e-5 and values equal but for at most one entry in a thousand one
  step apart, a rounding boundary);
- parameters after both steps (see :func:`_params_rule`);
- checkpoints: written at 2x1, restored bit-equal at 1x1 and 1x2; a
  ``FailureInjector`` restart at 2x1 ends where an unfailed run ends;
- the launcher: ``--mesh 2x1 --backend gloo --device cpu`` prints the
  reference's lines once, with the single device's losses; a mesh that
  does not match the world size is refused.

The other families (MLA, SSD, jamba, cross-attention, the encoder) run
the same ranks and checks in ``test_torch_mesh_train_families.py``, one
spawn of their own (:func:`train_on_ranks`).
"""
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

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.launch.cells import prepare_arch as j_prepare_arch
from repro.models import model as JM
from repro.training import step as JT
from repro.training.optimizer import AdamWConfig as JAdamW
import repro_torch.configs as TC
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import count
from repro_torch.launch.mesh import DryMesh
from repro_torch.training import AdamWConfig, make_train_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
B, S, STEPS = 4, 16, 2
ARCHS = {"olmo": "olmo-1b", "moe": "qwen3-moe-30b-a3b", "moe3": "qwen3-moe-30b-a3b",
         "mla": "minicpm3-4b", "ssd": "mamba2-130m", "jamba": "jamba-v0.1-52b",
         "vlm": "llama-3.2-vision-11b", "vlmqk": "llama-3.2-vision-11b", "enc": "hubert-xlarge"}
# config fields an arch key sets in both packages, on top of its reduced config:
# moe3's 3 experts do not divide over a model axis of 2, so its 32-wide
# expert FFNs are cut over it
OVERRIDES = {"vlmqk": {"use_qk_norm": True}, "moe3": {"num_experts": 3}}
# name: (arch, data, model, parallel_mode, fsdp, moments, accum, remat_policy)
SCENARIOS = {
    "olmo/1x2": ("olmo", 1, 2, "2d", True, "f32", 1, "none"),
    "olmo/2x1": ("olmo", 2, 1, "2d", True, "f32", 1, "none"),
    "olmo/2x2": ("olmo", 2, 2, "2d", True, "f32", 1, "none"),
    "olmo/2x2/fsdp": ("olmo", 2, 2, "fsdp", True, "f32", 1, "none"),
    "moe/2x1": ("moe", 2, 1, "2d", True, "f32", 1, "none"),
    "moe/1x2": ("moe", 1, 2, "2d", True, "f32", 1, "none"),
    # a dispatch group over ranks: 2 groups, each over a model pair; one over
    # both, under the config's own remat (its counts gathered again in the recompute)
    "moe/2x2/fsdp": ("moe", 2, 2, "fsdp", True, "f32", 1, "none"),
    "moe/1x2/fsdp": ("moe", 1, 2, "fsdp", True, "f32", 1, "full"),
    # every expert's FFN cut over the model axis (with FSDP over data at 2x2)
    "moe3/1x2": ("moe3", 1, 2, "2d", True, "f32", 1, "none"),
    "moe3/2x2": ("moe3", 2, 2, "2d", True, "f32", 1, "none"),
    "olmo/2x1/bf16": ("olmo", 2, 1, "2d", True, "bf16", 1, "none"),
    "olmo/2x1/int8": ("olmo", 2, 1, "2d", True, "int8", 1, "none"),
    "olmo/2x1/accum2": ("olmo", 2, 1, "2d", True, "f32", 2, "none"),
    # the FSDP gathers inside each layer's checkpoint, run again in the recompute
    "olmo/2x2/remat": ("olmo", 2, 2, "2d", True, "f32", 1, "full"),
}
GRAD_RTOL = 1e-5

RANKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch

    import repro_torch.configs as TC
    from repro_torch.checkpoint.manager import CheckpointManager, flatten
    from repro_torch.core.quant import QTensor
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dist as D
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.cells import prepare_arch
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.sharding import gather_whole
    from repro_torch.models import bridge
    from repro_torch.models import layers as TL
    from repro_torch.runtime import FailureInjector, TrainRunner
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.optimizer import init_moments
    from repro_torch.training.step import (TrainState, mesh_value_and_grad, shard_state,
                                           state_pspecs)

    def whole(tree, specs, mesh):
        def one(x, ps):
            if isinstance(x, QTensor):
                return QTensor(gather_whole(x.q, mesh, ps.q), gather_whole(x.scale, mesh, ps.scale))
            return gather_whole(x, mesh, ps)
        return tree_map(one, tree, specs)

    def whole_state(st, specs, mesh):
        return TrainState(st.step, *(whole(getattr(st, f), getattr(specs, f), mesh)
                                     for f in ("params", "mu", "nu")))

    def setup(tmp, plan, name, mesh):
        arch, d, m, mode, fsdp, moments, accum, remat = plan["scenarios"][name]
        cfg = TC.reduce_config(TC.get_config(plan["archs"][arch])).with_(
            fsdp=fsdp, parallel_mode=mode, remat_policy=remat,
            **plan["overrides"].get(arch, {}))
        cfg = prepare_arch(cfg, mesh)
        opt = AdamWConfig(**plan["opt"], moments_dtype=moments)
        params = bridge.params_from_numpy(cfg, dict(np.load(f"{tmp}/{name.replace('/', '_')}.npz")),
                                          "cpu")
        mu, nu = init_moments(params, opt)
        state = TrainState(torch.zeros((), dtype=torch.int32), params, mu, nu)
        return cfg, opt, accum, shard_state(cfg, opt, state, mesh), state_pspecs(cfg, opt, mesh)

    DROPPED = []  # the choices each MoE route of a gradient pass dropped

    def counted_route(*a, _route=TL.moe_route, **kw):
        r = _route(*a, **kw)
        DROPPED.append(int((~r.kept).sum()))
        return r

    def body(rank, tmp):
        torch.set_num_threads(1)
        TL.moe_route = counted_route
        plan = json.load(open(f"{tmp}/plan.json"))
        meshes = {}
        for sh in ((1, 2), (2, 1), (2, 2), (1, 4)):  # every rank makes every mesh's groups, in order
            meshes[sh] = make_device_mesh(sh, ("data", "model"))
        out = {}
        for name, (arch, d, m, *_rest) in plan["scenarios"].items():
            mesh = meshes[(d, m)]
            if mesh.coords is None:
                continue
            cfg, opt, accum, state, specs = setup(tmp, plan, name, mesh)
            batches = [dict(np.load(f"{tmp}/{arch}_b{i}.npz")) for i in range(2)]
            arrays = {}
            DROPPED.clear()
            _, _, g = mesh_value_and_grad(cfg, state.params, batches[0], mesh,
                                          accum_steps=accum)
            dropped = sum(DROPPED)
            arrays.update({"g/" + k: v for k, v in flatten(whole(g, specs.params, mesh)).items()})
            step = make_train_step(cfg, opt, accum_steps=accum, mesh=mesh)
            metrics = []
            for i in range(2):
                c0, w0 = mesh.collectives, mesh.wire_bytes
                state, mt = step(state, batches[i])
                if i == 0:  # the first step's collectives and bytes on this rank
                    step_counts = [mesh.collectives - c0, mesh.wire_bytes - w0]
                metrics.append({k: float(mt[k]) for k in ("loss", "grad_norm", "ce", "aux")})
                arrays.update({f"s{i + 1}/" + k: v for k, v in
                               flatten(whole_state(state, specs, mesh)).items()})
            out[name] = dict(metrics=metrics, collectives=mesh.collectives,
                             wire_bytes=mesh.wire_bytes, step_counts=step_counts,
                             dropped=dropped)
            if rank == 0:
                np.savez(f"{tmp}/out_{name.replace('/', '_')}.npz", **arrays)

        if not plan["extras"]:
            with open(f"{tmp}/rank{rank}.json", "w") as f:
                json.dump(out, f)
            return
        # checkpoints: the 2x1 state after two steps written at 2x1, restored
        # at 1x1 (rank 0 alone) and at 1x2
        m21, m12 = meshes[(2, 1)], meshes[(1, 2)]
        if m21.coords is not None:
            cfg, opt, accum, state, specs = setup(tmp, plan, "olmo/2x1", m21)
            step = make_train_step(cfg, opt, mesh=m21)
            data = SyntheticLM(cfg, batch=4, seq=16)
            for i in range(2):
                state, _ = step(state, data.batch_at(i))
            mgr = CheckpointManager(f"{tmp}/ck", mesh=m21, specs=specs)
            mgr.save(2, state)
            mgr.wait()
            if rank == 0:
                np.savez(f"{tmp}/ck_written.npz", **flatten(whole_state(state, specs, m21)))
            else:
                whole_state(state, specs, m21)
            # a restart: fail before step 3 of 4, resume from the step-2 checkpoint
            runs = {}
            for tag, fail in (("failed", {3}), ("clean", set())):
                _, _, _, st0, _ = setup(tmp, plan, "olmo/2x1", m21)
                runner = TrainRunner(step, data.batch_at,
                                     CheckpointManager(f"{tmp}/run_{tag}", mesh=m21, specs=specs),
                                     ckpt_every=2, injector=FailureInjector(fail), mesh=m21)
                st, rep = runner.run(st0, 4)
                flat = flatten(whole_state(st, specs, m21))
                runs[tag] = dict(losses=rep.losses, restarts=rep.restarts, final=rep.final_step)
                if rank == 0:
                    np.savez(f"{tmp}/run_{tag}.npz", **flat)
            out["runner"] = runs
        if rank == 0:
            cfg, opt, _, _, _ = setup(tmp, plan, "olmo/2x1", m21)
            from repro_torch.training.step import init_state
            like = init_state(cfg, opt, 0, "cpu")
            got = CheckpointManager(f"{tmp}/ck").restore(2, like)
            np.savez(f"{tmp}/ck_1x1.npz", **flatten(got))
        if m12.coords is not None:
            cfg, opt, _, st12, specs12 = setup(tmp, plan, "olmo/1x2", m12)
            got = CheckpointManager(f"{tmp}/ck", mesh=m12, specs=specs12).restore(2, st12)
            flat = flatten(whole_state(got, specs12, m12))
            if rank == 0:
                np.savez(f"{tmp}/ck_1x2.npz", **flat)

        # the launcher inside a group of 4 ranks, asked for a 2-rank mesh
        try:
            train_cli.main(["--arch", "olmo-1b", "--reduced", "--steps", "1", "--mesh", "2x1",
                            "--backend", "gloo", "--device", "cpu"])
            out["mismatch"] = None
        except ValueError as e:
            out["mismatch"] = str(e)
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)

    if __name__ == "__main__":
        D.spawn(body, 4, "gloo", args=(sys.argv[1],))
""")


def _jcfg(arch, d, m, mode, fsdp):
    cfg = JC.reduce_config(JC.get_config(ARCHS[arch])).with_(fsdp=fsdp, parallel_mode=mode,
                                                             **OVERRIDES.get(arch, {}))
    return j_prepare_arch(cfg, types.SimpleNamespace(shape={"data": d, "model": m}))


def _open_zero_leaves(params, seed: int = 0):
    """The JAX tree with its zero-initialised leaves opened: every cross
    gate 0.5 (a closed gate zeroes every cross weight's gradient), every
    bias (the GELU MLP's b1 / b2, the LayerNorms') 0.1 x N(0, 1) from a
    numpy ``seed`` (a zero bias hides one added on each rank)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        last = key.rsplit("/", 1)[-1]
        if last == "gate":
            return jnp.full(a.shape, 0.5, a.dtype)
        if last in ("b1", "b2", "bias"):
            return jnp.asarray(0.1 * rng.randn(*a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


def _jax_state(name, scenarios=SCENARIOS):
    arch, d, m, mode, fsdp, moments, accum, _ = scenarios[name]
    cfg = _jcfg(arch, d, m, mode, fsdp)
    opt = JAdamW(**OPT, moments_dtype=moments)
    state = JT.init_state(cfg, opt, jax.random.PRNGKey(7))
    return cfg, opt, accum, state._replace(params=_open_zero_leaves(state.params))


def _jax_key(name, scenarios=SCENARIOS):
    """What the JAX package's single-device run of a scenario depends on:
    the mesh reaches it only through the padded heads and the MoE groups."""
    arch, d, m, mode, fsdp, moments, accum, _ = scenarios[name]
    cfg = _jcfg(arch, d, m, mode, fsdp)
    return (arch, moments, accum, cfg.padded_heads, cfg.num_moe_groups if cfg.num_experts else 0)


def _jax_run(name, batches, scenarios=SCENARIOS):
    """The JAX package's side of a scenario on one device: gradients at
    both steps, the two steps' metrics and states."""
    cfg, opt, accum, state = _jax_state(name, scenarios)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    gfn = jax.jit(jax.grad(lambda p, b: JM.loss_fn(cfg, p, b)[0]))

    def grads(params, b):
        return _flatten(gfn(params, b))

    step = jax.jit(JT.make_train_step(cfg, opt, accum_steps=accum))
    out = {"g": [grads(state.params, jb[0])], "metrics": [], "states": [],
           "p0": _flatten(state.params)}
    for i in range(STEPS):
        if i:
            out["g"].append(grads(state.params, jb[i]))
        state, mt = step(state, jb[i])
        out["metrics"].append({k: float(mt[k]) for k in ("loss", "grad_norm", "ce", "aux")})
        out["states"].append(_flatten(state))
    return out


def train_on_ranks(tmp, scenarios, extras: bool):
    """Spawn the four gloo ranks on ``scenarios`` (and, with ``extras``, the
    checkpoint, restart and launcher cases) and run the JAX side meanwhile:
    (what each rank trained, keyed by scenario; the JAX runs; ``tmp``)."""
    archs = {sc[0] for sc in scenarios.values()}
    batches = {}
    for arch in archs:
        cfg = TC.reduce_config(TC.get_config(ARCHS[arch])).with_(**OVERRIDES.get(arch, {}))
        data = SyntheticLM(cfg, batch=B, seq=S)
        batches[arch] = [data.batch_at(i) for i in range(STEPS)]
        for i, b in enumerate(batches[arch]):
            np.savez(tmp / f"{arch}_b{i}.npz", **b)
    for name in scenarios:  # the weights the ranks load
        np.savez(tmp / f"{name.replace('/', '_')}.npz",
                 **_flatten(_jax_state(name, scenarios)[3].params))
    (tmp / "plan.json").write_text(json.dumps(dict(archs=ARCHS, opt=OPT, scenarios=scenarios,
                                                   overrides=OVERRIDES, extras=extras)))
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(script), str(tmp)], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    # the JAX runs, computed while the ranks train
    want, runs = {}, {}
    for name in scenarios:  # one run for the scenarios JAX computes alike
        key = _jax_key(name, scenarios)
        if key not in runs:
            runs[key] = _jax_run(name, batches[scenarios[name][0]], scenarios)
        want[name] = runs[key]
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]
    return ranks, want, tmp


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_on_ranks(tmp_path_factory.mktemp("mesh_train"), SCENARIOS, extras=True)


def _out(tmp, name):
    return dict(np.load(tmp / f"out_{name.replace('/', '_')}.npz"))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_gradients_equal_jax_grad(trained, name):
    """Every leaf's gathered gradient within 1e-5 of the leaf's largest
    entry of JAX's gradient of the global batch's loss: tensor-parallel
    enter / leave, FSDP gathers (reduce-scatter backward), the vocab-parallel
    cross entropy, the MoE aux averaged over the data ranks and the
    expert-parallel backward."""
    check_gradients(trained, name)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_loss_and_grad_norm_equal_the_jax_step(trained, name):
    check_loss_and_grad_norm(trained, name, SCENARIOS)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_parameters_after_two_steps(trained, name):
    _, want, tmp = trained
    _params_rule(name, _out(tmp, name), want[name])


def check_gradients(trained, name, against=None):
    """Every leaf of the scenario's gathered gradient within ``GRAD_RTOL`` of
    the leaf's largest entry of JAX's gradient, or of ``against`` (a flat
    gradient of the same keys) where it is given."""
    _, want, tmp = trained
    got = _out(tmp, name)
    for key, w in (want[name]["g"][0] if against is None else against).items():
        w = np.asarray(w, np.float32)
        g = got["g/" + key]
        assert g.shape == w.shape, key
        assert np.max(np.abs(g - w)) <= GRAD_RTOL * max(np.max(np.abs(w)), 1e-30), (name, key)


def check_loss_and_grad_norm(trained, name, scenarios):
    ranks, want, _ = trained
    arch, d, m = scenarios[name][:3]
    for i in range(STEPS):
        got, ref = ranks[0][name]["metrics"][i], want[name]["metrics"][i]
        for k in ("loss", "grad_norm", "ce", "aux"):
            assert abs(got[k] - ref[k]) <= 1e-5 * max(abs(ref[k]), 1.0), (name, i, k)
    for r in range(1, d * m):
        assert ranks[r][name]["metrics"] == ranks[0][name]["metrics"]
    for r in range(d * m, 4):
        assert name not in ranks[r]
    assert ranks[0][name]["collectives"] > 0


def test_groups_over_ranks_drop_choices(trained):
    """In the ``fsdp`` scenarios each dispatch group spans ranks, and
    capacity drops choices there (the cross-rank slots decide which): the
    gradients above hold the kept ones equal to the reference's."""
    ranks, _, _ = trained
    for name in ("moe/2x2/fsdp", "moe/1x2/fsdp"):
        d, m = SCENARIOS[name][1:3]
        assert sum(r[name]["dropped"] for r in ranks[:d * m]) > 0, name


@pytest.mark.parametrize("name", ["olmo/1x2", "olmo/2x1", "moe/2x2/fsdp", "moe/1x2/fsdp",
                                  "moe3/2x2"])
def test_dry_mesh_counts_equal_live_mesh(trained, name):
    """The dry run of the scenario's train step (meta arguments at rank 0's
    shapes on a ``DryMesh`` of the scenario's shape, FSDP on, this rank's
    rows of the 4 x 16 batch) issues rank 0's collectives and wire bytes of
    the first live step, exactly (a group over ranks: its int32 count
    gathers too)."""
    ranks, _, _ = trained
    arch, d, m, mode, fsdp, moments, accum, remat = SCENARIOS[name]
    cfg = TC.reduce_config(TC.get_config(ARCHS[arch])).with_(
        fsdp=fsdp, parallel_mode=mode, remat_policy=remat, **OVERRIDES.get(arch, {}))
    mesh = DryMesh((d, m), ("data", "model"))
    count(build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh,
                     opt=AdamWConfig(**OPT, moments_dtype=moments), accum_steps=accum))
    assert [mesh.collectives, mesh.wire_bytes] == ranks[0][name]["step_counts"]
    assert mesh.collectives > 0


def _params_rule(name, got, want):
    """Parameters after both steps.  An AdamW step moves an entry by ``u =
    lr * m / sqrt(v)`` (plus decay); a gradient error of ``e`` moves ``u``
    by about ``|u| * e / |g|``.  The gradient bound (1e-5 of the leaf's
    largest gradient, ``gmax``) gives an entry whose smaller JAX gradient
    over the two steps is ``gmin``, and whose larger JAX step is ``u``, an
    allowance of ``4 * max(lr, u) * min(1, 1e-5 * gmax / gmin)`` (an entry
    at round-off may go either way), on top of 1e-5 of the leaf's largest
    parameter.  ``u`` is about ``lr`` for f32 and bf16 moments; int8
    moments can make it hundreds of times ``lr``, where the second moment
    of a small entry quantizes to 0 (ROADMAP Queue 3).  With int8 moments
    an entry whose moment values differ from JAX's by a rounding step at
    either step (:func:`test_moments_equal_the_jax_step` bounds how many)
    is allowed ``4 * max(lr, u)``."""
    lr = OPT["lr"]
    for key, w in want["states"][-1].items():
        if not key.startswith(".params/"):
            continue
        w = np.asarray(w, np.float32)
        p = got["s2/" + key]
        leaf = key[len(".params/"):]
        gs = [np.abs(np.asarray(g[leaf], np.float64)) for g in want["g"]]
        gmax = max(float(np.max(g)) for g in gs)
        gmin = np.minimum(*gs) if len(gs) > 1 else gs[0]
        ps = [np.asarray(want["p0"][leaf], np.float64)] + [
            np.asarray(st[key], np.float64) for st in want["states"]]
        u = np.maximum(lr, np.max([np.abs(b - a) for a, b in zip(ps, ps[1:])], 0))
        allow = 4 * u * np.minimum(1.0, GRAD_RTOL * gmax / np.maximum(gmin, 1e-30))
        for t, st in enumerate(want["states"]):
            for m in (".mu/", ".nu/"):
                q = m + leaf + "/.q"
                if q in st:
                    flip = got[f"s{t + 1}/" + q] != np.asarray(st[q])
                    allow[flip] = 4 * u[flip]
        tight = 1e-5 * max(float(np.max(np.abs(w))), 1e-30)
        err = np.abs(p - w)
        assert np.all(err <= tight + allow), (name, key, float(np.max(err - tight - allow)))


@pytest.mark.parametrize("name", ["olmo/2x1", "olmo/2x1/bf16", "olmo/2x1/int8", "olmo/2x2",
                                  "moe/1x2"])
def test_moments_equal_the_jax_step(trained, name):
    """The moments after the first step, held as stored (f32, bf16, or int8
    values with their scales), FSDP-sharded at 2x1 and gathered whole."""
    _, want, tmp = trained
    got = _out(tmp, name)
    moments = SCENARIOS[name][5]
    flips = total = 0
    for key, w in want[name]["states"][0].items():
        if not key.startswith((".mu/", ".nu/")):
            continue
        g = got["s1/" + key]
        if moments == "int8" and key.endswith("/.q"):
            d = np.abs(g.astype(np.int32) - np.asarray(w).astype(np.int32))
            assert np.max(d) <= 1, key
            flips, total = flips + int(np.sum(d)), total + d.size
            continue
        w = np.asarray(w, np.float32)
        g = g.view(np.uint16).astype(np.uint32) << 16 if g.dtype == np.dtype("V2") else g
        g = g.view(np.float32) if g.dtype == np.uint32 else g.astype(np.float32)
        tol = 1e-5 * max(float(np.max(np.abs(w))), 1e-30)
        if moments == "bf16":  # or one bf16 rounding step
            tol = np.maximum(tol, 2.0 ** -7 * np.abs(w))
        assert np.all(np.abs(g - w) <= tol), (name, key)
    assert flips <= max(1, total // 1000)


def _bits(a) -> bytes:
    return str(a.dtype).encode() + repr(a.shape).encode() + np.ascontiguousarray(a).tobytes()


def test_checkpoint_restores_bit_equal_on_another_mesh(trained):
    """Written at 2x1 (FSDP shards gathered, rank 0 writing the logical
    tree), restored at 1x1 and at 1x2: the same bits."""
    _, _, tmp = trained
    written = dict(np.load(tmp / "ck_written.npz"))
    for other in ("ck_1x1", "ck_1x2"):
        got = dict(np.load(tmp / f"{other}.npz"))
        assert set(got) == set(written)
        for k, v in written.items():
            assert _bits(got[k]) == _bits(v), (other, k)


def test_failure_injector_restart_ends_where_a_clean_run_ends(trained):
    ranks, _, tmp = trained
    runs = ranks[0]["runner"]
    assert runs["failed"]["restarts"] == 1 and runs["clean"]["restarts"] == 0
    assert runs["failed"]["final"] == runs["clean"]["final"] == 4
    assert runs["failed"]["losses"][-2:] == runs["clean"]["losses"][-2:]
    assert ranks[1]["runner"] == runs
    a, b = dict(np.load(tmp / "run_failed.npz")), dict(np.load(tmp / "run_clean.npz"))
    assert set(a) == set(b) and all(_bits(a[k]) == _bits(b[k]) for k in b)


def test_launcher_refuses_a_mesh_that_is_not_the_world(trained):
    ranks, _, _ = trained
    for r in ranks:
        assert "mesh shape (2, 1) needs 2 devices but the platform has 4" in r["mismatch"]


def test_launcher_trains_on_a_mesh_and_prints_the_reference_lines(tmp_path):
    """``--mesh 2x1 --backend gloo --device cpu`` starts two ranks; rank 0
    alone prints the reference's lines, with the losses of the 1x1 run."""
    base = ["-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--reduced", "--steps", "4",
            "--batch", "4", "--seq", "16", "--device", "cpu", "--log-every", "2"]
    env = dict(os.environ, PYTHONPATH=SRC)
    outs = {}
    for mesh in ("1x1", "2x1"):
        extra = ["--mesh", mesh] + (["--backend", "gloo"] if mesh != "1x1" else [])
        proc = subprocess.run([sys.executable, *base, *extra, "--ckpt-dir",
                               str(tmp_path / mesh)], env=env, text=True, capture_output=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs[mesh] = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    lines = outs["2x1"]
    assert lines[0].startswith("arch=olmo-1b-smoke params=114,688 mesh={'data': 2, 'model': 1} "
                               "accum=1 moments=f32")
    assert sum(ln.startswith("done: 4 steps") for ln in lines) == 1
    steps = [ln.split(" lr ")[0] for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2
    assert steps == [ln.split(" lr ")[0] for ln in outs["1x1"] if ln.startswith("step ")]


def test_moe_ffn_split_over_the_model_axis_sums_to_the_whole_layer():
    """Experts that do not divide over the model axis leave their ``ffn``
    dim cut over it: each of two ranks (a dry 1x2 mesh, whose all-reduce
    leaves a rank's partial as it is) runs every expert on its half of the
    FFN, and the two f32 partials summed equal the whole layer within
    1e-6, at a capacity that drops choices."""
    import torch
    from repro_torch.launch.sharding import activation_mesh
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    cfg = TC.reduce_config(TC.get_config("qwen3-moe-30b-a3b")).with_(capacity_factor=0.5)
    p = {k: v[0] for k, v in TM.init(cfg, 0, "cpu")["stages"][0]["0"]["ffn"].items()}
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 12, cfg.d_model).astype(np.float32))
    whole, route = TL.moe_forward(cfg, p, x)
    assert int((~route.kept).sum()) > 0
    half = cfg.moe_d_ff // 2
    parts = []
    for r in range(2):
        cols = slice(r * half, (r + 1) * half)
        shard = dict(p, w_gate=p["w_gate"][..., cols], w_up=p["w_up"][..., cols],
                     w_down=p["w_down"][:, cols])
        with activation_mesh(DryMesh((1, 2), ("data", "model"), rank=r)):
            parts.append(TL.moe_forward(cfg, shard, x)[0])
    assert float((parts[0] + parts[1] - whole).abs().max()) <= 1e-6


def test_launcher_set_overrides_the_config():
    """``--set key=value`` (the dry run's flag) overrides config fields
    after ``--reduced``: ``parallel_mode=fsdp`` puts a MoE model's dispatch
    groups over ranks on a mesh."""
    args = train_cli.parser().parse_args(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--set",
                                          "parallel_mode=fsdp", "--set", "num_experts=3"])
    cfg = train_cli.launch_config(args)
    assert (cfg.parallel_mode, cfg.num_experts, cfg.name) == ("fsdp", 3,
                                                              "qwen3-moe-30b-a3b-smoke")
    assert train_cli.launch_config(train_cli.parser().parse_args([])) == TC.get_config("olmo-1b")


@pytest.mark.parametrize("shape, groups, over", [
    ((2, 2), 2, [("model", 2)]), ((1, 4), 2, [("model", 4)]),
    ((2, 3), 3, [("model", 3), ("data", 2)])])
def test_group_counts_gather_over_the_minor_axis_where_it_holds_the_group(shape, groups,
                                                                          over):
    """A dispatch group over s batch ranks (the ``"fsdp"`` profile, a dry
    mesh, every rank of it): this rank's slice is ``b % s`` of the batch
    split's order, and its int32 counts are gathered over ``model`` alone
    where s divides it (the group lies in one model line), else over
    every batch axis; either way the gather hands back the group's s rows."""
    import torch
    from repro_torch.launch.sharding import activation_mesh, profile_for
    from repro_torch.models import layers as TL
    cfg = TC.reduce_config(TC.get_config("qwen3-moe-30b-a3b")).with_(
        parallel_mode="fsdp", num_moe_groups=groups)
    k, E = cfg.experts_per_token, cfg.num_experts
    s = shape[0] * shape[1] // groups
    for rank in range(shape[0] * shape[1]):
        mesh = DryMesh(shape, ("data", "model"), rank=rank)
        with activation_mesh(mesh, profile_for(cfg), ("data", "model")):
            G, span = TL._group_layout(cfg, 8)
            got = span.gather(torch.zeros(k, E, dtype=torch.int32))
        assert (G, span.s, span.j) == (1, s, rank % s)
        assert got.shape == (s, k, E) and got.dtype == torch.int32
        sizes = [k * E * 4]
        for _, m in over[:-1]:
            sizes.append(sizes[-1] * m)
        assert mesh.records == [("all-gather", a, m, n) for (a, m), n in zip(over, sizes)]


def test_moe_groups_that_neither_divide_the_batch_split_are_refused():
    """4 dispatch groups over a batch split 6 ways (a dry 2x3 mesh, the
    batch over data and model): a rank's rows are neither whole groups nor
    one slice of a group, so the layer raises and names the condition."""
    import torch
    from repro_torch.launch.sharding import activation_mesh, profile_for
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    cfg = TC.reduce_config(TC.get_config("qwen3-moe-30b-a3b")).with_(
        parallel_mode="fsdp", num_moe_groups=4)
    p = {k: v[0] for k, v in TM.init(cfg, 0, "cpu")["stages"][0]["0"]["ffn"].items()}
    mesh = DryMesh((2, 3), ("data", "model"))
    with activation_mesh(mesh, profile_for(cfg), ("data", "model")):
        with pytest.raises(NotImplementedError, match="4 MoE dispatch groups over a batch "
                                                      "split 6 ways: neither divides"):
            TL.moe_forward(cfg, p, torch.zeros(1, 4, cfg.d_model))
