"""The cross-pod int8 gradient mean in the port against the JAX package.

Four gloo ranks on the CPU, spawned once for the module:

- ``compressed_mean`` / ``compressed_tree_mean``, with and without error
  feedback, over a 4-rank ``pod`` axis, against the reference's run as
  ``jax.vmap(..., axis_name="pod")`` on one device: means and residuals
  equal (f32 leaves bit for bit, a bf16 leaf within one bf16 rounding),
  an all-zero leaf included; the int8 wire carries a quarter of f32's
  bytes (the all-gather's payload is the leaf's element count, besides one
  f32 scalar for the shared max);
- a leaf cut over ``data`` on a 2 x 2 ``("pod", "data")`` mesh: its scale is
  the whole leaf's (the max runs over the pod and the data ranks), so the
  gathered mean equals the reference's over whole leaves;
- the train step with ``compress_pod=True`` on a ``(pod, data, model) =
  (2, 1, 1)`` mesh against the reference's own ``make_train_step(...,
  compress_pod=True, mesh=...)``, run in a subprocess on two forced CPU
  devices: loss and ``grad_norm`` within 1e-5 at both steps, parameters
  after both steps by the rule of :func:`test_compress_pod_step_equals_the_reference`.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.training.compress import compressed_mean as j_compressed_mean
from repro.training.compress import compressed_tree_mean as j_compressed_tree_mean

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
LEAVES = {"w": ((6, 5), "float32"), "stack": ((3, 4, 2), "float32"), "b": ((7,), "float32"),
          "zero": ((5,), "float32"), "h": ((9, 4), "bfloat16")}


def _leaves(seed):
    """Per-pod leaves [4, *shape] and error-feedback residuals, as numpy
    (bf16 leaves as f32 values that bf16 holds exactly)."""
    rng = np.random.default_rng(seed)
    g, e = {}, {}
    for k, (shape, dt) in LEAVES.items():
        x = rng.standard_normal((4, *shape)).astype(np.float32) * (0 if k == "zero" else 1)
        if dt == "bfloat16":
            x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        g[k] = x
        e[k] = (rng.standard_normal((4, *shape)) * 1e-3).astype(np.float32)
    return g, e


RANKS = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch

    import repro_torch.configs as TC
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.launch import dist as D
    from repro_torch.launch.cells import prepare_arch
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.sharding import gather_whole
    from repro_torch.models import bridge
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.compress import compressed_mean, compressed_tree_mean
    from repro_torch.training.optimizer import init_moments
    from repro_torch.training.step import TrainState, shard_state

    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def body(rank, tmp):
        torch.set_num_threads(1)
        plan = json.load(open(f"{tmp}/plan.json"))
        pods = make_device_mesh((4,), ("pod",))
        cut = make_device_mesh((2, 2), ("pod", "data"))
        step_mesh = make_device_mesh((2, 1, 1), ("pod", "data", "model"))
        g = dict(np.load(f"{tmp}/g.npz"))
        e = dict(np.load(f"{tmp}/e.npz"))
        dts = {k: DT[v[1]] for k, v in plan["leaves"].items()}
        mine = {k: torch.from_numpy(g[k][rank]).to(dts[k]) for k in dts}
        err = {k: torch.from_numpy(e[k][rank]) for k in e}
        out, wire = {}, {}
        for k in mine:
            for fb in (False, True):
                before = pods.wire_bytes
                m, ne = compressed_mean(mine[k], pods, "pod", err[k] if fb else None)
                wire.setdefault(k, pods.wire_bytes - before)
                out[f"one/{fb}/{k}"] = m.float().numpy()
                if fb:
                    out[f"one_err/{k}"] = ne.numpy()
        m, ne = compressed_tree_mean(mine, pods, "pod")
        assert ne is None
        out.update({f"tree/False/{k}": v.float().numpy() for k, v in m.items()})
        m, ne = compressed_tree_mean(mine, pods, "pod", errs=err)
        out.update({f"tree/True/{k}": v.float().numpy() for k, v in m.items()})
        out.update({f"tree_err/{k}": v.numpy() for k, v in ne.items()})
        # a leaf cut over data: pod p's whole leaf is g["w8"][p], rank (p, d)
        # holds rows d*4 .. d*4 + 4
        p, d = cut.index("pod"), cut.index("data")
        whole = torch.from_numpy(g["w8"][p])
        m, _ = compressed_mean(whole[4 * d:4 * d + 4], cut, "pod", pspec=("data", None))
        out["cut"] = gather_whole(m, cut, ("data", None)).numpy()
        if step_mesh.coords is not None:
            cfg = prepare_arch(TC.reduce_config(TC.get_config("olmo-1b")), step_mesh)
            opt = AdamWConfig(**plan["opt"])
            params = bridge.params_from_numpy(cfg, dict(np.load(f"{tmp}/w.npz")), "cpu")
            mu, nu = init_moments(params, opt)
            state = shard_state(cfg, opt, TrainState(torch.zeros((), dtype=torch.int32),
                                                     params, mu, nu), step_mesh)
            step = make_train_step(cfg, opt, mesh=step_mesh, compress_pod=True)
            metrics = []
            for i in range(2):
                state, mt = step(state, dict(np.load(f"{tmp}/b{i}.npz")))
                metrics.append({k: float(mt[k]) for k in ("loss", "grad_norm")})
            out.update({"p2/" + k: v for k, v in flatten(state.params).items()})
        else:
            metrics = None
        np.savez(f"{tmp}/rank{rank}.npz", **out)
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(dict(wire=wire, metrics=metrics), f)

    if __name__ == "__main__":
        D.spawn(body, 4, "gloo", args=(sys.argv[1],))
""")

REFERENCE_STEP = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.checkpoint.manager import _flatten
    from repro.configs import get_config, reduce_config
    from repro.launch.cells import prepare_arch
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.training.optimizer import AdamWConfig
    from repro.training.step import init_state, make_train_step

    tmp = sys.argv[1]
    plan = json.load(open(f"{tmp}/plan.json"))
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
    cfg = prepare_arch(reduce_config(get_config("olmo-1b")), mesh)
    opt = AdamWConfig(**plan["opt"])
    state = init_state(cfg, opt, jax.random.PRNGKey(7))
    np.savez(f"{tmp}/w.npz", **_flatten(state.params))
    open(f"{tmp}/w.ready", "w").close()
    step = jax.jit(make_train_step(cfg, opt, compress_pod=True, mesh=mesh))
    grad = jax.jit(jax.grad(lambda p, b: M.loss_fn(cfg, p, b)[0]))
    out, metrics = {"p0/" + k: v for k, v in _flatten(state.params).items()}, []
    for i in range(2):
        b = {k: jnp.asarray(v) for k, v in np.load(f"{tmp}/b{i}.npz").items()}
        out.update({f"g{i}/" + k: v for k, v in _flatten(grad(state.params, b)).items()})
        state, m = step(state, b)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        out.update({f"p{i + 1}/" + k: v for k, v in _flatten(state.params).items()})
    np.savez(f"{tmp}/ref_step.npz", **out)
    json.dump(metrics, open(f"{tmp}/ref_step.json", "w"))
""")


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """(each rank's results, its JSON, the reference step's arrays and
    metrics, the per-pod leaves and residuals)."""
    import repro_torch.configs as TC
    from repro_torch.data.pipeline import SyntheticLM
    tmp = tmp_path_factory.mktemp("compress")
    g, e = _leaves(3)
    g["w8"] = np.random.default_rng(4).standard_normal((2, 8, 6)).astype(np.float32)
    np.savez(tmp / "g.npz", **g)
    np.savez(tmp / "e.npz", **e)
    data = SyntheticLM(TC.reduce_config(TC.get_config("olmo-1b")), batch=4, seq=16)
    for i in range(2):
        np.savez(tmp / f"b{i}.npz", **data.batch_at(i))
    (tmp / "plan.json").write_text(json.dumps(dict(opt=OPT, leaves=LEAVES)))
    (tmp / "ref.py").write_text(REFERENCE_STEP)
    (tmp / "ranks.py").write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(tmp / "ref.py"), str(tmp)], env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    import time
    t0 = time.time()
    while not (tmp / "w.ready").exists():  # the ranks load the reference's weights
        assert ref.poll() is None, ref.communicate()[0][-4000:]
        assert time.time() - t0 < 300
        time.sleep(0.2)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ranks = subprocess.run([sys.executable, str(tmp / "ranks.py"), str(tmp)], env=env,
                           text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           timeout=600)
    assert ranks.returncode == 0, ranks.stdout[-4000:]
    out, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, out[-4000:]
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    meta = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(4)]
    return (got, meta, dict(np.load(tmp / "ref_step.npz")),
            json.loads((tmp / "ref_step.json").read_text()), g, e)


def _j(x, k):
    return jnp.asarray(x, jnp.bfloat16 if LEAVES[k][1] == "bfloat16" else jnp.float32)


def _close(got, want, k):
    want = np.asarray(want, np.float32)
    if LEAVES[k][1] == "bfloat16":  # one bf16 rounding of the same f32 value
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)), k
    else:
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("k", list(LEAVES))
def test_compressed_mean_equals_the_reference(compressed, k, feedback):
    got, _, _, _, g, e = compressed
    if feedback:
        mean, err = jax.vmap(lambda a, b: j_compressed_mean(a, "pod", b),
                             axis_name="pod")(_j(g[k], k), jnp.asarray(e[k]))
    else:
        mean, err = jax.vmap(lambda a: j_compressed_mean(a, "pod"),
                             axis_name="pod")(_j(g[k], k))
    for r in range(4):
        _close(got[r][f"one/{feedback}/{k}"], mean[r], k)
        if feedback:
            assert np.array_equal(got[r][f"one_err/{k}"], np.asarray(err[r])), k


@pytest.mark.parametrize("feedback", [False, True])
def test_compressed_tree_mean_equals_the_reference(compressed, feedback):
    got, _, _, _, g, e = compressed
    tree = {k: _j(v, k) for k, v in g.items() if k in LEAVES}
    errs = {k: jnp.asarray(v) for k, v in e.items()}
    if feedback:
        mean, err = jax.vmap(lambda t, s: j_compressed_tree_mean(t, "pod", s),
                             axis_name="pod")(tree, errs)
    else:
        mean, err = jax.vmap(lambda t: j_compressed_tree_mean(t, "pod"),
                             axis_name="pod")(tree)
        assert err is None
    for r in range(4):
        for k in LEAVES:
            _close(got[r][f"tree/{feedback}/{k}"], mean[k][r], k)
            if feedback:
                assert np.array_equal(got[r][f"tree_err/{k}"], np.asarray(err[k][r])), k


def test_the_int8_wire_carries_a_quarter_of_f32s_bytes(compressed):
    """One all-gather of the leaf's int8 values (its element count in
    bytes, a quarter of the f32 leaf) and one f32 scalar max a leaf."""
    _, meta, _, _, _, _ = compressed
    for k, (shape, _) in LEAVES.items():
        n = int(np.prod(shape))
        assert meta[0]["wire"][k] == n + 4
        assert 4 * (meta[0]["wire"][k] - 4) == n * np.dtype(np.float32).itemsize


def test_a_cut_leaf_takes_the_whole_leafs_scale(compressed):
    """Rows split over ``data``: the max runs over pod and data, so each
    rank's shard is quantized with the scale of the whole leaf."""
    got, _, _, _, g, _ = compressed
    want = jax.vmap(lambda a: j_compressed_mean(a, "pod")[0], axis_name="pod")(
        jnp.asarray(g["w8"]))
    for r in range(4):
        assert np.array_equal(got[r]["cut"], np.asarray(want[r // 2]))


def test_compress_pod_step_equals_the_reference(compressed):
    """Loss and ``grad_norm`` within 1e-5 of the reference's compressed step
    at both steps, and the same on both ranks.  Parameters after two steps
    by the mesh tests' rule (``tests/test_torch_mesh_train.py``'s
    ``_params_rule``): each entry within 1e-5 of the leaf's largest plus
    ``4 * max(lr, u) * min(1, 1e-5 * gmax / gmin)``; besides, an entry whose
    int8 value flipped between the two packages (a per-pod gradient on a
    rounding boundary moves the mean by a quantum) may move by up to ``4 *
    max(lr, u)``, on at most one entry in a thousand."""
    got, meta, ref, ref_m, _, _ = compressed
    for i in range(2):
        for k in ("loss", "grad_norm"):
            assert abs(meta[0]["metrics"][i][k] - ref_m[i][k]) <= 1e-5 * abs(ref_m[i][k])
    assert meta[1]["metrics"] == meta[0]["metrics"]
    assert meta[2]["metrics"] is None and meta[3]["metrics"] is None
    lr, flips, total = OPT["lr"], 0, 0
    for key in (k[3:] for k in ref if k.startswith("p2/")):
        ps = [np.asarray(ref[f"p{t}/{key}"], np.float64) for t in range(3)]
        gs = [np.abs(np.asarray(ref[f"g{t}/{key}"], np.float64)) for t in range(2)]
        gmax = max(float(np.max(x)) for x in gs)
        u = np.maximum(lr, np.maximum(np.abs(ps[1] - ps[0]), np.abs(ps[2] - ps[1])))
        allow = 4 * u * np.minimum(1.0, 1e-5 * gmax / np.maximum(np.minimum(*gs), 1e-30))
        err = np.abs(got[0]["p2/" + key] - ps[2])
        tight = 1e-5 * max(float(np.max(np.abs(ps[2]))), 1e-30)
        over = err > tight + allow
        assert np.all(err[over] <= 4 * u[over]), key
        flips, total = flips + int(np.sum(over)), total + err.size
        assert np.array_equal(got[1]["p2/" + key], got[0]["p2/" + key])
    assert flips <= max(1, total // 1000)


def test_tree_mean_meets_each_spec_by_key():
    """``compressed_tree_mean`` hands each leaf its own spec (the scale's
    max runs over the spec's axes too), whatever order the trees hold
    their keys in.  The fake one-rank mesh records each max's axes."""
    import types
    import torch
    from repro_torch.training.compress import compressed_tree_mean
    seen = {}
    mesh = types.SimpleNamespace(
        size=lambda a: 1, all_gather=lambda x, axis, dim: x,
        all_max=lambda x, axes: seen.setdefault(len(seen), axes) and x)
    grads = {"b": torch.ones(2), "a": torch.ones(3)}
    compressed_tree_mean(grads, mesh, "pod", pspecs={"a": (None,), "b": ("model",)})
    assert seen == {0: ("pod", "model"), 1: ("pod",)}
