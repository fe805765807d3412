"""Training over a mesh for the families beyond the attention decoders: MLA,
head-parallel Mamba-2 SSD, the jamba hybrid, cross-attention and the audio
encoder, in the port against ``jax.grad`` of the JAX package on one device.

Four gloo ranks on the CPU, spawned once for the module by
``test_torch_mesh_train.train_on_ranks``, train each scenario's reduced
config from the JAX package's weights (``bridge.params_from_numpy``), f32,
2 steps on ``SyntheticLM`` batches of 4 x 16 (``images`` and ``frames``
split over the batch ranks by ``local_batch``).  The zero-initialised
leaves are opened in the weights both packages get (cross gates 0.5,
``b1`` / ``b2`` / LayerNorm ``bias`` 0.1 x N(0, 1)): a closed gate zeroes
every cross weight's gradient and a zero bias hides one added on each rank.
Each scenario is held as the attention decoders are: every leaf's gradient
within 1e-5 of its max of JAX's, loss and ``grad_norm`` within 1e-5 and
equal on every rank, parameters after both steps by ``_params_rule``.

``jamba/1x2``'s gradient is held, at the same bound, against the loss's
gradient evaluated in float64 (:func:`_exact_grads`), and that evaluation
against JAX's.  JAX's own f32 gradient of its last SSD layer's ``A_log``
(a sum over every position of terms far larger than itself) sits 9.99e-6
of the leaf's max from the f64 one, at the bound, so the mesh's rounding,
which sits 6.45e-6 from it, added to the reference's reaches 1.16e-5.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.checkpoint.manager import flatten
from repro_torch.core.tree import tree_map
from repro_torch.launch.cells import prepare_arch
from repro_torch.models import bridge
from repro_torch.training.step import value_and_grad
from test_torch_mesh_train import (ARCHS, GRAD_RTOL, OVERRIDES, SRC, _out, _params_rule,
                                   check_gradients, check_loss_and_grad_norm, train_on_ranks)

# name: (arch, data, model, parallel_mode, fsdp, moments, accum, remat_policy)
SCENARIOS = {
    # MLA: the shared rope key entered before its expand over this rank's heads
    "mla/1x2": ("mla", 1, 2, "2d", True, "f32", 1, "none"),
    "mla/2x2": ("mla", 2, 2, "2d", True, "f32", 1, "none"),
    # head-parallel SSD: the per-head projections' input, B and C past the
    # conv, and the gated norm's joined sum entered
    "ssd/1x2": ("ssd", 1, 2, "2d", True, "f32", 1, "none"),
    "ssd/2x2": ("ssd", 2, 2, "2d", True, "f32", 1, "none"),
    # SSD, attention and expert-parallel MoE in one stage
    "jamba/1x2": ("jamba", 1, 2, "2d", True, "f32", 1, "none"),
    # cross-attention with its gates opened; at 1x4 the 2 KV heads do not
    # split over 4 ranks (local_kv under autograd)
    "vlm/1x2": ("vlm", 1, 2, "2d", True, "f32", 1, "none"),
    "vlm/1x4": ("vlm", 1, 4, "2d", True, "f32", 1, "none"),
    # FSDP gathers over the mixed stage (self layers and the cross layer)
    "vlm/2x2": ("vlm", 2, 2, "2d", True, "f32", 1, "none"),
    # qk-norm scales entered on this rank's heads, the cross sub-block's too
    "vlmqk/1x2": ("vlmqk", 1, 2, "2d", True, "f32", 1, "none"),
    # the bidirectional encoder with its biases opened
    "enc/1x2": ("enc", 1, 2, "2d", True, "f32", 1, "none"),
    "enc/2x2/fsdp": ("enc", 2, 2, "fsdp", True, "f32", 1, "none"),
}


# held against the loss's gradient evaluated in float64 (see the docstring)
EXACT = ("jamba/1x2",)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_on_ranks(tmp_path_factory.mktemp("mesh_train_families"), SCENARIOS,
                          extras=False)


def _exact_grads(tmp, name):
    """The scenario's gradient of its first batch's loss evaluated in
    float64: the port's model code on one device, with every module's f32
    upcast (``F32``) made float64, at the weights the ranks load."""
    arch, d, m, mode, fsdp, *_ = SCENARIOS[name]
    cfg = TC.reduce_config(TC.get_config(ARCHS[arch])).with_(
        fsdp=fsdp, parallel_mode=mode, **OVERRIDES.get(arch, {}))
    cfg = prepare_arch(cfg, types.SimpleNamespace(shape={"data": d, "model": m}))
    weights = dict(np.load(tmp / f"{name.replace('/', '_')}.npz"))
    params = tree_map(lambda x: x.double(), bridge.params_from_numpy(cfg, weights, "cpu"))
    batch = {k: torch.as_tensor(v.astype(np.float64) if v.dtype.kind == "f" else v)
             for k, v in np.load(tmp / f"{arch}_b0.npz").items()}
    with pytest.MonkeyPatch.context() as mp:
        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("repro_torch.")
                    and getattr(mod, "F32", None) is torch.float32):
                mp.setattr(mod, "F32", torch.float64)
        grads = value_and_grad(cfg.with_(compute_dtype=torch.float64), params, batch)[2]
    return flatten(grads)


@pytest.fixture(scope="module")
def exact(trained):
    return {name: _exact_grads(trained[2], name) for name in EXACT}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_gradients_equal_jax_grad(trained, exact, name):
    """Every leaf's gathered gradient within 1e-5 of the leaf's largest
    entry of JAX's gradient of the global batch's loss (of its f64
    evaluation for the scenarios of ``EXACT``): MLA's shared rope key, SSD's
    per-head inputs, B / C and gated norm, the cross sub-block's image
    entered once and its qk-norm scales, ``local_kv`` under autograd, the
    GELU MLP's biases and the encoder's bidirectional attention."""
    check_gradients(trained, name, exact.get(name))


@pytest.mark.parametrize("name", EXACT)
def test_exact_gradient_equals_jax_grad(trained, exact, name):
    """The f64 evaluation a scenario is held against is the reference's
    function: each of its leaves within 1e-5 of the leaf's largest entry of
    JAX's f32 gradient, and no leaf left out."""
    _, want, _ = trained
    ref = want[name]["g"][0]
    assert set(exact[name]) == set(ref)
    for key, w in ref.items():
        w = np.asarray(w, np.float64)
        e = exact[name][key].reshape(w.shape)
        assert np.max(np.abs(e - w)) <= GRAD_RTOL * max(np.max(np.abs(w)), 1e-30), (name, key)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_loss_and_grad_norm_equal_the_jax_step(trained, name):
    check_loss_and_grad_norm(trained, name, SCENARIOS)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_parameters_after_two_steps(trained, name):
    _, want, tmp = trained
    _params_rule(name, _out(tmp, name), want[name])


def test_launcher_trains_ssd_on_a_mesh(tmp_path):
    """Reduced mamba2-130m through the launcher at ``--mesh 1x2 --backend
    gloo --device cpu``: head-parallel SSD training on two ranks, whose rank
    0 alone prints the reference's lines, with the 1x1 run's losses, learning
    rates and gradient norms."""
    base = ["-m", "repro_torch.launch.train", "--arch", "mamba2-130m", "--reduced", "--steps",
            "4", "--batch", "4", "--seq", "16", "--device", "cpu", "--log-every", "2"]
    env = dict(os.environ, PYTHONPATH=SRC)
    outs = {}
    for mesh in ("1x1", "1x2"):
        extra = ["--mesh", mesh] + (["--backend", "gloo"] if mesh != "1x1" else [])
        proc = subprocess.run([sys.executable, *base, *extra, "--ckpt-dir",
                               str(tmp_path / mesh)], env=env, text=True, capture_output=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs[mesh] = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    lines = outs["1x2"]
    assert lines[0].startswith("arch=mamba2-130m-smoke ")
    assert "mesh={'data': 1, 'model': 2}" in lines[0]
    assert sum(ln.startswith("arch=") for ln in lines) == 1
    assert sum(ln.startswith("done: 4 steps") for ln in lines) == 1
    # each step line up to its throughput: the loss, lr and the gradient's
    # global norm (summed over the head-parallel shards, whatever order the
    # state's keys come in) as the single device's
    steps = [ln.rsplit(" ", 2)[0] for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2
    assert steps == [ln.rsplit(" ", 2)[0] for ln in outs["1x1"] if ln.startswith("step ")]


def test_cross_attention_enters_the_image_once(monkeypatch):
    """At 1x2 the image feeds the column-split ``wk`` and ``wv``: it enters
    the tensor-parallel region once (one all-reduce of its gradient), and
    the qk-norm scales enter as ``_qkv``'s do.  A fake two-rank mesh (rank
    0's slices, no process group) records what ``enter_tp`` is handed."""
    import types

    import torch

    import repro_torch.configs as TC
    from repro_torch.launch.sharding import activation_mesh
    from repro_torch.models import layers as TL

    cfg = TC.reduce_config(TC.get_config("llama-3.2-vision-11b")).with_(use_qk_norm=True)
    H, K, dh, D = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    g = torch.Generator().manual_seed(0)
    p = {"wq": torch.randn(D, H // 2, dh, generator=g), "wk": torch.randn(D, K // 2, dh, generator=g),
         "wv": torch.randn(D, K // 2, dh, generator=g), "wo": torch.randn(H // 2, dh, D, generator=g),
         "q_norm": torch.ones(dh), "k_norm": torch.ones(dh), "gate": torch.tensor(0.5)}
    entered = []
    monkeypatch.setattr(TL, "enter_tp", lambda x, mesh, axis="model": entered.append(x) or x)
    monkeypatch.setattr(TL, "leave_tp", lambda x, mesh, axis="model": x)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2}, index=lambda a: 0,
                                 groups={"model": None})
    x, img = torch.randn(2, 3, D, generator=g), torch.randn(2, 5, D, generator=g)
    with activation_mesh(mesh):
        TL.cross_attn(cfg, p, x, img)
    assert sum(t is img for t in entered) == 1
    assert sum(t is x for t in entered) == 1
    assert sum(t is p["q_norm"] for t in entered) == 1 and sum(t is p["k_norm"] for t in entered) == 1


def test_remat_recompute_on_another_thread_keeps_the_mesh():
    """Under ``remat_policy="full"`` a layer group runs again inside the
    backward pass, which the autograd engine runs on a device thread of its
    own for a CUDA tensor: the recompute must see the mesh the forward ran
    under.  Reduced minicpm3-4b (MLA) at rank 0 of a fake 1x2 mesh (no
    process group; its collectives are the identity): the backward run on
    another thread gives the gradients of the backward run inside the
    mesh's context."""
    import threading
    import types

    import numpy as np
    import torch

    import repro_torch.configs as TC
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.launch.sharding import activation_mesh, profile_for
    from repro_torch.models import model as TM

    cfg = TC.reduce_config(TC.get_config("minicpm3-4b")).with_(remat_policy="full")
    shape = {"data": 1, "model": 2}
    mesh = types.SimpleNamespace(
        shape=shape, size=lambda a: shape.get(a, 1), index=lambda a: 0, groups={"model": None},
        all_reduce=lambda x, axis="model": x.clone(), all_max=lambda x, axes: x)
    params = TM.shard_params(cfg, TM.init(cfg, 0, "cpu"), mesh)
    batch = to_device(SyntheticLM(cfg, batch=2, seq=8).batch_at(0), torch.device("cpu"))

    def grads(on_thread: bool):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with activation_mesh(mesh, profile_for(cfg)), torch.enable_grad():
            loss, _ = TM.loss_fn(cfg, tree_unflatten(params, leaves), batch)
            if not on_thread:
                return torch.autograd.grad(loss, leaves, allow_unused=True)
        out = {}
        worker = threading.Thread(target=lambda: out.setdefault(
            "g", torch.autograd.grad(loss, leaves, allow_unused=True)))
        worker.start()
        worker.join()
        assert "g" in out, "the backward on another thread failed"
        return out["g"]

    for a, b in zip(grads(True), grads(False)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
