"""The port's training step against the JAX package on the same numbers.

- ``ops.cgra_matmul``'s autograd (the block GEMM as a registered
  operator with its backward, plain / ``trans_b`` / f32 out) against
  PyTorch's autograd of a plain ``torch.matmul`` and against ``jax.grad`` of
  the reference's ``cgra_matmul`` (its custom VJP), tolerance 1e-5 (f32:
  the same products summed in other orders).
- For each reduced model family, on the same f32 weights (drawn with numpy
  from the reference's own param specs and init rules, fed to both
  packages; every zero-init leaf -- norm and MLP biases, the VLM's gates --
  drawn as 0.1 x N(0, 1) so that no sub-block is hidden behind a zero) and
  the same ``SyntheticLM`` batches:
  - ``loss``, ``ce`` and ``aux`` of step 1 within 1e-5 (f32, a few layers;
    observed gaps ~1e-6);
  - every gradient leaf within 1e-4 x that leaf's max |g|.  JAX's step-1
    gradient is read from its first moment: with ``clip_norm`` 1e9 nothing
    is clipped and ``mu_1 = (1 - b1) g``, so ``g = mu_1 / (1 - b1)`` to one
    f32 rounding (the reference's step, jitted once, gives every number
    this test compares);
  - after two AdamW steps (``warmup_steps=0``) ``mu`` and ``nu`` within
    1e-4 x the leaf's max, and the loss at step 2 within 1e-5;
  - the parameters after two steps within 1e-6, but only where both steps'
    gradients are not tiny (|g| >= 1e-2 x the leaf's max in each step).
    AdamW's first step is about ``lr * sign(g)``, so a near-zero gradient
    whose sign differs between the frameworks (a rounding) moves a weight
    by 2 lr; away from zero the update is a well-conditioned function of
    g, and the frameworks agree to ~1e-9.
- ``accum_steps=2`` against the reference's ``accum_steps=2``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels.ops import cgra_matmul as j_cgra_matmul
from repro.models import model as JM
from repro.models.params import is_spec as j_is_spec
from repro.training import AdamWConfig as JAdamW
from repro.training import TrainState as JTrainState
from repro.training import make_train_step as j_make_train_step
from repro.training.optimizer import init_moments as j_init_moments
import repro_torch.configs as TC
from repro_torch.checkpoint.manager import flatten
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.kernels.ops import cgra_matmul
from repro_torch.models import bridge
from repro_torch.training import AdamWConfig, make_train_step
from repro_torch.training.step import value_and_grad

FAMILIES = ["olmo-1b", "gemma3-4b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
            "minicpm3-4b", "mamba2-130m", "jamba-v0.1-52b", "llama-3.2-vision-11b",
            "hubert-xlarge"]
LOSS_ATOL, GRAD_RTOL, MOMENT_RTOL, PARAM_ATOL, TINY = 1e-5, 1e-4, 1e-4, 1e-6, 1e-2
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=1e9)
BATCH, SEQ = 2, 16


def _numpy_params(jcfg, seed: int, main_repeats=None):
    """The reference's param tree (``param_specs(jcfg, main_repeats)``)
    with numpy values from its init rules (scaled: N(0, 1/fan_in), normal:
    N(0, 0.02^2), ssm_a: log U[1, 16], dt_bias: inverse softplus of U[1e-3,
    1e-1], ones), zero-init leaves as 0.1 x N(0, 1); f32 (a reduced
    config's dtype), the router f32 too."""
    rng = np.random.default_rng(seed)

    def draw(s):
        shape = tuple(s.shape)
        if s.init == "ones":
            return np.ones(shape, np.float32)
        if s.init == "zeros":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if s.init == "ssm_a":
            return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
        if s.init == "dt_bias":
            return np.log(np.expm1(rng.uniform(1e-3, 1e-1, shape))).astype(np.float32)
        std = 0.02 if s.init == "normal" else 1.0 / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree.map(lambda s: jnp.asarray(draw(s)), JM.param_specs(jcfg, main_repeats),
                        is_leaf=j_is_spec)


def _setup(name, opt_kw=OPT, seed=0, **over):
    """Both packages' reduced ``name`` (with the fields of ``over``), the
    reference's state from ``seed`` and the port's bridged copy."""
    jcfg = JC.reduce_config(JC.get_config(name)).with_(**over)
    tcfg = TC.reduce_config(TC.get_config(name)).with_(**over)
    jopt, topt = JAdamW(**opt_kw), AdamWConfig(**opt_kw)
    params = _numpy_params(jcfg, seed)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, *j_init_moments(params, jopt))
    tstate = bridge.state_from_numpy(tcfg, topt, _flatten(jstate), device="cpu")
    return jcfg, tcfg, jopt, topt, jstate, tstate


def _leaf_rel(name, got: dict, want: dict, rtol):
    """Every leaf of ``got`` within ``rtol`` x the max |.| of ``want``'s."""
    assert got.keys() == want.keys()
    worst = 0.0
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = np.asarray(got[k], np.float32)
        assert g.shape == w.shape, (name, k)
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        err = float(np.max(np.abs(g - w))) if w.size else 0.0
        assert err <= rtol * max(scale, 1e-30), (name, k, err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    print(f"{name}: worst leaf gap {worst:.3e} of the leaf's max (bound {rtol})")


def _np(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in flatten(tree).items()}


# ---------------------------------------------------------------------------
# the block GEMM's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "trans_b", "f32_out"])
def test_cgra_matmul_backward_matches_autograd_and_jax(case):
    """a [M, K] @ b ([K, N], or [N, K] read transposed); g a random
    cotangent.  ga and gb from the Function equal torch autograd of a plain
    ``torch.matmul`` and ``jax.grad`` of the reference's ``cgra_matmul``
    (for ``trans_b`` the reference differentiates ``b.T``; its gradient is
    the transpose of the port's [N, K] one) within 1e-5."""
    rng = np.random.default_rng(7)
    M, K, N = 13, 24, 20
    tb = case == "trans_b"
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((N, K) if tb else (K, N)) / np.sqrt(K)).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    out_dtype = torch.float32 if case == "f32_out" else None

    ta = torch.from_numpy(a).requires_grad_()
    tbw = torch.from_numpy(b).requires_grad_()
    out = cgra_matmul(ta, tbw, out_dtype=out_dtype, trans_b=tb)
    assert out.grad_fn is not None
    ga, gb = torch.autograd.grad(out, (ta, tbw), torch.from_numpy(g))

    pa = torch.from_numpy(a).requires_grad_()
    pb = torch.from_numpy(b).requires_grad_()
    want_ga, want_gb = torch.autograd.grad(pa @ (pb.T if tb else pb), (pa, pb),
                                           torch.from_numpy(g))
    np.testing.assert_allclose(ga.numpy(), want_ga.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), want_gb.numpy(), atol=1e-5, rtol=0)

    jdt = jnp.float32 if out_dtype is not None else None

    def f(x, w):
        return jnp.sum(j_cgra_matmul(x, w.T if tb else w, "reference", jdt) * g)
    jga, jgb = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), atol=1e-5, rtol=0)


def test_cgra_matmul_without_grad_is_the_plain_call():
    """No input requires grad: no graph is recorded (serving takes the
    kernel straight)."""
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    out = cgra_matmul(a, b)
    assert out.grad_fn is None and not out.requires_grad
    with torch.no_grad():
        assert cgra_matmul(a.requires_grad_(), b).grad_fn is None


# ---------------------------------------------------------------------------
# one reduced model a family: loss, gradients, two AdamW steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name):
    jcfg, tcfg, jopt, topt, jstate, tstate = _setup(name)
    data = JSyntheticLM(jcfg, batch=BATCH, seq=SEQ, seed=3)
    b0, b1 = data.batch_at(0), data.batch_at(1)
    assert (("images" in b0) == bool(jcfg.vision_tokens)
            and ("frames" in b0) == bool(jcfg.audio_frontend))
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    js1, jm1 = jstep(jstate, {k: jnp.asarray(v) for k, v in b0.items()})
    js2, jm2 = jstep(js1, {k: jnp.asarray(v) for k, v in b1.items()})

    loss, extras, grads = value_and_grad(tcfg, tstate.params, to_device(b0, "cpu"))
    for key, got in (("loss", loss), ("ce", extras["ce"]), ("aux", extras["aux"])):
        gap = abs(float(got) - float(jm1[key]))
        print(f"{name} step 1 {key}: {float(got):.6f} vs {float(jm1[key]):.6f}")
        assert gap <= LOSS_ATOL, (name, key, gap)
    if jcfg.num_experts:
        assert float(extras["aux"]) > 0
    jgrads = {k: v / np.float32(1 - jopt.b1) for k, v in _np(js1.mu).items()}
    _leaf_rel(f"{name} gradients", _np(grads), jgrads, GRAD_RTOL)

    tstep = make_train_step(tcfg, topt)
    ts1, tm1 = tstep(tstate, b0)
    ts2, tm2 = tstep(ts1, b1)
    assert int(ts2.step) == 2
    gap = abs(float(tm2["loss"]) - float(jm2["loss"]))
    print(f"{name} step 2 loss: {float(tm2['loss']):.6f} vs {float(jm2['loss']):.6f}")
    assert gap <= LOSS_ATOL, (name, gap)
    jf, tf = _np(js2), _np(ts2)
    for m in (".mu/", ".nu/"):
        _leaf_rel(f"{name} {m[1:3]} after 2 steps", {k: v for k, v in tf.items()
                                                     if k.startswith(m)},
                  {k: v for k, v in jf.items() if k.startswith(m)}, MOMENT_RTOL)

    g2 = _np(value_and_grad(tcfg, ts1.params, to_device(b1, "cpu"))[2])
    g1 = _np(grads)
    checked = 0
    for k, g in g1.items():
        big = np.abs(g) >= TINY * max(float(np.abs(g).max()), 1e-30)
        big &= np.abs(g2[k]) >= TINY * max(float(np.abs(g2[k]).max()), 1e-30)
        got, want = tf[".params/" + k], jf[".params/" + k]
        err = float(np.max(np.abs(got - want)[big])) if big.any() else 0.0
        assert err <= PARAM_ATOL, (name, k, err)
        checked += int(big.sum())
    print(f"{name}: {checked} parameters compared after 2 steps")
    assert checked > 0


def test_accumulation_matches_jax():
    """``accum_steps=2`` over a batch of 4 (two microbatches of 2, summed
    into f32 zeros and halved): loss, moments and parameters after one step
    as the reference's ``accum_steps=2``."""
    jcfg, tcfg, jopt, topt, jstate, tstate = _setup("olmo-1b")
    batch = JSyntheticLM(jcfg, batch=4, seq=SEQ, seed=5).batch_at(0)
    js1, jm1 = jax.jit(j_make_train_step(jcfg, jopt, accum_steps=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ts1, tm1 = make_train_step(tcfg, topt, accum_steps=2)(tstate, batch)
    assert abs(float(tm1["loss"]) - float(jm1["loss"])) <= LOSS_ATOL
    assert abs(float(tm1["ce"]) - float(jm1["ce"])) <= LOSS_ATOL
    jf, tf = _np(js1), _np(ts1)
    for m in (".mu/", ".nu/"):
        _leaf_rel(f"accum {m[1:3]}", {k: v for k, v in tf.items() if k.startswith(m)},
                  {k: v for k, v in jf.items() if k.startswith(m)}, MOMENT_RTOL)
    # one step from zero moments: the update is lr * sign-like(g) + decay;
    # compare where the accumulated gradient is not tiny (see the module note)
    g = {k[4:]: v / np.float32(1 - jopt.b1) for k, v in jf.items() if k.startswith(".mu/")}
    for k, gk in g.items():
        big = np.abs(gk) >= TINY * max(float(np.abs(gk).max()), 1e-30)
        got, want = tf[".params/" + k], jf[".params/" + k]
        assert float(np.max(np.abs(got - want)[big], initial=0.0)) <= PARAM_ATOL, k


def test_full_batch_equals_accumulated_in_the_port():
    """The port's own accumulation against its full-batch step (the
    reference's ``test_grad_accumulation_matches_full_batch``): loss within
    1e-4 relative, parameters within 2e-5 (clip and decay off)."""
    kw = dict(OPT, weight_decay=0.0)
    jcfg, tcfg, _, topt, _, tstate = _setup("olmo-1b", kw)
    batch = SyntheticLM(tcfg, batch=4, seq=SEQ).batch_at(0)
    s_full, m_full = make_train_step(tcfg, topt)(tstate, batch)
    s_acc, m_acc = make_train_step(tcfg, topt, accum_steps=2)(tstate, batch)
    np.testing.assert_allclose(float(m_full["loss"]), float(m_acc["loss"]), rtol=1e-4)
    fa, fb = _np(s_full.params), _np(s_acc.params)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], atol=2e-5, rtol=0, err_msg=k)
