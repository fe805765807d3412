"""The reference's single-card training options in the port, against the
JAX package on the same numbers (f32, reduced configs, CPU):

- ``remat_policy`` (``none`` / ``dots_nb`` / ``dots`` / ``full``) for
  reduced olmo-1b, qwen3-moe-30b-a3b (its aux loss included),
  minicpm3-4b (MLA) and an 8-layer gemma3-4b (three stages): the loss
  and every gradient leaf equal the port's own ``none`` result within 1e-6 (relative to the loss, to the leaf's max |g|;
  recompute runs the same ops, so they are expected bit-equal), and JAX's
  ``loss_fn`` / ``jax.grad`` under the same policy within 1e-5 (loss) and
  1e-4 of each leaf's max (gradients), the rule of
  ``tests/test_torch_train_step.py``;
- the GEMM's calls in one step: 3 per forward GEMM under ``none``,
  ``dots_nb`` and ``dots`` (the saved outputs are not recomputed), one more
  per GEMM inside a layer group under ``full``; the head stays at 3;
- ``attn_chunk`` (query-chunked plain attention, a padded ragged tail)
  against JAX's ``loss_fn(attn_chunk=16)`` at S = 64 and at S = 40, in the
  gradient and in ``make_eval_step``;
- ``make_train_step(main_repeats=1)`` against the reference's on the same
  bridged state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import _flatten
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.training import TrainState as JTrainState
from repro.training import make_eval_step as j_make_eval_step
from repro.training import make_train_step as j_make_train_step
from repro.training.optimizer import init_moments as j_init_moments
import repro_torch.configs as TC
from repro_torch.data.pipeline import to_device
from repro_torch.kernels import block_gemm as BG
from repro_torch.models import bridge
from repro_torch.models import model as TM
from repro_torch.training import make_eval_step, make_train_step
from repro_torch.training.step import value_and_grad
from test_torch_train_step import (LOSS_ATOL, GRAD_RTOL, MOMENT_RTOL, OPT, _leaf_rel,
                                   _np, _numpy_params, _setup)

POLICIES = ("none", "dots_nb", "dots", "full")
SELF_RTOL = 1e-6


def _jax_value_and_grad(jcfg, params, batch, **kw):
    fn = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b, **kw), has_aux=True))
    (loss, extras), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, extras, {k: np.asarray(v, np.float32) for k, v in _flatten(grads).items()}


def _port(tcfg, params, batch, **kw):
    loss, extras, grads = value_and_grad(tcfg, params, to_device(batch, "cpu"), **kw)
    return loss, extras, _np(grads)


@pytest.fixture(scope="module")
def gemm_calls():
    """Counts every call of the block GEMM's plain version (the CPU's
    GEMM: forward, recompute and both backward products)."""
    calls = [0]
    orig = BG.block_gemm_ref

    def counting(*a, **k):
        calls[0] += 1
        return orig(*a, **k)
    BG.block_gemm_ref = counting
    yield calls
    BG.block_gemm_ref = orig


def _check_remat_policies(name, gemm_calls, **over):
    jcfg, tcfg, _, _, jstate, tstate = _setup(name, **over)
    batch = JSyntheticLM(jcfg, batch=2, seq=16, seed=3).batch_at(0)
    with torch.no_grad():
        gemm_calls[0] = 0
        TM.loss_fn(tcfg, tstate.params, to_device(batch, "cpu"))
        n_fwd = gemm_calls[0]
    n_head = 1
    out = {}
    for policy in POLICIES:
        gemm_calls[0] = 0
        out[policy] = _port(tcfg.with_(remat_policy=policy), tstate.params, batch)
        calls = gemm_calls[0]
        extra = (n_fwd - n_head) if policy == "full" else 0
        assert calls == 3 * n_fwd + extra, (policy, calls, n_fwd)
        loss, extras, grads = out[policy]
        ref = out["none"]
        assert abs(float(loss) - float(ref[0])) <= SELF_RTOL * abs(float(ref[0]))
        assert abs(float(extras["aux"]) - float(ref[1]["aux"])) <= SELF_RTOL * max(
            abs(float(ref[1]["aux"])), 1e-30)
        _leaf_rel(f"{name} {policy} vs the port's none", grads, ref[2], SELF_RTOL)
        jloss, jextras, jgrads = _jax_value_and_grad(
            jcfg.with_(remat_policy=policy), jstate.params, batch)
        assert abs(float(loss) - float(jloss)) <= LOSS_ATOL, (policy, float(loss), float(jloss))
        assert abs(float(extras["aux"]) - float(jextras["aux"])) <= LOSS_ATOL
        _leaf_rel(f"{name} {policy} vs JAX", grads, jgrads, GRAD_RTOL)
    if name == "qwen3-moe-30b-a3b":
        assert float(out["full"][1]["aux"]) > 0


@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_remat_policies_match_none_and_jax(name, gemm_calls):
    _check_remat_policies(name, gemm_calls)


def test_remat_policies_over_several_stages(gemm_calls):
    """Reduced gemma3-4b at 8 layers has three stages of different layer
    groups (5 local; global + local; local): each group's recompute must
    run its own stage's layers, under every policy."""
    assert len({len(s.group) for s in
                TC.reduce_config(TC.get_config("gemma3-4b")).with_(num_layers=8).stages()}) > 1
    _check_remat_policies("gemma3-4b", gemm_calls, num_layers=8)


def test_remat_policy_values():
    assert TC.get_config("olmo-1b").remat_policy == "full"
    assert TC.reduce_config(TC.get_config("olmo-1b")).remat_policy == "none"
    assert all(TC.get_config(n).remat_policy == JC.get_config(n).remat_policy
               for n in TC.REGISTRY)
    cfg = TC.reduce_config(TC.get_config("olmo-1b")).with_(remat_policy="some")
    params = TM.init(cfg, 0, "cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="remat_policy"):
        value_and_grad(cfg, params, batch)
    # without autograd no policy applies: the loss runs as it is
    with torch.no_grad():
        TM.loss_fn(cfg, params, batch)


@pytest.mark.parametrize("name", ["olmo-1b", "minicpm3-4b"])
@pytest.mark.parametrize("seq", [64, 40])
def test_attn_chunk_matches_jax(name, seq):
    """16-row query blocks over all keys (S = 40: a padded ragged tail)
    equal JAX's ``loss_fn(attn_chunk=16)`` and the port's unchunked
    result; ``make_eval_step(attn_chunk=16)`` equals JAX's."""
    jcfg, tcfg, _, _, jstate, tstate = _setup(name)
    batch = JSyntheticLM(jcfg, batch=2, seq=seq, seed=4).batch_at(0)
    loss, extras, grads = _port(tcfg, tstate.params, batch, attn_chunk=16)
    jloss, _, jgrads = _jax_value_and_grad(jcfg, jstate.params, batch, attn_chunk=16)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL, (float(loss), float(jloss))
    _leaf_rel(f"{name} S={seq} attn_chunk=16 vs JAX", grads, jgrads, GRAD_RTOL)
    whole = _port(tcfg, tstate.params, batch)
    assert abs(float(loss) - float(whole[0])) <= LOSS_ATOL
    _leaf_rel(f"{name} S={seq} attn_chunk=16 vs unchunked", grads, whole[2], GRAD_RTOL)
    got = make_eval_step(tcfg, attn_chunk=16)(tstate.params, batch)
    want = jax.jit(j_make_eval_step(jcfg, attn_chunk=16))(
        jstate.params, {k: jnp.asarray(v) for k, v in batch.items()})
    for k in ("loss", "ce"):
        assert abs(float(got[k]) - float(want[k])) <= LOSS_ATOL, (k, float(got[k]))


def test_main_repeats_train_step_matches_jax():
    """Reduced olmo-1b at ``main_repeats=1`` (one of its two layers): the
    reference's state at that depth, bridged, takes one step in both
    packages; the loss within 1e-5, the moments within 1e-4 of each
    leaf's max.  The port's ``init_state(main_repeats=1)`` and
    ``param_specs`` give the same tree shapes.  The bridge reads the
    reference's tree at that depth through a one-layer config, whose
    tree is the same (the shapes of ``init_state(main_repeats=1)`` are
    held against it)."""
    from repro.training import AdamWConfig as JAdamW
    from repro_torch.training import AdamWConfig, init_state
    jcfg = JC.reduce_config(JC.get_config("olmo-1b"))
    tcfg = TC.reduce_config(TC.get_config("olmo-1b"))
    jopt, topt = JAdamW(**OPT), AdamWConfig(**OPT)
    params = _numpy_params(jcfg, 0, main_repeats=1)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, *j_init_moments(params, jopt))
    tstate = bridge.state_from_numpy(tcfg.with_(num_layers=1), topt, _flatten(jstate),
                                     device="cpu")
    assert tstate.params["stages"][0]["0"]["mixer"]["wq"].shape[0] == 1
    own = init_state(tcfg, topt, device="cpu", main_repeats=1)
    assert ({k: v.shape for k, v in _np(own.params).items()}
            == {k: v.shape for k, v in _np(tstate.params).items()})
    batch = JSyntheticLM(jcfg, batch=2, seq=16, seed=6).batch_at(0)
    js1, jm1 = jax.jit(j_make_train_step(jcfg, jopt, main_repeats=1))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ts1, tm1 = make_train_step(tcfg, topt, main_repeats=1)(tstate, batch)
    assert abs(float(tm1["loss"]) - float(jm1["loss"])) <= LOSS_ATOL
    jf, tf = _np(js1), _np(ts1)
    for m in (".mu/", ".nu/"):
        _leaf_rel(f"main_repeats=1 {m[1:3]}", {k: v for k, v in tf.items() if k.startswith(m)},
                  {k: v for k, v in jf.items() if k.startswith(m)}, MOMENT_RTOL)
