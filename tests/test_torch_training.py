"""The port's optimizer, gradient compressor, data stream, train-step purity
and autograd guards, against the JAX package on the same numbers.

Tolerances: the schedule, the global norm and every AdamW output within 1e-6
relative (f32; the same elementwise formulas, the norms' sums in other
orders); int8 moments' ``q`` equal and their scales within 1e-7; bf16
moments equal to one bf16 rounding (2^-8 relative); data bit-equal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core.quant import compress_grad as j_compress
from repro.core.quant import decompress_grad as j_decompress
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.training import AdamWConfig as JAdamW
from repro.training import schedule as j_schedule
from repro.training.optimizer import adamw_update as j_adamw
from repro.training.optimizer import global_norm as j_global_norm
from repro.training.optimizer import init_moments as j_init_moments
import repro_torch.configs as TC
from repro_torch.checkpoint.manager import flatten
from repro_torch.core.quant import QTensor, compress_grad, decompress_grad
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import SyntheticLM, prefetching
from repro_torch.kernels import ops
from repro_torch.kernels.block_gemm import block_gemm, block_gemm_int8
from repro_torch.kernels.decode_attention import flash_decode, flash_decode_paged
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_paged
from repro_torch.kernels.quantize import quantize_rows
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as TL
from repro_torch.training import AdamWConfig, init_state, make_eval_step, make_train_step
from repro_torch.training.optimizer import adamw_update, global_norm, init_moments, schedule

RTOL = 1e-6


def _tree(seed):
    """A parameter-like tree: a matrix, a stacked 3-D leaf and a vector (no
    decay; one int8 scale an element)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": {"k": rng.standard_normal((2, 4, 3)).astype(np.float32)},
            "b": rng.standard_normal((7,)).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= rtol * scale


def test_schedule_matches_jax():
    """Warm-up, the cosine and its floor, at steps on both sides of each
    bend, as ints and as int32 tensors."""
    opt = dict(lr=0.7, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    for s in (0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 500):
        want = float(j_schedule(JAdamW(**opt), jnp.int32(s)))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = float(schedule(AdamWConfig(**opt), step))
            assert abs(got - want) <= RTOL * 0.7, (s, got, want)
    assert float(schedule(AdamWConfig(**opt), 0)) == 0.0


def test_global_norm_matches_jax():
    tree = _tree(1)
    _close(global_norm(_t(tree)), j_global_norm(_j(tree)))
    assert abs(float(global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}))
               - 5.0) < 1e-6


def test_global_norm_meets_each_spec_by_key():
    """Under a mesh each leaf's sum of squares joins the group of its own
    spec, whatever order the two trees hold their keys in (``model.init``
    sorts them, a spec tree keeps the specs' order): a model-sharded leaf
    is summed over the ranks, a replicated one counted once.  The fake
    mesh's all-reduce stands for two ranks holding equal shards."""
    grads = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    specs = {"b": ("model",), "a": (None,)}
    mesh = types.SimpleNamespace(all_reduce=lambda x, axis: 2 * x)
    got = float(global_norm(grads, mesh, specs))
    assert got == pytest.approx((3.0 ** 2 + 2 * 4.0 ** 2) ** 0.5, rel=1e-6)


@pytest.mark.parametrize("moments", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_update_matches_jax(moments, clip):
    """Three steps of ``adamw_update`` from zero moments on the same numpy
    trees and gradients (decay on, clipping off or biting): new parameters,
    both moments and the metrics as the reference's; int8 moments' ``q``
    equal and scales within 1e-7.  The inputs are left as they were."""
    opt = dict(lr=0.05, warmup_steps=2, total_steps=20, weight_decay=0.1,
               clip_norm=clip, moments_dtype=moments)
    jopt, topt = JAdamW(**opt), AdamWConfig(**opt)
    params = _tree(2)
    jp, tp = _j(params), _t(params)
    jm, jv = j_init_moments(jp, jopt)
    tm, tv = init_moments(tp, topt)
    for step in range(3):
        g = _tree(10 + step)
        before = {k: v.clone() for k, v in (("w", tp["w"]), ("b", tp["b"]))}
        jp, jm, jv, jmet = j_adamw(jopt, jp, _j(g), jm, jv, jnp.int32(step))
        tp2, tm, tv, tmet = adamw_update(topt, tp, _t(g), tm, tv,
                                         torch.tensor(step, dtype=torch.int32))
        assert torch.equal(tp["w"], before["w"]) and torch.equal(tp["b"], before["b"])
        tp = tp2
        _close(tmet["grad_norm"], jmet["grad_norm"])
        _close(tmet["lr"], jmet["lr"])
        for key, sub in (("w", None), ("b", None), ("stack", "k")):
            pick = (lambda t: t[key]) if sub is None else (lambda t: t[key][sub])
            _close(pick(tp), pick(jp))
            for got, want in ((pick(tm), pick(jm)), (pick(tv), pick(jv))):
                if moments == "int8":
                    assert isinstance(got, QTensor)
                    assert got.scale.shape == tuple(want.scale.shape)
                    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
                    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                               rtol=1e-7, atol=0)
                elif moments == "bf16":
                    assert got.dtype == torch.bfloat16
                    _close(got, np.asarray(want, np.float32), 2.0 ** -8)
                else:
                    _close(got, want)


def test_int8_moment_scales_follow_init_moments():
    """The scales the reference's running code makes (not its dry-run
    ``moment_shapes``): (1, N) for [M, N], (1, 1, N) for a 3-D leaf, one a
    element for a vector."""
    params = _tree(3)
    jm, _ = j_init_moments(_j(params), JAdamW(moments_dtype="int8"))
    tm, _ = init_moments(_t(params), AdamWConfig(moments_dtype="int8"))
    assert tuple(tm["w"].scale.shape) == tuple(jm["w"].scale.shape) == (1, 5)
    assert (tuple(tm["stack"]["k"].scale.shape) == tuple(jm["stack"]["k"].scale.shape)
            == (1, 1, 3))
    assert tuple(tm["b"].scale.shape) == tuple(jm["b"].scale.shape) == (7,)


def test_clipping_bounds_the_moment():
    """A huge gradient under a tiny ``clip_norm``: the reported norm is the
    raw one and the first moment stays small (the reference's
    ``test_grad_clipping_bounds_update``)."""
    opt = AdamWConfig(lr=1.0, warmup_steps=0, clip_norm=1e-3, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    mu, nu = init_moments(params, opt)
    _, mu2, _, m = adamw_update(opt, params, {"w": torch.full((4,), 1e6)}, mu, nu,
                                torch.tensor(0))
    assert float(m["grad_norm"]) > 1e5
    assert float(mu2["w"].abs().max()) < 1.0


def test_compress_grad_error_feedback_matches_jax():
    """Four rounds of int8 compression with the residual carried: q equal,
    scale and residual within 1e-6 relative; the decompressed sum of the
    rounds plus the last residual equals the sum of the inputs (error
    feedback loses nothing)."""
    rng = np.random.default_rng(4)
    err_j = jnp.zeros((5, 9), jnp.float32)
    err_t = torch.zeros(5, 9)
    total_in, total_out = np.zeros((5, 9)), np.zeros((5, 9))
    for _ in range(4):
        g = rng.standard_normal((5, 9)).astype(np.float32)
        jq, err_j = j_compress(jnp.asarray(g), err_j)
        tq, err_t = compress_grad(torch.from_numpy(g), err_t)
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        _close(tq.scale, jq.scale)
        _close(err_t, err_j)
        _close(decompress_grad(tq), j_decompress(jq))
        total_in += g
        total_out += decompress_grad(tq).double().numpy()
    np.testing.assert_allclose(total_out + err_t.double().numpy(), total_in, atol=1e-5)


@pytest.mark.parametrize("name", ["olmo-1b", "llama-3.2-vision-11b", "hubert-xlarge"])
def test_synthetic_batches_are_bit_equal_to_jax(name):
    """Tokens and labels, a VLM's images, an encoder's frames (and no
    tokens): bit-equal to the reference's stream at the same (seed, step)."""
    jcfg = JC.reduce_config(JC.get_config(name))
    tcfg = TC.reduce_config(TC.get_config(name))
    for step in (0, 7):
        want = JSyntheticLM(jcfg, batch=3, seq=40, seed=11).batch_at(step)
        got = SyntheticLM(tcfg, batch=3, seq=40, seed=11).batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert ("images" in got) == (name == "llama-3.2-vision-11b")
    assert ("frames" in got) == ("tokens" not in got) == (name == "hubert-xlarge")


def test_prefetching_yields_the_stream():
    cfg = TC.reduce_config(TC.get_config("olmo-1b"))
    data = SyntheticLM(cfg, batch=2, seq=8, seed=1)
    it = prefetching(data, 3, device="cpu")
    for s in (3, 4, 5):
        b = next(it)
        assert isinstance(b["tokens"], torch.Tensor)
        np.testing.assert_array_equal(b["tokens"].numpy(), data.batch_at(s)["tokens"])
    it.close()


def _leaves(state):
    out = [state.step]
    for tree in (state.params, state.mu, state.nu):
        for leaf in tree_leaves(tree):
            out += list(leaf) if isinstance(leaf, QTensor) else [leaf]
    return out


def test_train_step_leaves_its_input_state_unchanged():
    """The step is pure: every leaf of the state it is given (step, params,
    both moments) is bit-equal afterwards, and none requires grad."""
    cfg = TC.reduce_config(TC.get_config("qwen3-moe-30b-a3b"))
    opt = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10, moments_dtype="int8")
    state = init_state(cfg, opt, seed=1, device="cpu")
    before = flatten(state)
    step = make_train_step(cfg, opt)
    new, m = step(state, SyntheticLM(cfg, batch=2, seq=16).batch_at(0))
    after = flatten(state)
    assert before.keys() == after.keys()
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    assert int(new.step) == 1 and int(state.step) == 0
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    assert not any(t.requires_grad for t in _leaves(new))
    moved = flatten(new)
    assert any(not np.array_equal(moved[k], before[k]) for k in before
               if k.startswith(".params/"))


def test_eval_step_and_refusals():
    cfg = TC.reduce_config(TC.get_config("olmo-1b"))
    opt = AdamWConfig()
    state = init_state(cfg, opt, device="cpu")
    out = make_eval_step(cfg)(state.params, SyntheticLM(cfg, batch=2, seq=8).batch_at(0))
    assert set(out) == {"loss", "ce", "aux"} and out["loss"].grad_fn is None
    # an SSD model builds its step on a mesh too (no process group needed to build it)
    ssd = TC.reduce_config(TC.get_config("mamba2-130m"))
    shape = {"data": 2, "model": 1}
    mesh = types.SimpleNamespace(shape=shape, size=lambda a: shape.get(a, 1))
    assert callable(make_train_step(ssd, opt, mesh=mesh))
    make_train_step(cfg, opt, compress_pod=True)  # no pod axis: trains plainly, as JAX
    make_train_step(cfg, opt, attn_chunk=64, main_repeats=1)  # accepted


def _kernel_calls():
    """Each kernel wrapper but the GEMM's operator, with tiny CPU inputs;
    ``x`` is the input that may require grad."""
    f = torch.randn
    pages = torch.tensor([[0, 1]], dtype=torch.int32)
    pos = torch.tensor([3], dtype=torch.int32)
    return {
        "block_gemm": lambda x: block_gemm(x, f(4, 3)),
        "block_gemm_int8": lambda x: block_gemm_int8(
            torch.ones(2, 4, dtype=torch.int8), torch.ones(3, 4, dtype=torch.int8),
            x, torch.ones(1, 3)),
        "quantize_rows": lambda x: quantize_rows(x),
        "flash_attention": lambda x: flash_attention(x.reshape(1, 2, 1, 4), f(1, 1, 3, 4),
                                                     f(1, 1, 3, 4)),
        "flash_attention_paged": lambda x: flash_attention_paged(
            x.reshape(1, 2, 1, 4), f(2, 2, 1, 4), f(2, 2, 1, 4), pages, pos, pos + 1),
        "flash_decode": lambda x: flash_decode(x.reshape(1, 2, 4), f(1, 4, 1, 4),
                                               f(1, 4, 1, 4), pos, None),
        "flash_decode_paged": lambda x: flash_decode_paged(
            x.reshape(1, 2, 4), f(2, 2, 1, 4), f(2, 2, 1, 4), pos, None, pages),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrappers_refuse_autograd(name):
    """Every kernel wrapper raises when autograd would record it (grad mode
    on, an input requiring grad) -- the same check on both devices, so a
    gradient can never be cut silently on the card -- and runs under
    ``torch.no_grad()`` or on inputs that do not require grad."""
    call = _kernel_calls()[name]
    shape = (2, 1) if name == "block_gemm_int8" else (2, 4)
    x = torch.randn(*shape)
    call(x)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x.clone().requires_grad_())
    with torch.no_grad():
        call(x.clone().requires_grad_())
    assert name in {w.__name__ for w in ops.LAUNCH_COUNTERS}


def test_training_attention_is_plain_by_rule():
    """Under autograd ``dense_attention`` is the plain version (which
    differentiates); without it the kernel wrapper (here its CPU path) --
    the same numbers either way."""
    q, k, v = (torch.randn(1, 4, 6, 8) for _ in range(3))
    qg = q.clone().requires_grad_()
    out = TL.dense_attention(qg, k, v, causal=True)
    assert out.grad_fn is not None
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(qg, k, v)
    torch.testing.assert_close(out.detach(), TL.dense_attention(q, k, v, causal=True),
                               atol=0, rtol=0)


def test_train_cli_runs_on_the_cpu_and_refuses_a_mesh(tmp_path, capsys):
    report = train_cli.main(["--arch", "olmo-1b", "--reduced", "--steps", "4",
                             "--batch", "2", "--seq", "16", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                             "--log-every", "2"])
    assert report.final_step == 4 and len(report.losses) == 4
    assert all(np.isfinite(report.losses))
    assert "step     4 loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # a mesh names its process-group backend
        train_cli.main(["--mesh", "2x1", "--device", "cpu"])
    assert "--mesh 2x1 needs --backend" in capsys.readouterr().err
