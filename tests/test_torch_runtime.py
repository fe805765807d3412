"""The port's checkpoints and training runtime: the counterparts of
``tests/test_runtime.py``, and checkpoints crossing between the packages.

- round trip (f32 and bf16 states, int8 moments), keep-N garbage collection,
  async == sync: bit-equal;
- a restarted run (a failure injected at step 5) resumes the exact loss
  stream and ends at the same parameters as a straight run: bit-equal (the
  step is pure and the data a function of (seed, step));
- a JAX-written f32 checkpoint restores in the port bit-equal; the port
  writes the reference's keys; a bf16 leaf written by JAX (``|V2`` records in
  the npz) makes the reference's own restore raise, and the port reads it.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.checkpoint.manager import _flatten
from repro.training import AdamWConfig as JAdamW
from repro.training import init_state as j_init_state
import repro_torch.configs as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import bridge
from repro_torch.runtime import FailureInjector, StragglerMonitor, TrainRunner
from repro_torch.training import AdamWConfig, init_state, make_train_step


@pytest.fixture()
def tiny():
    cfg = TC.reduce_config(TC.get_config("olmo-1b"))
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50, clip_norm=1.0)
    step = make_train_step(cfg, opt)
    data = SyntheticLM(cfg, batch=2, seq=32)
    state = init_state(cfg, opt, seed=0, device="cpu")
    return cfg, opt, step, data, state


def _equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k].reshape(-1).view(np.uint8),
                                      fb[k].reshape(-1).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_checkpoint_roundtrip(tmp_path, tiny, moments):
    cfg, _, _, _, _ = tiny
    state = init_state(cfg, AdamWConfig(moments_dtype=moments), seed=3, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    mgr.save(3, state)
    _equal(mgr.restore(3, state), state)
    assert mgr.meta(3)["step"] == 3


def test_checkpoint_roundtrip_bf16(tmp_path):
    """A bf16 model state (the full configs' dtype): every bf16 leaf goes
    to disk as 2-byte ``|V2`` records, as JAX writes them, and comes back
    bit-equal as bfloat16."""
    cfg = TC.reduce_config(TC.get_config("olmo-1b")).with_(compute_dtype=torch.bfloat16)
    state = init_state(cfg, AdamWConfig(moments_dtype="bf16"), seed=4, device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    with np.load(os.path.join(tmp_path, "step_1", "arrays.npz")) as z:
        assert z[".params/embed"].dtype == np.dtype("V2")
        assert z[".mu/embed"].dtype == np.dtype("V2")
        assert z[".step"].dtype == np.int32
    restored = mgr.restore(1, state)
    assert restored.params["embed"].dtype == torch.bfloat16
    _equal(restored, state)


def test_checkpoint_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(3) * s})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert float(mgr.restore(4, {"x": torch.zeros(3)})["x"][0]) == 4.0


def test_async_save_matches_sync(tmp_path, tiny):
    _, _, _, _, state = tiny
    m_async = CheckpointManager(str(tmp_path / "as"), async_save=True)
    m_sync = CheckpointManager(str(tmp_path / "sy"), async_save=False)
    m_async.save(7, state)
    m_sync.save(7, state)
    m_async.wait()
    _equal(m_async.restore(7, state), m_sync.restore(7, state))


def test_restart_resumes_exact_stream(tmp_path, tiny):
    """8 steps straight vs 8 steps with a failure at step 5 (checkpoints
    every 2): one restart, steps 4-5 run again, the same losses for every
    step and the same final state, bit for bit."""
    _, _, step, data, state = tiny
    r1 = TrainRunner(step, data.batch_at, CheckpointManager(str(tmp_path / "a"),
                                                            async_save=False), ckpt_every=2)
    s1, rep1 = r1.run(state, 8)
    inj = FailureInjector(fail_at={5})
    r2 = TrainRunner(step, data.batch_at, CheckpointManager(str(tmp_path / "b"),
                                                            async_save=False),
                     ckpt_every=2, injector=inj)
    s2, rep2 = r2.run(state, 8)
    assert rep2.restarts == 1 and rep2.steps_run > 8 and rep2.final_step == 8
    assert inj.events == [("train.step", 5)]
    assert rep2.losses[:5] + rep2.losses[6:] == rep1.losses  # step 4 ran twice
    _equal(s1, s2)


def test_restart_before_the_first_checkpoint_starts_from_the_given_state(tmp_path, tiny):
    """A failure before any checkpoint restarts from ``init_state``, which
    the pure step never wrote: the same stream as a straight run."""
    _, _, step, data, state = tiny
    straight = TrainRunner(step, data.batch_at, CheckpointManager(
        str(tmp_path / "a"), async_save=False), ckpt_every=10).run(state, 4)
    failed = TrainRunner(step, data.batch_at, CheckpointManager(
        str(tmp_path / "b"), async_save=False), ckpt_every=10,
        injector=FailureInjector(fail_at={2})).run(state, 4)
    assert failed[1].restarts == 1
    assert failed[1].losses[2:] == straight[1].losses
    _equal(straight[0], failed[0])


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(threshold=2.0, warmup=2)
    for s in range(6):
        assert not mon.observe(s, 0.10)
    assert mon.observe(6, 0.50)
    assert mon.flagged and mon.flagged[0][0] == 6


def test_nonfinite_loss_triggers_restart(tmp_path, tiny):
    _, _, step, data, state = tiny
    calls = {"n": 0}

    def poisoned_step(st, batch):
        calls["n"] += 1
        st2, m = step(st, batch)
        if calls["n"] == 4:
            m = dict(m, loss=torch.tensor(float("nan")))
        return st2, m

    runner = TrainRunner(poisoned_step, data.batch_at,
                         CheckpointManager(str(tmp_path), async_save=False), ckpt_every=2)
    _, rep = runner.run(state, 6)
    assert rep.restarts == 1 and rep.final_step == 6
    assert all(np.isfinite(rep.losses))


def _jax_state(moments="f32"):
    jcfg = JC.reduce_config(JC.get_config("qwen3-moe-30b-a3b"))
    jopt = JAdamW(moments_dtype=moments)
    st = j_init_state(jcfg, jopt, jax.random.PRNGKey(2))
    # moments as after a step: nonzero, so that the comparison means something
    rng = np.random.default_rng(0)
    bump = lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))  # noqa: E731
    if moments == "f32":
        st = st._replace(mu=jax.tree.map(bump, st.mu), step=jnp.int32(5))
    return st


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_jax_written_checkpoint_restores_in_the_port(tmp_path, moments):
    """The reference's ``CheckpointManager`` saves its f32 train state
    (reduced qwen3-moe, f32 or int8 moments); the port restores it into its
    own ``TrainState`` bit-equal, and writes the same keys itself."""
    jstate = _jax_state(moments)
    JCheckpointManager(str(tmp_path), async_save=False).save(5, jstate)
    tcfg = TC.reduce_config(TC.get_config("qwen3-moe-30b-a3b"))
    topt = AdamWConfig(moments_dtype=moments)
    like = init_state(tcfg, topt, device="cpu")
    got = CheckpointManager(str(tmp_path), async_save=False).restore(5, like)
    want = _flatten(jstate)
    mine = flatten(got)
    assert mine.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(mine[k], np.asarray(want[k]), err_msg=k)
    _equal(got, bridge.state_from_numpy(tcfg, topt, want, device="cpu"))


def test_jax_bf16_leaf_fails_the_reference_restore_and_restores_in_the_port(tmp_path):
    """JAX writes a bf16 leaf (the full configs' ``param_dtype``) into
    ``arrays.npz`` as ``|V2`` records: the reference's own ``restore``
    cannot cast them back (ROADMAP Queue 3), while the port's reads them as
    bfloat16, bit-equal."""
    w = jax.random.normal(jax.random.PRNGKey(1), (4, 6), jnp.float32).astype(jnp.bfloat16)
    tree = {"w": w, "n": jnp.arange(3, dtype=jnp.int32)}
    jm = JCheckpointManager(str(tmp_path), async_save=False)
    jm.save(1, tree)
    with np.load(os.path.join(tmp_path, "step_1", "arrays.npz")) as z:
        assert z["w"].dtype == np.dtype("V2")
    with pytest.raises(ValueError):
        jm.restore(1, tree)
    got = CheckpointManager(str(tmp_path), async_save=False).restore(
        1, {"w": torch.zeros(4, 6, dtype=torch.bfloat16), "n": torch.zeros(3, dtype=torch.int32)})
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(), np.asarray(w, np.float32))
    np.testing.assert_array_equal(got["n"].numpy(), [0, 1, 2])
