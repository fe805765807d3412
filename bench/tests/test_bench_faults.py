"""A run with the timed path broken underneath is not ``correct``.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU (the cell's own file and limits, at reduced widths and
lengths), with one fault planted in the program: for the serving cells a
token altered where the sampler produces it, and a step that leaves its
state unchanged (no new cache row written); for the training cell a step
that returns its state unchanged, and half of the batch left out (the
mean taken over the rest).  A cell on one chip has no exchange between
chips to leave out."""
import pytest

from bench.lib import harness, registry
from bench.tests.tiny import tiny_cell, tiny_config, tiny_job, tiny_mix

SERVE_CELLS = ["olmo-1b.chat", "minicpm3-4b.chat"]


def _serve(cell):
    w = registry.workload(cell)
    return harness.run_cell(cell, 23, 3.0, False, "cpu", config=tiny_config(w["config"]),
                            mix=tiny_mix(w["traffic"]), overrides=tiny_cell(cell))


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_the_sound_tiny_run_is_correct(cell):
    res, run = _serve(cell)
    assert res["correct"] is True and run.checks["tokens_checked"] > 0


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_a_token_altered_where_produced(cell, monkeypatch):
    from repro_torch.serving.engine import ModelRunner
    sample = ModelRunner._sample

    def altered(self, lf, temps, gens):
        return (sample(self, lf, temps, gens) + 1) % self.vocab
    monkeypatch.setattr(ModelRunner, "_sample", altered)
    res, _ = _serve(cell)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_a_step_that_leaves_its_state_unchanged(cell, monkeypatch):
    """No step writes its cache rows: not the chunk or decode step's
    (``StepRows.write``), not a whole prefill's (``_scatter_new``)."""
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import ModelRunner
    monkeypatch.setattr(L.StepRows, "write", lambda self, pool, new: pool)
    monkeypatch.setattr(ModelRunner, "_scatter_new", lambda self, small, table, slot, n: None)
    res, _ = _serve(cell)
    assert res["correct"] is False


def _train(monkeypatch=None, fault=None):
    if fault is not None:
        import repro_torch.training.step as TS
        make = TS.make_train_step

        def broken(cfg, opt, **kw):
            fn = make(cfg, opt, **kw)

            def step(state, batch):
                if fault == "unchanged":
                    return state, fn(state, batch)[1]
                return fn(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
            return step
        monkeypatch.setattr(TS, "make_train_step", broken)
    return harness.run_cell("olmo-1b.train", 29, 3.0, False, "cpu",
                            config=tiny_config("olmo-1b"), mix=tiny_job("pretrain_docs"))


def test_the_sound_tiny_train_run_is_correct():
    res, _ = _train()
    assert res["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step(fault, monkeypatch):
    res, run = _train(monkeypatch, fault)
    assert res["correct"] is False, run.checks
