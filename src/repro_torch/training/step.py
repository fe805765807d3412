"""Train state and step builders (port of ``repro.training.step``).

The step is pure, as the reference's: ``train_step(state, batch)`` returns
a new :class:`TrainState` and never writes the one it is given.  Gradients
come from ``torch.autograd.grad`` over leaf copies of the parameters (new
tensors that share the weights' storage and require grad), so the state's
own tensors never require grad.  On the card the GEMMs differentiate
through ``ops.cgra_matmul``'s backward kernels and attention runs its plain
version (``models.layers.dense_attention``); each layer group runs under
the config's ``remat_policy`` (``models.model._remat``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.data.pipeline import to_device
from repro_torch.models import model as M
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_moments

F32 = torch.float32


class TrainState(NamedTuple):
    step: torch.Tensor  # scalar int32
    params: Any
    mu: Any
    nu: Any


def init_state(cfg: ArchConfig, opt: AdamWConfig, seed: int = 0, device=None,
               main_repeats: int | None = None) -> TrainState:
    """Seeded random parameters (``model.init``, the main stage cut to
    ``main_repeats`` when given) and zero moments on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    params = M.init(cfg, seed, dev, main_repeats)
    mu, nu = init_moments(params, opt)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params, mu, nu)


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def value_and_grad(cfg: ArchConfig, params, batch: dict, *, attn_chunk: int = 0,
                   main_repeats: int | None = None):
    """(loss, extras, grads) of ``model.loss_fn`` at ``params``: grads in
    each parameter's dtype, in a tree of the params' structure (a leaf the
    loss does not read, as a text embedding under an audio frontend, gets
    zeros, as ``jax.grad`` gives)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tracked = tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss, extras = M.loss_fn(cfg, tracked, batch, attn_chunk=attn_chunk,
                                 main_repeats=main_repeats)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in extras.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ArchConfig, opt: AdamWConfig, *, accum_steps: int = 1,
                    attn_chunk: int = 0, main_repeats: int | None = None,
                    compress_pod: bool = False, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds numpy arrays or tensors (``data.pipeline.SyntheticLM.batch_at``);
    they are moved to the parameters' device.

    ``accum_steps`` > 1 splits the batch's leading dim into that many
    microbatches, sums their gradients into f32 zeros and divides: the
    reference's accumulation, one microbatch's activations at a time.
    ``metrics``: loss (the microbatches' mean), ce and aux (the last
    microbatch's, as the reference), grad_norm, lr and the step.
    ``attn_chunk`` query-chunks the plain attention; ``main_repeats`` trains
    the main stage at that depth (a state from ``init_state(main_repeats=)``).

    Not ported (the reference's multi-device options): ``compress_pod`` /
    ``mesh`` raise (ROADMAP Queue 1 item 13)."""
    if compress_pod or mesh is not None:
        raise NotImplementedError("compress_pod / mesh: the port trains on one device; "
                                  "the cross-pod compressed mean and meshes are "
                                  "ROADMAP Queue 1 item 13")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def vg(params, batch):
        return value_and_grad(cfg, params, batch, attn_chunk=attn_chunk,
                              main_repeats=main_repeats)

    def grads_of(params, batch):
        if accum_steps == 1:
            return vg(params, batch)
        micro = {k: v.reshape(accum_steps, -1, *v.shape[1:]) for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
        lsum = torch.zeros((), dtype=F32, device=_device(params))
        for i in range(accum_steps):
            loss, extras, g = vg(params, {k: v[i] for k, v in micro.items()})
            tree_map(lambda a, x: a.add_(x), acc, g)  # acc is the step's own
            lsum = lsum + loss
        return lsum / accum_steps, extras, tree_map(lambda a: a / accum_steps, acc)

    def train_step(state: TrainState, batch: dict):
        batch = to_device(batch, _device(state.params))
        loss, extras, grads = grads_of(state.params, batch)
        with torch.profiler.record_function("adamw_update"):  # a trace's optimizer span
            params, mu, nu, om = adamw_update(opt, state.params, grads, state.mu,
                                              state.nu, state.step)
        metrics = {"loss": loss, **extras, **om, "step": state.step}
        return TrainState(state.step + 1, params, mu, nu), metrics

    return train_step


def make_eval_step(cfg: ArchConfig, attn_chunk: int = 0):
    """Returns ``eval_step(params, batch) -> {"loss", "ce", "aux"}``, run
    without autograd: attention on its kernel (on the CPU its plain
    version), which takes the whole query block; ``attn_chunk`` chunks
    MLA's plain attention, which has no kernel."""

    @torch.no_grad()
    def eval_step(params, batch):
        loss, extras = M.loss_fn(cfg, params, to_device(batch, _device(params)),
                                 attn_chunk=attn_chunk)
        return {"loss": loss, **extras}

    return eval_step
