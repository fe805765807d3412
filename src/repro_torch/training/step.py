"""Train state and step builders (port of ``repro.training.step``).

The step is pure, as the reference's: ``train_step(state, batch)`` returns
a new :class:`TrainState` and never writes the one it is given.  Gradients
come from ``torch.autograd.grad`` over leaf copies of the parameters (new
tensors that share the weights' storage and require grad), so the state's
own tensors never require grad.  On the card the GEMMs differentiate
through ``ops.cgra_matmul``'s backward kernels and attention runs its plain
version (``models.layers.dense_attention``); each layer group runs under
the config's ``remat_policy`` (``models.model._remat``).

Over a mesh (``make_train_step(mesh=...)``, one process a rank) each rank
holds its shard of the state (:func:`shard_state`: parameters and moments
cut by ``models.model.param_pspecs``, FSDP with ``cfg.fsdp``, the profile
``cfg.parallel_mode`` names) and computes the loss of its rows of the
global batch the step is handed (:func:`local_batch`).  Gradients come out
of autograd whole on the tensor-parallel ranks and reduce-scattered over
the FSDP axes; :func:`mesh_value_and_grad` sums the rest over the batch
axes in f32 and divides, so every rank holds the mean gradient of its
shard, and AdamW updates the shards (``optimizer.adamw_update(mesh=)``).
With ``compress_pod`` the mean over ``pod`` is ``training.compress``'s
int8 one.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device, span
from repro_torch.core.quant import QTensor
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.data.pipeline import local_batch, to_device
from repro_torch.launch.sharding import (activation_mesh, batch_entry, local_slice,
                                         moment_pspecs, profile_for, spec_axes)
from repro_torch.models import model as M
from repro_torch.training.compress import compressed_mean
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


# -- over a mesh ---------------------------------------------------------------

def mesh_config(cfg: ArchConfig, mesh) -> ArchConfig:
    """``cfg`` as a mesh's train step runs it: expert-parallel MoE
    (``moe_shard_map``) where tensor parallelism splits the experts; where
    it does not, the experts' FFN dim is cut over ``model`` and
    ``layers.moe_forward`` runs every expert on its columns."""
    tp = mesh.size("model") if profile_for(cfg).tp_rules else 1
    if tp > 1 and cfg.num_experts and cfg.num_experts % tp == 0:
        return cfg.with_(moe_shard_map=True)
    return cfg


def state_pspecs(cfg: ArchConfig, opt: AdamWConfig, mesh,
                 main_repeats: int | None = None) -> TrainState:
    """How each leaf of a :class:`TrainState` is cut on ``mesh``: the
    parameters by ``model.param_pspecs`` (with ``cfg.fsdp``), the moments as
    ``launch.sharding.moment_pspecs`` places them, the step whole."""
    ps = M.param_pspecs(cfg, mesh, fsdp=cfg.fsdp, main_repeats=main_repeats)
    mom = moment_pspecs(ps, opt.moments_dtype)
    return TrainState((), ps, mom, mom)


def shard_state(cfg: ArchConfig, opt: AdamWConfig, state: TrainState, mesh,
                main_repeats: int | None = None) -> TrainState:
    """This rank's shard of a whole ``state`` (as :func:`init_state` or a
    restore makes it), each leaf a tensor of its own (:func:`state_pspecs`)."""
    specs = state_pspecs(cfg, opt, mesh, main_repeats)

    def cut(x, ps):
        if isinstance(x, QTensor):
            return QTensor(local_slice(x.q, mesh, ps.q), local_slice(x.scale, mesh, ps.scale))
        return local_slice(x, mesh, ps)

    return TrainState(state.step, *(tree_map(cut, getattr(state, f), getattr(specs, f))
                                    for f in ("params", "mu", "nu")))


def _batch_axes(cfg: ArchConfig, mesh) -> tuple:
    return tuple(a for a in profile_for(cfg).batch_axes if a in mesh.shape)


def mesh_value_and_grad(cfg: ArchConfig, params, batch: dict, mesh, *, accum_steps: int = 1,
                        attn_chunk: int = 0, main_repeats: int | None = None,
                        compress_pod: bool = False, global_batch: int | None = None):
    """(loss, extras, grads) of one step over ``mesh``: ``params`` this
    rank's shard (:func:`shard_state`), ``batch`` the step's *global* batch
    (this rank takes its rows, :func:`local_batch`).  ``grads`` holds the
    mean gradient of the global loss for each leaf this rank holds, in the
    leaf's dtype; loss and extras are the means over the batch ranks.

    Each leaf's local gradient is already summed over its FSDP axes (the
    gather's reduce-scatter); it is summed over the other batch axes in f32
    and divided by the number of batch ranks.  With ``compress_pod`` and a
    ``pod`` axis the exact sum runs within the pod and the mean over pods
    is ``compressed_mean`` of each leaf (no error feedback, as the
    reference's step).  A leaf is finished (f32, summed, cast back) before
    the next starts, so one leaf's f32 copies are alive at a time.
    ``accum_steps`` splits each rank's rows into that many microbatches,
    the rows of global microbatch i in the i-th.  ``global_batch``: the
    batch handed is already this rank's rows (as :func:`local_batch` cuts
    them) of a global batch of that many rows -- the dry run's arguments
    (``launch.cells.build_cell``), which hold a rank's rows only: its
    memory record counts what a rank's device holds, and the rows cut here
    from a meta global batch would be views that keep the whole batch's
    storage alive."""
    cfg = mesh_config(cfg, mesh)
    profile = profile_for(cfg)
    pspecs = M.param_pspecs(cfg, mesh, fsdp=cfg.fsdp, main_repeats=main_repeats)
    axes = _batch_axes(cfg, mesh)
    pod = compress_pod and "pod" in mesh.shape
    exact = tuple(a for a in axes if not (pod and a == "pod"))
    B = global_batch or next(iter(batch.values())).shape[0]
    split = batch_entry(mesh, B // accum_steps, profile)
    if not global_batch:
        batch = local_batch(batch, mesh, profile, accum_steps)
    rows = to_device(batch, _device(params))
    with activation_mesh(mesh, profile, split):
        if accum_steps == 1:
            loss, extras, grads = value_and_grad(cfg, params, rows, attn_chunk=attn_chunk,
                                                 main_repeats=main_repeats)
        else:
            loss, extras, grads = _accumulated(cfg, params, rows, accum_steps, attn_chunk,
                                               main_repeats)

    def mean(x, axes, summed=()):  # ``summed``: axes x is already a sum over
        if not axes:
            return x
        for a in axes:
            if a not in summed:
                x = mesh.all_reduce(x, a)
        return x / math.prod(mesh.size(a) for a in axes)

    def finish(g, ps, p):
        g = mean(g.to(F32), exact, spec_axes(ps))
        if pod:
            g = compressed_mean(g, mesh, "pod", pspec=ps)[0]
        return g.to(p.dtype)

    grads = tree_map(finish, grads, pspecs, params)
    return (mean(loss.to(F32), axes),
            {k: mean(v.to(F32), axes) for k, v in extras.items()}, grads)


def _accumulated(cfg, params, batch, accum_steps, attn_chunk, main_repeats):
    """The microbatches' mean loss, the last one's extras and the mean of
    their gradients (summed in f32): the reference's accumulation."""
    micro = {k: v.reshape(accum_steps, -1, *v.shape[1:]) for k, v in batch.items()}
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
    lsum = torch.zeros((), dtype=F32, device=_device(params))
    for i in range(accum_steps):
        loss, extras, g = value_and_grad(cfg, params, {k: v[i] for k, v in micro.items()},
                                         attn_chunk=attn_chunk, main_repeats=main_repeats)
        tree_map(lambda a, x: a.add_(x), acc, g)  # acc is the step's own
        lsum = lsum + loss
    return lsum / accum_steps, extras, tree_map(lambda a: a / accum_steps, acc)


def make_train_step(cfg: ArchConfig, opt: AdamWConfig, *, accum_steps: int = 1,
                    attn_chunk: int = 0, main_repeats: int | None = None,
                    compress_pod: bool = False, mesh=None, global_batch: int | None = None):
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

    ``mesh`` (a ``launch.mesh.Mesh`` this process is a rank of): the state
    is this rank's shard (:func:`shard_state`) and ``batch`` the step's
    global batch, of which the step takes this rank's rows; gradients as
    :func:`mesh_value_and_grad`.  ``compress_pod`` on a mesh with a ``pod``
    axis means the gradients over pods with the int8 compressed mean;
    without a ``pod`` axis (or a mesh) it trains plainly, as the reference.
    ``global_batch`` (a mesh's step only): ``batch`` is this rank's rows of
    a global batch of that many rows (:func:`mesh_value_and_grad`).
    Every ported family trains on a mesh: attention (GQA or MLA), SSD,
    cross-attention and the encoder, with dense or MoE FFNs (the MoE
    meshes ``layers.moe_forward`` refuses aside)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    pspecs = None
    if mesh is not None:
        pspecs = M.param_pspecs(mesh_config(cfg, mesh), mesh, fsdp=cfg.fsdp,
                                main_repeats=main_repeats)

    def grads_of(params, batch):
        if mesh is not None:
            return mesh_value_and_grad(cfg, params, batch, mesh, accum_steps=accum_steps,
                                       attn_chunk=attn_chunk, main_repeats=main_repeats,
                                       compress_pod=compress_pod, global_batch=global_batch)
        batch = to_device(batch, _device(params))
        if accum_steps == 1:
            return value_and_grad(cfg, params, batch, attn_chunk=attn_chunk,
                                  main_repeats=main_repeats)
        return _accumulated(cfg, params, batch, accum_steps, attn_chunk, main_repeats)

    def train_step(state: TrainState, batch: dict):
        loss, extras, grads = grads_of(state.params, batch)
        with span("adamw_update"):  # a trace's optimizer span
            params, mu, nu, om = adamw_update(opt, state.params, grads, state.mu,
                                              state.nu, state.step, mesh, pspecs)
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
