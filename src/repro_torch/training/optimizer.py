"""AdamW with a linear-warmup + cosine schedule, global-norm clipping,
decoupled weight decay on matrices, and f32, bf16 or int8 moments (port of
``repro.training.optimizer``).

Every function is pure: :func:`adamw_update` returns new tensors and
writes none of its inputs, so a runner that restarts from the state it was
first given (``runtime.ft.TrainRunner``) resumes from that state and not a
mutated one.  int8 moments are ``QTensor``s from ``core.quant.quantize(x,
axis=-1)``: a leaf [..., N] keeps scales of shape [1, ..., 1, N], a 1-D
leaf one scale an element -- what the reference's ``init_moments`` and
``adamw_update`` make.  (Its dry-run ``moment_shapes`` states [..., 1]
instead; nothing in the port needs it.)

Under a mesh each rank updates the shards it holds: the global norm sums
every leaf's squares over exactly the axes its spec cuts it on (a
replicated leaf counts once), and an int8 moment's max runs over the ranks
that hold the rest of the dims it reduces.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.quant import dequantize, quantize_over
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.sharding import spec_axes

F32 = torch.float32


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "f32"  # f32 | bf16 | int8


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), in f32:
    linear warm-up over ``warmup_steps``, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(F32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _encode_moment(x, kind: str, mesh=None, pspec=None):
    if kind == "int8":
        # ``quantize(x, axis=-1)``: the max over every dim but the last; a
        # shard's max joins the ranks that hold the rest of those dims
        red = tuple(range(x.dim() - 1))
        axes = spec_axes(pspec, red) if mesh is not None else ()
        hook = (lambda a: mesh.all_max(a, axes)) if axes else None
        return quantize_over(x, red, hook)
    if kind == "bf16":
        return x.to(torch.bfloat16)
    return x


def _decode_moment(x, kind: str):
    if kind == "int8":
        return dequantize(x)
    return x.to(F32) if kind == "bf16" else x


def init_moments(params, cfg: AdamWConfig):
    """(mu, nu): zero moments of every parameter leaf, encoded as
    ``cfg.moments_dtype`` says, on the leaf's device."""
    def zeros(p):
        return _encode_moment(torch.zeros(p.shape, dtype=F32, device=p.device),
                              cfg.moments_dtype)
    return tree_map(zeros, params), tree_map(zeros, params)


def global_norm(tree, mesh=None, pspecs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  Under ``mesh``,
    ``tree`` holds this rank's shards and ``pspecs`` their specs: the sums
    of the leaves cut on the same axes are added and all-reduced over those
    axes once (one collective per distinct set), so a replicated leaf is
    counted once.  Each leaf meets its spec by key, not by position: a
    tree from ``model.init`` holds its keys sorted, a spec tree in the
    specs' order."""
    sq = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    if mesh is None:
        return torch.sqrt(torch.stack(sq).sum())
    groups: dict = {}
    axes_of = tree_leaves(tree_map(lambda x, ps: spec_axes(ps), tree, pspecs))
    for s_, axes in zip(sq, axes_of):
        groups.setdefault(axes, []).append(s_)
    total = torch.zeros((), dtype=F32, device=sq[0].device)
    for axes, parts in sorted(groups.items()):
        part = torch.stack(parts).sum()
        for a in axes:
            part = mesh.all_reduce(part, a)
        total = total + part
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, params, grads, mu, nu, step, mesh=None, pspecs=None):
    """One AdamW step at ``step`` (integer tensor): gradients clipped to a
    global norm of ``clip_norm``, bias-corrected moments, decoupled decay
    on leaves with two or more dims.  Returns (new_params, new_mu, new_nu,
    {"grad_norm", "lr"}); the inputs are left as they are.  Under ``mesh``
    the trees hold this rank's shards, cut as ``pspecs`` (the parameters'
    specs) says."""
    gnorm = global_norm(grads, mesh, pspecs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = torch.as_tensor(step).to(F32) + 1.0
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    md = cfg.moments_dtype

    def upd(p, g, m, v, ps=None):
        gf = g.to(F32) * scale
        mf = b1 * _decode_moment(m, md) + (1 - b1) * gf
        vf = b2 * _decode_moment(v, md) + (1 - b2) * gf * gf
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(F32)
        newp = (p.to(F32) - lr * delta).to(p.dtype)
        return newp, _encode_moment(mf, md, mesh, ps), _encode_moment(vf, md, mesh, ps)

    trip = (tree_map(upd, params, grads, mu, nu) if mesh is None
            else tree_map(upd, params, grads, mu, nu, pspecs))
    pick = [tree_map(lambda t, i=i: t[i], trip) for i in range(3)]
    return pick[0], pick[1], pick[2], {"grad_norm": gnorm, "lr": lr}
