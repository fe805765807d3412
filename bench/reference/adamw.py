"""AdamW in plain float32 PyTorch (Loshchilov & Hutter, arXiv:1711.05101),
as the cell's optimizer settings state it: gradients clipped to a global
norm of ``clip_norm``; first and second moments with bias correction;
decoupled weight decay on every leaf of two or more dimensions; a learning
rate that warms up linearly over ``warmup_steps`` and then follows a
cosine down to ``min_lr_ratio * lr`` at ``total_steps``.

Nothing here imports the program under test.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of the update at step index ``step`` (0 first)."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(1.0, opt["warmup_steps"])
    prog = (step - opt["warmup_steps"]) / max(1.0, opt["total_steps"] - opt["warmup_steps"])
    prog = min(max(prog, 0.0), 1.0)
    ratio = opt["min_lr_ratio"]
    return opt["lr"] * (ratio + (1 - ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


def clipped(opt: dict, grads: dict) -> dict:
    """The gradients as the update uses them: scaled down to a global norm
    of ``clip_norm`` when they exceed it."""
    norm = torch.sqrt(sum(torch.sum(g.to(F32) ** 2) for g in grads.values()))
    scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g.to(F32) * scale for k, g in grads.items()}


@torch.no_grad()
def update(opt: dict, params: dict, grads: dict, m: dict, v: dict, step: int) -> None:
    """One AdamW step at index ``step`` on float32 ``params`` and moments
    ``m``, ``v``, in place."""
    g = clipped(opt, grads)
    lr, b1, b2 = lr_at(opt, step), opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    for k, p in params.items():
        m[k].mul_(b1).add_((1 - b1) * g[k])
        v[k].mul_(b2).add_((1 - b2) * g[k] * g[k])
        delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + opt["eps"])
        if p.dim() >= 2:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
