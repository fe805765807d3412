"""Cross-pod int8 gradient compression (port of ``repro.training.compress``).

The ``pod`` mesh axis is pure data parallelism over the slow pod-to-pod
links; compressing its gradient mean is the classic bandwidth saving.  Each
pod's gradient is quantized to int8 with one scale shared by every pod
(the max over the pods), the int8 values are all-gathered (a quarter of
f32's bytes on the wire), summed in int32 on every rank and scaled back.
Error feedback carries the quantization residual into the next step, which
keeps the mean unbiased to first order.

The reference runs this inside ``shard_map`` over ``pod`` with ``data`` /
``model`` left to the partitioner, so its ``jnp.max(jnp.abs(g))`` sees each
pod's leaf whole.  Here a rank holds a shard of the leaf (``pspec``): its
max is taken over the pod axis *and* every axis the shard is cut on, so
the scale is the whole logical leaf's, as the reference's.  Plain PyTorch:
the reference has no kernel here, and the time is the collective's.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch.sharding import spec_axes

F32 = torch.float32


def compressed_mean(g, mesh, axis: str = "pod", err=None, pspec: tuple = ()):
    """Mean of ``g`` over ``axis`` through an int8 all-gather and a local
    int32 sum.  Returns (mean in g's dtype, new_err); ``err`` (f32, g's
    shape) is the error-feedback residual, None to disable it (new_err is
    then None).  ``pspec``: how the whole leaf is cut into shards, ``g``
    being this rank's (the scale is taken over the whole leaf)."""
    gf = g.to(F32)
    if err is not None:
        gf = gf + err
    amax = mesh.all_max(gf.abs().amax(), (axis,) + spec_axes(pspec))
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    t = gf / scale
    q = t.round_().clamp_(-127, 127).to(torch.int8)
    del t
    n = mesh.size(axis)
    allq = mesh.all_gather(q[None], axis, 0)  # [n, ...] int8 on the wire
    # summed a pod at a time: one int32 copy of the leaf, not n of them
    total = allq[0].to(torch.int32)
    for part in allq[1:]:
        total += part
    del allq
    mean = total.to(F32)
    del total
    mean = mean.mul_(scale).div_(torch.full_like(scale, float(n)))
    new_err = gf - q.to(F32) * scale if err is not None else None
    return mean.to(g.dtype), new_err


def compressed_tree_mean(grads, mesh, axis: str = "pod", errs=None, pspecs=None):
    """:func:`compressed_mean` of every leaf of ``grads`` (``pspecs``: a tree
    of the leaves' specs, None for whole leaves).  Returns (means, new errs
    or None when ``errs`` is None).  Leaves meet their specs and errors by
    key, not by position (the trees' keys may come in other orders)."""
    leaves = tree_leaves(grads)
    specs = tree_leaves(tree_map(lambda g, ps: ps, grads, pspecs)) if pspecs is not None \
        else [()] * len(leaves)
    es = tree_leaves(tree_map(lambda g, e: e, grads, errs)) if errs is not None \
        else [None] * len(leaves)
    pairs = [compressed_mean(g, mesh, axis, e, ps) for g, e, ps in zip(leaves, es, specs)]
    mean = tree_unflatten(grads, [p[0] for p in pairs])
    if errs is None:
        return mean, None
    return mean, tree_unflatten(grads, [p[1] for p in pairs])
