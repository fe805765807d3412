"""Switchless-torus collective schedules (port of ``repro.core.torus``, the
paper's claim C3 at pod scale).

The paper schedules data movement as neighbour-only hops that overlap the
compute they feed.  The reference writes these as ``lax.ppermute`` ring
schedules inside ``shard_map``; here each function is the code one rank
runs over the ``axis`` group of a :class:`~repro_torch.launch.mesh.Mesh`,
each hop a ``batch_isend_irecv`` to the ring neighbour
(:meth:`Mesh.ring_shift`) started before the partial GEMM it overlaps and
waited just before its result is used.  The GEMMs are the port's block
GEMM (``core.gemm.cgra_gemm``).  Under gloo a hop on a CUDA tensor goes
through host memory (the mesh's one staging rule); the GEMM still runs on
the card while the hop is in flight.

The chunk orders are the reference's, so :func:`ring_allreduce` returns the
same bytes on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.gemm import cgra_gemm


def _ring(mesh, axis):
    return mesh.size(axis), mesh.index(axis)


def ring_allgather_matmul(x_shard, w_local, mesh, axis: str = "model"):
    """Y = X @ W with X split over rows (tokens) and W over columns.

    x_shard: [Tl, D] (this rank's token chunk), w_local: [D, Fl].  Returns
    [tp * Tl, Fl]: every token row, this rank's feature shard.  At step s
    the rank multiplies the chunk it holds while the next one is in flight
    from its ring neighbour: the all-gather's bytes, as tp - 1 neighbour
    hops."""
    tp, idx = _ring(mesh, axis)
    Tl = x_shard.shape[0]
    w_local = w_local.contiguous()
    out = x_shard.new_empty((tp * Tl, w_local.shape[1]), dtype=w_local.dtype)
    cur = x_shard.contiguous()
    for s in range(tp):
        hop = mesh.ring_shift(cur, axis) if s < tp - 1 else None
        src = (idx - s) % tp  # whose chunk this is (chunks travel i -> i + 1)
        out[src * Tl:(src + 1) * Tl] = cgra_gemm(cur, w_local).to(out.dtype)
        if hop is not None:
            cur = hop.wait()
    return out


def matmul_reducescatter_ring(h_full, w_local, mesh, axis: str = "model"):
    """Y_shard = reduce_scatter_rows(H @ W_partial).

    h_full: [T, Fl] (this rank's feature shard of every token), w_local:
    [Fl, D].  Returns [T / tp, D]: this rank's token chunk of the summed
    output.  The accumulator of chunk c travels the ring and collects each
    rank's partial GEMM of it: tp - 1 hops, each in flight while the next
    partial GEMM runs."""
    tp, idx = _ring(mesh, axis)
    Tl = h_full.shape[0] // tp
    w_local = w_local.contiguous()

    def chunk_mm(c):
        return cgra_gemm(h_full[c * Tl:(c + 1) * Tl].contiguous(), w_local)

    # the accumulator that ends on rank i starts at rank i + 1 carrying chunk
    # i; a rank visited at hop s therefore adds chunk (idx - s - 1)
    acc = chunk_mm((idx - 1) % tp)
    for s in range(1, tp):
        hop = mesh.ring_shift(acc, axis)
        part = chunk_mm((idx - s - 1) % tp)
        acc = hop.wait() + part
    return acc


def ring_allreduce(x, mesh, axis: str = "model"):
    """All-reduce as neighbour hops: a ring reduce-scatter, then a ring
    all-gather, over x flattened into tp chunks (zero-padded)."""
    tp, idx = _ring(mesh, axis)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % tp
    chunks = F.pad(flat, (0, pad)).reshape(tp, -1)
    acc = chunks[(idx - 1) % tp]
    for s in range(1, tp):
        hop = mesh.ring_shift(acc, axis)
        acc = hop.wait() + chunks[(idx - s - 1) % tp]
    out = torch.empty_like(chunks)
    cur = acc
    for s in range(tp):
        hop = mesh.ring_shift(cur, axis) if s < tp - 1 else None
        out[(idx - s) % tp] = cur
        if hop is not None:
            cur = hop.wait()
    res = out.reshape(-1)
    if pad:
        res = res[:-pad]
    return res.reshape(x.shape)


def torus_ffn(x, w_gate, w_up, w_down, mesh, axis: str = "model", act=F.silu):
    """SwiGLU FFN with ring-scheduled collectives only.  x: [B, S, D], the
    same on every rank of ``axis``; w_gate / w_up [D, F/tp] and w_down
    [F/tp, D] this rank's ffn shards.  Returns [B, S/tp, D]: this rank's
    sequence chunk of the output (the reference's ``out_specs`` shard)."""
    tp, idx = _ring(mesh, axis)
    B, S, D = x.shape
    Sl = S // tp
    xf = x[:, idx * Sl:(idx + 1) * Sl].reshape(B * Sl, D)
    g = ring_allgather_matmul(xf, w_gate, mesh, axis)
    u = ring_allgather_matmul(xf, w_up, mesh, axis)
    y = matmul_reducescatter_ring(act(g) * u, w_down, mesh, axis)
    return y.reshape(B, Sl, D)
