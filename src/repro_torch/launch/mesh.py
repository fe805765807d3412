"""Meshes over ``torch.distributed`` ranks (port of ``repro.launch.mesh``).

A JAX mesh is an array of devices that one program spans; here it is an
array of *ranks*, one process each, every rank running the same code (the
reference's ``shard_map`` bodies, written once).  :class:`Mesh` holds the
grid of global ranks, this rank's coordinates on each named axis, and one
process group per axis line through it: ``("data", "model")`` gives a
model group (the ranks that share this rank's data index) and a data
group.  Its collectives are the reference's ``psum`` (an f32 all-reduce),
``all_gather`` and ``ppermute`` (``batch_isend_irecv`` to a ring
neighbour), plus the rank-0 broadcast the serving engine takes its host
decisions from.

The backend is the caller's to name when the process group starts
(``launch.dist.init_process``): ``nccl`` across cards, ``gloo`` on the CPU
or for ranks that share one card (NCCL refuses two ranks on one device).
Under gloo a CUDA tensor is copied to the host for every collective and
back after it (:meth:`Mesh._host`): one rule, written here once.  The copy
is gloo's price on a card, not a choice made behind the caller's back.

Defined as functions and classes only: importing this module touches no
process group.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist


def world_size() -> int:
    """Ranks in the default process group (1 when none is started)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """``shape`` (an ordered dict axis -> size) over the global ranks
    ``ranks`` (an int array of that shape); ``rank`` is this process's
    global rank, ``coords`` its index on each axis (None when the rank lies
    outside the mesh).  Groups are made at construction, by every rank of
    the world in the same order, as ``dist.new_group`` requires."""

    def __init__(self, ranks: np.ndarray, axes: tuple):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axes)
        self.shape = OrderedDict(zip(self.axis_names, self.ranks.shape))
        self.rank = this_rank()
        self.backend = dist.get_backend() if dist.is_initialized() else None
        where = np.argwhere(self.ranks == self.rank)
        self.coords = (dict(zip(self.axis_names, (int(i) for i in where[0])))
                       if len(where) else None)
        #: collectives this mesh has issued (the engine reads it per tick)
        self.collectives = 0
        self.groups: dict = {}
        if self.ranks.size == 1:
            return
        for ax_i, ax in enumerate(self.axis_names):
            if self.ranks.shape[ax_i] == 1:
                continue
            lines = np.moveaxis(self.ranks, ax_i, -1).reshape(-1, self.ranks.shape[ax_i])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[ax] = (g, [int(r) for r in line])
        everyone = [int(r) for r in self.ranks.reshape(-1)]
        g = (dist.group.WORLD if len(everyone) == world_size()
             else dist.new_group(everyone))
        if self.rank in everyone:
            self.groups[None] = (g, everyone)

    @property
    def devices(self) -> np.ndarray:
        """The rank grid (the reference's ``mesh.devices``)."""
        return self.ranks

    @property
    def size_total(self) -> int:
        return int(self.ranks.size)

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 for an axis the mesh lacks)."""
        return self.coords.get(axis, 0) if self.coords else 0

    def peers(self, axis: str | None) -> list[int]:
        """Global ranks of this rank's line along ``axis`` (None: the whole
        mesh), in axis order."""
        return self.groups[axis][1] if axis in self.groups else [self.rank]

    # -- collectives ------------------------------------------------------

    def _host(self, x):
        """The tensor a collective is handed: ``x`` itself, or under gloo a
        host copy of a CUDA tensor (gloo moves host memory)."""
        return x.cpu() if self.backend == "gloo" and x.is_cuda else x

    def all_reduce(self, x, axis: str = "model"):
        """Sum of ``x`` over ``axis`` in f32, cast back to x's dtype: the
        reference's ``psum(o.astype(F32))``.  Identity on an axis of 1."""
        if axis not in self.groups:
            return x
        self.collectives += 1
        t = self._host(x.float().contiguous())
        dist.all_reduce(t, group=self.groups[axis][0])
        return t.to(device=x.device, dtype=x.dtype)

    def all_gather(self, x, axis: str, dim: int = 0):
        """The shards of ``axis`` concatenated along ``dim`` in axis order."""
        if axis not in self.groups:
            return x
        self.collectives += 1
        g, line = self.groups[axis]
        t = self._host(x.contiguous())
        parts = [torch.empty_like(t) for _ in line]
        dist.all_gather(parts, t, group=g)
        return torch.cat(parts, dim).to(x.device)

    def broadcast(self, x, axis: str | None = None):
        """The value of ``x`` on the first rank of ``axis`` (None: the first
        rank of the mesh), everywhere."""
        if axis not in self.groups:
            return x
        self.collectives += 1
        g, line = self.groups[axis]
        t = self._host(x.contiguous())
        dist.broadcast(t, src=line[0], group=g)
        return t.to(x.device)

    def ring_shift(self, x, axis: str = "model", shift: int = 1) -> "RingHop":
        """Send ``x`` to the rank ``shift`` places on along ``axis``'s ring
        and receive the tensor of the rank ``shift`` places back, async (the
        reference's ``ppermute`` with ``_ring_perm``): returns a
        :class:`RingHop` whose :meth:`~RingHop.wait` gives the received
        tensor.  The caller runs its GEMM between the two."""
        g, line = self.groups[axis]
        n, i = len(line), line.index(self.rank)
        self.collectives += 1
        send = self._host(x.contiguous())
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, line[(i + shift) % n], g),
               dist.P2POp(dist.irecv, recv, line[(i - shift) % n], g)]
        return RingHop(dist.batch_isend_irecv(ops), recv, x.device, send)


class RingHop:
    """One ring hop in flight: :meth:`wait` blocks on it and returns the
    received tensor on the sender's device."""

    def __init__(self, works, recv, device, send):
        self.works, self.recv, self.device = works, recv, device
        self._send = send  # kept alive until the hop completes

    def wait(self):
        for w in self.works:
            w.wait()
        self._send = None
        return self.recv.to(self.device)


def _check_ranks(shape, n: int, avail: int, exact: bool):
    if (avail != n) if exact else (avail < n):
        start = ("start one process per rank (repro_torch.launch.dist.spawn, or "
                 "torchrun) and call init_process_group with that world size first")
        if exact:
            raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices but the "
                             f"platform has {avail}; pass shape=/axes= matching the "
                             f"device count (e.g. shape=(1, {avail})), or use "
                             f"make_device_mesh to take a submesh; {start}")
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices; only {avail} "
                         f"available: {start}")


_BUILT: dict = {}


def make_device_mesh(shape, axes, devices=None) -> Mesh:
    """Mesh over the *first* ``prod(shape)`` ranks of ``devices`` (default
    every rank of the world): a submesh, as the reference's over the first
    devices.  Raises when there are fewer.  A mesh over the world's ranks is
    made once per process group and shape, and handed out again after: an
    engine built per request batch makes no new groups."""
    devices = list(range(world_size()) if devices is None else devices)
    n = math.prod(shape)
    _check_ranks(shape, n, len(devices), exact=False)
    key = (tuple(shape), tuple(axes), tuple(devices[:n]),
           dist.group.WORLD if dist.is_initialized() else None)
    if key not in _BUILT:
        _BUILT[key] = Mesh(np.asarray(devices[:n]).reshape(tuple(shape)), axes)
    return _BUILT[key]


def make_mesh(shape, axes) -> Mesh:
    """Mesh over every rank of the world, in rank order."""
    return make_device_mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, shape=None, axes=None) -> Mesh:
    """The pod-scale mesh (16 x 16, or 2 x 16 x 16 with ``multi_pod``),
    validated against the world size instead of assuming one; pass
    ``shape=``/``axes=`` for a small mesh."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    elif axes is None:
        axes = ("pod", "data", "model")[-len(tuple(shape)):]
    _check_ranks(shape, math.prod(shape), world_size(), exact=True)
    return make_mesh(shape, axes)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes used for batch / data parallelism, pod-major."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def host_mesh(n: int = 1, model: int = 1) -> Mesh:
    """Small ``("data", "model")`` mesh over the first ``n * model`` ranks."""
    return make_device_mesh((n, model), ("data", "model"))
