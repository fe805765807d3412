"""Meshes over ``torch.distributed`` ranks (port of ``repro.launch.mesh``),
and the collectives that training differentiates through.

A JAX mesh is an array of devices that one program spans; here it is an
array of *ranks*, one process each, every rank running the same code (the
reference's ``shard_map`` bodies, written once).  :class:`Mesh` holds the
grid of global ranks, this rank's coordinates on each named axis, and one
process group per axis line through it: ``("data", "model")`` gives a
model group (the ranks that share this rank's data index) and a data
group.  Its collectives are the reference's ``psum`` (an f32 all-reduce;
an int32 one, exact, for the row-parallel int8 GEMM's partial sums),
``pmax``, ``all_gather``, a reduce-scatter (the transpose of an FSDP
gather) and ``ppermute`` (``batch_isend_irecv`` to a ring neighbour), plus
the rank-0 broadcast the serving engine and the training runner take their
host decisions from.  A collective over several axes (an FSDP leaf cut
over ``("data", "model")``) runs one axis at a time, minor axis first for a
gather, major first for a reduce-scatter, which lays the shards out
major to minor as JAX does.

The mesh's collectives are in-place ``dist.*`` calls that autograd does
not see.  Training goes through four ``torch.autograd.Function``s over
them (:func:`enter_tp`, :func:`leave_tp`, :func:`fsdp_gather`,
:func:`mean_across`), each staging to the host inside its ``forward`` /
``backward`` on detached tensors: the Megatron pair around a tensor-
parallel region (identity forward and all-reduce backward on entry,
all-reduce forward and identity backward on exit), the ZeRO-3 parameter
gather (all-gather forward, reduce-scatter backward) and the mean of a
replicated statistic over the data ranks.  ``torch.distributed.nn``'s
all-reduce is not used: its backward is another sum, which multiplies the
gradient of a replicated loss by the axis size.

The backend is the caller's to name when the process group starts
(``launch.dist.init_process``): ``nccl`` across cards, ``gloo`` on the CPU
or for ranks that share one card (NCCL refuses two ranks on one device).
Under gloo a CUDA tensor is copied to the host for every collective and
back after it (:meth:`Mesh._host`): one rule, written here once.  The copy
is gloo's price on a card, not a choice made behind the caller's back.
:attr:`Mesh.collectives` and :attr:`Mesh.wire_bytes` count what the mesh
issued (bytes: the payload this rank hands each collective).  Each
collective builds its payload and counts it (:meth:`Mesh._count`) in one
method, and hands it to one small transport method (``_reduce``,
``_gather``, ``_scatter``, ``_bcast``, ``_hop``, ``_barrier``) that makes
the ``dist`` call.  :class:`DryMesh` is the same grid over no process
group, whose transports communicate nothing: the dry run
(``launch.dryrun``) drives the port's steps at pod scale on it and counts
exactly what a live mesh counts, each collective's kind, axis, group size
and payload recorded (:attr:`Mesh.records`).

Not ported: the reference's ``AxisType`` shims and ``jax.make_mesh``'s
device ordering (a rank list is the order).  Defined as functions and
classes only: importing this module touches no process group.
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
        self._grid(ranks, axes, this_rank(),
                   dist.get_backend() if dist.is_initialized() else None)
        if self.ranks.size == 1:
            return
        for ax, lines in self._axis_lines():
            for line in lines:
                g = dist.new_group(line)
                if self.rank in line:
                    self.groups[ax] = (g, line)
        everyone = [int(r) for r in self.ranks.reshape(-1)]
        g = (dist.group.WORLD if len(everyone) == world_size()
             else dist.new_group(everyone))
        if self.rank in everyone:
            self.groups[None] = (g, everyone)

    def _grid(self, ranks, axes: tuple, rank: int, backend):
        """The grid, this rank's place on it and empty counts (no group)."""
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axes)
        self.shape = OrderedDict(zip(self.axis_names, self.ranks.shape))
        self.rank = rank
        self.backend = backend
        where = np.argwhere(self.ranks == self.rank)
        self.coords = (dict(zip(self.axis_names, (int(i) for i in where[0])))
                       if len(where) else None)
        #: collectives this mesh has issued (the engine reads it per tick)
        self.collectives = 0
        #: bytes this rank handed to those collectives
        self.wire_bytes = 0
        #: (kind, axis, group size, payload bytes) of each collective, kept
        #: by a :class:`DryMesh` (None: not kept)
        self.records = None
        self.groups: dict = {}

    def _axis_lines(self):
        """(axis, every line of ranks along it) for each axis longer than 1."""
        for ax_i, ax in enumerate(self.axis_names):
            n = self.ranks.shape[ax_i]
            if n > 1:
                lines = np.moveaxis(self.ranks, ax_i, -1).reshape(-1, n)
                yield ax, [[int(r) for r in line] for line in lines]

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

    def _count(self, t, kind: str, axis):
        n = t.numel() * t.element_size()
        self.collectives += 1
        self.wire_bytes += n
        if self.records is not None:
            self.records.append((kind, axis, len(self.peers(axis)), n))

    # -- transports: the one ``dist`` call of each collective ---------------

    def _reduce(self, t, axis, op=dist.ReduceOp.SUM):
        dist.all_reduce(t, op=op, group=self.groups[axis][0])

    def _gather(self, parts, t, axis):
        dist.all_gather(parts, t, group=self.groups[axis][0])

    def _scatter(self, out, t, axis):
        dist.reduce_scatter_tensor(out, t, group=self.groups[axis][0])

    def _bcast(self, t, axis):
        g, line = self.groups[axis]
        dist.broadcast(t, src=line[0], group=g)

    def _hop(self, send, recv, axis, shift: int) -> list:
        g, line = self.groups[axis]
        n, i = len(line), line.index(self.rank)
        return dist.batch_isend_irecv([dist.P2POp(dist.isend, send, line[(i + shift) % n], g),
                                       dist.P2POp(dist.irecv, recv, line[(i - shift) % n], g)])

    def _barrier(self):
        dist.barrier(group=self.groups[None][0])

    def all_reduce(self, x, axis: str = "model"):
        """Sum of ``x`` over ``axis`` in f32, cast back to x's dtype: the
        reference's ``psum(o.astype(F32))``.  Identity on an axis of 1."""
        if axis not in self.groups:
            return x
        t = self._host(x.float().contiguous())
        self._count(t, "all-reduce", axis)
        self._reduce(t, axis)
        return t.to(device=x.device, dtype=x.dtype)

    def all_sum_int(self, x, axis: str = "model"):
        """Sum of the int32 tensor ``x`` over ``axis`` as int32, never cast:
        exact while the sum fits (the row-parallel int8 GEMM's accumulators,
        ``core.gemm.cgra_gemm_w8a8_row``; an f32 sum is not exact past
        2^24).  Identity on an axis of 1."""
        if x.dtype != torch.int32:
            raise TypeError(f"all_sum_int: {x.dtype}, not int32")
        if axis not in self.groups:
            return x
        t = self._host(x.contiguous())
        self._count(t, "all-reduce", axis)
        self._reduce(t, axis)
        return t.to(x.device)

    def all_max(self, x, axes):
        """Elementwise max of ``x`` over every axis of ``axes`` (a name or a
        tuple of names; the reference's ``pmax``), in x's dtype."""
        for axis in _axes(axes):
            if axis in self.groups:
                t = self._host(x.contiguous())
                self._count(t, "all-reduce", axis)
                self._reduce(t, axis, dist.ReduceOp.MAX)
                x = t.to(x.device)
        return x

    def all_gather(self, x, axis, dim: int = 0):
        """The shards of ``axis`` concatenated along ``dim`` in axis order
        (a tuple of axes: major to minor)."""
        for a in reversed(_axes(axis)):
            if a not in self.groups:
                continue
            t = self._host(x.contiguous())
            self._count(t, "all-gather", a)
            parts = [torch.empty_like(t) for _ in self.groups[a][1]]
            self._gather(parts, t, a)
            x = torch.cat(parts, dim).to(x.device)
        return x

    def reduce_scatter(self, x, axis, dim: int = 0):
        """This rank's shard along ``dim`` of the sum of ``x`` over ``axis``
        (a tuple of axes: major to minor), summed in f32 and cast back: the
        transpose of :meth:`all_gather`."""
        for a in _axes(axis):
            if a not in self.groups:
                continue
            t = self._host(x.float().movedim(dim, 0).contiguous())
            self._count(t, "reduce-scatter", a)
            out = t.new_empty((t.shape[0] // len(self.groups[a][1]), *t.shape[1:]))
            self._scatter(out, t, a)
            x = out.movedim(0, dim).to(device=x.device, dtype=x.dtype)
        return x

    def broadcast(self, x, axis: str | None = None):
        """The value of ``x`` on the first rank of ``axis`` (None: the first
        rank of the mesh), everywhere."""
        if axis not in self.groups:
            return x
        t = self._host(x.contiguous())
        self._count(t, "broadcast", axis)
        self._bcast(t, axis)
        return t.to(x.device)

    def barrier(self):
        """Every rank of the mesh waits for the others here."""
        if None in self.groups:
            self._barrier()

    def ring_shift(self, x, axis: str = "model", shift: int = 1) -> "RingHop":
        """Send ``x`` to the rank ``shift`` places on along ``axis``'s ring
        and receive the tensor of the rank ``shift`` places back, async (the
        reference's ``ppermute`` with ``_ring_perm``): returns a
        :class:`RingHop` whose :meth:`~RingHop.wait` gives the received
        tensor.  The caller runs its GEMM between the two."""
        send = self._host(x.contiguous())
        self._count(send, "collective-permute", axis)
        recv = torch.empty_like(send)
        return RingHop(self._hop(send, recv, axis, shift), recv, x.device, send)


class DryMesh(Mesh):
    """The grid of :class:`Mesh` (``shape`` over ``axes``, rank-major) as
    rank ``rank`` sees it, over no process group: the same ``coords``,
    ``size``, ``index`` and ``peers``, and transports that communicate
    nothing.  An all-reduce (sum, int sum, max) leaves its payload as it
    is, an all-gather concatenates ``n`` shards (left unset) along ``dim``,
    a reduce-scatter returns this rank's slice (left unset), a broadcast
    its input, and a ring hop's ``wait`` a tensor shaped like the one sent.
    Everything else is :class:`Mesh`'s own code, so :attr:`collectives` and
    :attr:`wire_bytes` are the live mesh's by construction, and
    :attr:`records` keeps each collective's (kind, axis, group size,
    payload bytes) for ``launch.roofline.collective_bytes``.  The dry run
    (``launch.dryrun``) drives the port on it with meta tensors."""

    def __init__(self, shape, axes, rank: int = 0):
        self._grid(np.arange(math.prod(shape)).reshape(tuple(shape)), axes, rank, None)
        self.records = []
        for ax, lines in self._axis_lines():
            self.groups[ax] = (None, next(line for line in lines if rank in line))
        if self.ranks.size > 1:
            self.groups[None] = (None, [int(r) for r in self.ranks.reshape(-1)])

    def _reduce(self, t, axis, op=None):
        pass

    def _gather(self, parts, t, axis):
        pass

    def _scatter(self, out, t, axis):
        pass

    def _bcast(self, t, axis):
        pass

    def _hop(self, send, recv, axis, shift: int) -> list:
        return []

    def _barrier(self):
        pass


def dry_production_mesh(multi_pod: bool = False) -> DryMesh:
    """The pod-scale mesh of :func:`make_production_mesh` as a
    :class:`DryMesh`: 16 x 16 ``("data", "model")`` (256 ranks), or with
    ``multi_pod`` 2 x 16 x 16 ``("pod", "data", "model")`` (512), rank 0."""
    if multi_pod:
        return DryMesh((2, 16, 16), ("pod", "data", "model"))
    return DryMesh((16, 16), ("data", "model"))


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


# -- collectives autograd differentiates through ---------------------------

class _EnterTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _LeaveTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim), None, None, None


class _MeanAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        n = 1
        for a in _axes(axes):
            x = mesh.all_reduce(x, a)
            n *= mesh.size(a)
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def enter_tp(x, mesh, axis: str = "model"):
    """``x`` (replicated over ``axis``) entering rank-specific compute:
    identity forward; backward, the partial gradients of the ranks summed
    over ``axis`` (f32), so that a replicated tensor's gradient is whole on
    every rank.  Placed before a column-parallel projection's input, on a
    replicated weight used on this rank's heads, and on a tensor a rank
    slices for itself.  ``x`` itself off a mesh or on an axis of 1."""
    if mesh is None or axis not in mesh.groups:
        return x
    return _EnterTP.apply(x, mesh, axis)


def leave_tp(x, mesh, axis: str = "model"):
    """Partial results of a tensor-parallel region summed over ``axis`` in
    f32 (the forward of a row-parallel projection); backward, the identity:
    the incoming gradient is already whole on every rank."""
    if mesh is None or axis not in mesh.groups:
        return x
    return _LeaveTP.apply(x, mesh, axis)


def fsdp_gather(x, mesh, axes, dim: int):
    """The whole of an FSDP-sharded parameter: its shards over ``axes``
    gathered along ``dim`` forward; backward, the gradient reduce-scattered
    back to this rank's shard (summed over ``axes`` in f32)."""
    if mesh is None or not any(a in mesh.groups for a in _axes(axes)):
        return x
    return _FSDPGather.apply(x, mesh, _axes(axes), dim)


def mean_across(x, mesh, axes):
    """The mean of ``x`` over the ranks of ``axes`` (a statistic each data
    rank computes over its own rows); backward, the identity.  A loss term
    built from it is replicated over ``axes``, and the train step averages
    the data ranks' gradients: the identity backward is what makes that
    average the gradient of the term (the derivative of the mean, ``1/n``,
    would count it ``n`` times too small)."""
    if mesh is None or not any(a in mesh.groups for a in _axes(axes)):
        return x
    return _MeanAcross.apply(x, mesh, _axes(axes))


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
