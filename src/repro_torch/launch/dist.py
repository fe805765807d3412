"""Starting and stopping the ranks of a mesh.

One process per mesh position, each calling :func:`init_process` with the
backend its caller names (``nccl`` across cards, ``gloo`` on the CPU or for
ranks that share one card) before it builds a mesh (``MeshSpec.build``).
Nothing here picks a backend: a mesh asked for without one is refused.
Nothing on the machine describes a cluster, so the rendezvous is given:
``tcp://localhost:<port>`` on a free port, the world size and the rank.

    from repro_torch.launch import dist as D
    D.spawn(fn, 2, "gloo", args=(...))   # fn(rank, *args) in 2 processes
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_backend(backend) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: name one of {BACKENDS} (nccl across "
                         f"cards; gloo on the CPU or for ranks that share one card)")
    return backend


def init_process(rank: int, world: int, backend: str, port: int,
                 timeout_s: float = 600.0) -> None:
    """Join the default process group as ``rank`` of ``world`` over
    ``backend`` at ``tcp://localhost:port``.  Under NCCL the rank's card is
    ``cuda:rank`` and is made current first, as NCCL requires."""
    check_backend(backend)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group (and free its groups) if one is started."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(rank: int, backend: str, device: str) -> torch.device:
    """The device rank ``rank`` serves on: ``cpu``, or for ``cuda`` its own
    card under NCCL and ``cuda:(rank % cards)`` under gloo (ranks may share
    a card there)."""
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if backend == "nccl" and rank >= n:
        raise ValueError(f"NCCL rank {rank} needs its own card; {n} present (NCCL "
                         f"refuses two ranks on one device: use gloo to share a card)")
    return torch.device("cuda", rank % max(n, 1))


def _entry(rank, fn, world, backend, port, args):
    init_process(rank, world, backend, port)
    try:
        fn(rank, *args)
        # no rank leaves the group while another still talks to it (a gloo
        # rank whose peer tore its pairs down first could abort at exit)
        dist.barrier()
    finally:
        shutdown()


def spawn(fn, world: int, backend: str, args: tuple = (), port: int | None = None):
    """Run ``fn(rank, *args)`` in ``world`` new processes, each joined to
    one process group over ``backend``; returns when all have exited and
    raises if any failed.  ``fn`` must be importable (a module-level
    function): the processes are started with ``spawn``."""
    import torch.multiprocessing as mp
    check_backend(backend)
    port = free_port() if port is None else port
    os.environ.setdefault("MASTER_ADDR", "localhost")
    mp.spawn(_entry, args=(fn, world, backend, port, args), nprocs=world, join=True)
