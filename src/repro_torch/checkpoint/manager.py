"""Checkpoints: atomic, keep-N, async (port of ``repro.checkpoint.manager``,
in its on-disk format, so that either package's checkpoint restores in the
port).

Layout (per checkpoint):
    <dir>/step_<n>.tmp/...   -> atomic rename to <dir>/step_<n>/
        meta.json            (step and whatever the caller adds)
        arrays.npz           (every leaf, keyed by its "/"-joined tree path)

A path joins dict keys, list indices and, for a NamedTuple such as the
``TrainState`` or a ``QTensor`` moment, ``"." + field``: ``.step``,
``.params/stages/0/0/mixer/wq``, ``.mu/embed/.q`` -- the keys
``jax.tree_util`` gives the reference's trees.  A bf16 leaf is written as
the 2-byte records (numpy dtype ``|V2``) that JAX's bf16 arrays become in
an npz, and read back by viewing them as uint16 and then bfloat16.  (The
reference's own restore cannot cast them and raises: ROADMAP Queue 3.)

Over a mesh (``CheckpointManager(mesh=, specs=)``, ``specs`` a tree of
the saved tree's partition specs, e.g. ``training.step.state_pspecs``)
the checkpoint holds the *logical* tree in the same layout: every rank
gathers the shards (``launch.sharding.gather_whole``) and rank 0 writes.
A restore reads the logical tree and each rank keeps its slice, so a
checkpoint written on one mesh restores on another (or on one device).
Every rank passes a barrier after rank 0's write has committed and before
any rank lists or reads the directory.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

_V2 = np.dtype("V2")  # how ml_dtypes' bfloat16 is stored in an npz


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path: tuple = ()):
    """(path key, leaf) for every leaf of ``tree``, in the reference's key
    format."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif _is_namedtuple(tree):
        items = (("." + f, getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield "/".join(path), tree
        return
    for k, v in items:
        yield from _walk(v, path + (k,))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(_V2)
        return x.numpy()
    return np.asarray(x)


def to_tensor(arr) -> torch.Tensor:
    """A numpy leaf as a new CPU tensor.  bf16 -- ml_dtypes' bfloat16, or
    the 2-byte records it becomes in an npz -- is viewed as 16-bit integers
    and then as bfloat16 (numpy itself has no bfloat16)."""
    a = np.array(arr, order="C")  # a writable copy
    if a.dtype == _V2 or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def flatten(tree) -> dict[str, np.ndarray]:
    """Every leaf of ``tree`` as numpy, keyed as in ``arrays.npz``."""
    return {k: _to_numpy(v) for k, v in _walk(tree)}


def _leaf_specs(specs) -> dict:
    """{path key: partition spec} of a specs tree whose leaves are spec
    tuples (a ``QTensor`` of two specs counts as a node)."""
    out: dict = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (str(k),))
        elif _is_namedtuple(tree):
            for f in tree._fields:
                walk(getattr(tree, f), path + ("." + f,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = tuple(tree)
    walk(specs, ())
    return out


def _rebuild(like, data: dict, path: tuple = (), cut=None):
    if isinstance(like, dict):
        return {k: _rebuild(v, data, path + (str(k),), cut) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), data, path + ("." + f,), cut)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, data, path + (str(i),), cut)
                          for i, v in enumerate(like))
    key = "/".join(path)
    if key not in data:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    t = to_tensor(data[key])
    if cut is not None:
        t = cut(key, t)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} vs {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype) if isinstance(like, torch.Tensor) else t


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = True,
                 mesh=None, specs=None):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self.mesh = mesh if mesh is not None and mesh.size_total > 1 else None
        self.specs = _leaf_specs(specs) if self.mesh is not None else None
        self.writer = self.mesh is None or self.mesh.rank == self.mesh.peers(None)[0]
        if self.writer:
            os.makedirs(directory, exist_ok=True)
        self._sync()

    def _sync(self):
        if self.mesh is not None:
            self.mesh.barrier()

    def _whole(self, tree) -> dict[str, np.ndarray]:
        """The logical tree's leaves as numpy (every rank gathers; only the
        writer keeps them)."""
        from repro_torch.launch.sharding import gather_whole
        out = {}
        for k, v in _walk(tree):
            ps = self.specs.get(k, ())
            x = gather_whole(v, self.mesh, ps) if isinstance(v, torch.Tensor) and ps else v
            if self.writer:
                out[k] = _to_numpy(x)
        return out

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra_meta: dict | None = None):
        """Write ``tree`` as checkpoint ``step``.  The leaves are copied to
        the host here; the write runs in a background thread when
        ``async_save`` (one save in flight at a time).  Over a mesh every
        rank calls it: the shards are gathered and rank 0 writes."""
        self.wait()
        flat = flatten(tree) if self.mesh is None else self._whole(tree)
        if not self.writer:
            return
        meta = {"step": int(step), "time": time.time(), **(extra_meta or {})}

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        """Block until the save in flight has committed; over a mesh every
        rank then passes a barrier (rank 0 after its write)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._sync()

    def _gc(self):
        steps = self._steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------- load
    def all_steps(self) -> list[int]:
        self.wait()
        return self._steps()

    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Checkpoint ``step`` in the structure of ``like``: every leaf a
        new tensor of the like leaf's shape, dtype and device.  Over a mesh
        ``like`` is this rank's shard and each leaf this rank's slice of the
        logical one."""
        self.wait()
        with np.load(os.path.join(self.dir, f"step_{step}", "arrays.npz")) as z:
            data = {k: z[k] for k in z.files}
        cut = None
        if self.mesh is not None:
            from repro_torch.launch.sharding import local_slice

            def cut(key, t):
                ps = self.specs.get(key, ())
                return local_slice(t, self.mesh, ps) if ps else t
        return _rebuild(like, data, cut=cut)

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)
