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


def _rebuild(like, data: dict, path: tuple = ()):
    if isinstance(like, dict):
        return {k: _rebuild(v, data, path + (str(k),)) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), data, path + ("." + f,))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, data, path + (str(i),)) for i, v in enumerate(like))
    key = "/".join(path)
    if key not in data:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    arr = data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(like.shape)}")
    t = to_tensor(arr)
    return t.to(device=like.device, dtype=like.dtype) if isinstance(like, torch.Tensor) else t


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra_meta: dict | None = None):
        """Write ``tree`` as checkpoint ``step``.  The leaves are copied to
        the host here; the write runs in a background thread when
        ``async_save`` (one save in flight at a time)."""
        self.wait()
        flat = flatten(tree)
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
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------- load
    def all_steps(self) -> list[int]:
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
        new tensor of the like leaf's shape, dtype and device."""
        with np.load(os.path.join(self.dir, f"step_{step}", "arrays.npz")) as z:
            data = {k: z[k] for k in z.files}
        return _rebuild(like, data)

    def meta(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)
