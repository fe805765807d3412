"""Weight bridge: the JAX package's parameter tree, flattened, into the
port's parameters.

The flat form is the one ``repro.checkpoint`` writes to ``arrays.npz``:
``"/"``-joined tree paths (``"embed"``, ``"stages/0/0/mixer/wq"``,
``"lm_head"``) mapping to numpy arrays.  Both packages keep the same
stacked layout, so each leaf crosses as it is, cast to its spec's dtype
(the compute dtype unless the spec names one: a MoE router stays f32).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device
from repro_torch.models.model import param_specs
from repro_torch.models.params import is_spec


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(cfg: ArchConfig, flat: dict, device=None) -> dict:
    """Port parameters on ``device`` (default ``cuda``) from ``flat``.
    Raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    used = set()

    def walk(tree, path):
        if is_spec(tree):
            key = "/".join(path)
            if key not in flat:
                raise KeyError(f"weight {key!r} missing from the flat tree")
            t = _to_tensor(np.asarray(flat[key]))
            if tuple(t.shape) != tuple(tree.shape):
                raise ValueError(f"weight {key!r}: shape {tuple(t.shape)} != "
                                 f"{tuple(tree.shape)}")
            used.add(key)
            return t.to(device=dev, dtype=tree.dtype or cfg.compute_dtype).contiguous()
        if isinstance(tree, dict):
            return {k: walk(v, path + [k]) for k, v in tree.items()}
        return [walk(v, path + [str(i)]) for i, v in enumerate(tree)]

    params = walk(param_specs(cfg), [])
    extra = set(flat) - used
    if extra:
        raise KeyError(f"unexpected weights in the flat tree: {sorted(extra)}")
    return params
