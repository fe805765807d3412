"""Weight bridge: the JAX package's parameter tree (or its whole train
state), flattened, into the port's parameters (train state).

The flat form is the one ``repro.checkpoint`` writes to ``arrays.npz``:
``"/"``-joined tree paths (``"embed"``, ``"stages/0/0/mixer/wq"``,
``"lm_head"``) mapping to numpy arrays.  Both packages keep the same
stacked layout, so each leaf crosses as it is, cast to its spec's dtype
(the compute dtype unless the spec names one: a MoE router stays f32).
A train state flattens to ``.step``, ``.params/<path>``, ``.mu/<path>`` and
``.nu/<path>`` (int8 moments: ``.mu/<path>/.q`` and ``.mu/<path>/.scale``).
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.manager import to_tensor
from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device
from repro_torch.core.quant import QTensor
from repro_torch.models.model import param_specs
from repro_torch.models.params import is_spec
from repro_torch.training.step import TrainState


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
            t = to_tensor(flat[key])
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


def state_from_numpy(cfg: ArchConfig, opt, flat: dict, device=None):
    """A ``training.TrainState`` on ``device`` (default ``cuda``) from the
    reference's train state flattened as its checkpoint flattens it: step,
    parameters (as :func:`params_from_numpy`), and the moments as
    ``opt.moments_dtype`` encodes them (f32, bf16, or int8 ``QTensor``s
    with their f32 scales), every leaf as it is.  Raises on a missing or
    misshapen leaf."""
    dev = resolve_device(device)
    sub = {k[len(".params/"):]: v for k, v in flat.items() if k.startswith(".params/")}
    params = params_from_numpy(cfg, sub, dev)
    moment_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}.get(opt.moments_dtype)

    def leaf(key, shape=None, dtype=None):
        if key not in flat:
            raise KeyError(f"leaf {key!r} missing from the flat train state")
        t = to_tensor(flat[key])
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"leaf {key!r}: shape {tuple(t.shape)} != {tuple(shape)}")
        return t.to(device=dev, dtype=dtype).contiguous()

    def moments(name):
        def walk(tree, path):
            if is_spec(tree):
                key = f".{name}/" + "/".join(path)
                if moment_dtype is None:  # int8
                    return QTensor(leaf(key + "/.q", tree.shape, torch.int8),
                                   leaf(key + "/.scale", dtype=torch.float32))
                return leaf(key, tree.shape, moment_dtype)
            if isinstance(tree, dict):
                return {k: walk(v, path + [k]) for k, v in tree.items()}
            return [walk(v, path + [str(i)]) for i, v in enumerate(tree)]
        return walk(param_specs(cfg), [])

    step = leaf(".step", (), torch.int32)
    return TrainState(step, params, moments("mu"), moments("nu"))
