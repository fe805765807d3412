"""The cell's weights, made by the benchmark from ``--seed`` on the device,
in the dtype they are served in, one draw a leaf (each per-layer leaf is
stacked over the layers, so a model is a dozen large draws).

The plain reference names the leaves and their shapes
(``weight_shapes``); both the program (through the reference's
``port_tree``) and the reference read these same tensors.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def vocab_rows(c: dict) -> int:
    """The embedding and head rows the program holds: the vocabulary padded
    to a multiple of the port's ``pad_vocab_to`` (256 unless the
    configuration says otherwise)."""
    pad = int(c["port"].get("pad_vocab_to", 256))
    return -(-int(c["vocab_size"]) // pad) * pad


def draw(ref, c: dict, seed: int, device, dtype=None) -> dict:
    """Every leaf of ``ref.weight_shapes`` drawn from one generator on
    ``device`` seeded with ``seed``, in sorted-name order.  A leaf with a
    float std is N(0, std^2); a ``"norm"`` leaf is 1 + N(0, 0.1^2)."""
    dtype = dtype or DTYPES[c["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    out = {}
    for name, (shape, std) in sorted(ref.weight_shapes(c, vocab_rows(c)).items()):
        x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if std == "norm":
            out[name] = x.mul_(0.1).add_(1.0)
        else:
            out[name] = x.mul_(float(std))
    return out
