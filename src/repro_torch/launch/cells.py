"""Arch configs specialised for a mesh (port of ``repro.launch.cells``,
its :func:`prepare_arch` only).

Ported: :func:`prepare_arch`, which the training launcher and the mesh
tests call before they build a state.  Not ported: the rest of the
reference's module (``input_specs``, ``build_cell`` and the dry-run cells
over ``ShapeDtypeStruct`` arguments) and ``launch/dryrun.py``: their only
inputs and outputs are XLA compile artifacts (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig


def prepare_arch(cfg: ArchConfig, mesh) -> ArchConfig:
    """Specialise an arch config for ``mesh`` (anything with ``.shape``, a
    dict axis -> size): query heads padded to a multiple of the model axis
    for tensor-parallel divisibility, MoE dispatch groups = the data-
    parallel degree (``pod * data``).  When the padded heads no longer fold
    evenly onto the KV heads, the padding is dropped (GQA kept exact, the
    heads replicated).  Entry for entry the reference's."""
    tp = mesh.shape.get("model", 1)
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh.shape.get(a, 1)
    kw: dict = {"num_moe_groups": dp}
    if cfg.num_heads:
        kw["pad_heads_to"] = tp  # shard q-heads over the model axis
    new = cfg.with_(**kw)
    if (not new.use_mla) and new.num_heads and new.num_kv_heads \
            and new.padded_heads % new.num_kv_heads:
        new = new.with_(pad_heads_to=1)  # keep GQA grouping exact; replicate
    return new
