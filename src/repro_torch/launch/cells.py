"""Dry-run cells: (arch x shape x mesh) -> the step the card runs, on meta
arguments (port of ``repro.launch.cells``).

A *cell* is one entry of the assigned 10 x 4 grid on a mesh.
:func:`build_cell` returns the step function and its arguments as meta
tensors at this rank's local shapes: every parameter, moment, cache and
input leaf cut by its spec (``launch.sharding.local_shape`` of
``model.param_pspecs``, ``training.step.state_pspecs``, the cache and input
specs), never built whole and sharded, so kimi-k2's 1 T parameters stay
imaginary.  The steps are the port's own: ``make_train_step(mesh=)``
(handed this rank's rows, ``global_batch``), ``model.prefill`` and
``model.decode_step`` on slot caches, run on a ``launch.mesh.DryMesh``
under ``activation_mesh``; ``launch.dryrun`` counts them
(``launch.dry_costs``).  Serving cells hold their params as the port's
engine does (``serving.engine``: tensor-parallel, no FSDP cut); the
reference's serving cells cut them with ``cfg.fsdp`` as its train cells
do.  An encoder has no causal prefill in the port
(``model.forward_hidden`` refuses one; the reference's runs it causally):
its prefill cell is its inference forward, ``model.encode``.
:func:`prepare_arch` is also what the training launcher and the mesh
tests call before they build a state.  The port has no layer scan: its
layer loop is the reference's unrolled path.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.sharding import (activation_mesh, batch_entry, local_shape,
                                         profile_for, tree_pspecs)
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, is_spec
from repro_torch.training.optimizer import AdamWConfig, init_moments
from repro_torch.training.step import TrainState, make_train_step, mesh_config, state_pspecs


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


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The spec (shape, logical axes, dtype) of every model input of this
    cell: the reference's ``input_specs``, entry for entry."""
    B, S = shape.global_batch, shape.seq_len
    sp: dict = {}
    if shape.step == "decode":
        sp["tokens"] = ParamSpec((B, 1), ("batch", None), dtype=torch.int32)
    elif cfg.audio_frontend:
        sp["frames"] = ParamSpec((B, S, cfg.frontend_dim), ("batch", None, None),
                                 dtype=cfg.compute_dtype)
    else:
        sp["tokens"] = ParamSpec((B, S), ("batch", None), dtype=torch.int32)
    if shape.step == "train":
        sp["labels"] = ParamSpec((B, S), ("batch", None), dtype=torch.int32)
    if cfg.vision_tokens and shape.step != "decode":
        sp["images"] = ParamSpec((B, cfg.vision_tokens, cfg.vision_dim),
                                 ("batch", None, None), dtype=cfg.compute_dtype)
    return sp


class Cell(NamedTuple):
    fn: Any  # the step: fn(*args)
    args: tuple  # meta tensors at this rank's local shapes
    pspecs: tuple  # the partition spec of every argument leaf, in args' trees
    cfg: ArchConfig  # as the step runs it (prepare_arch, mesh_config)


def _meta(spec_tree, pspecs, mesh, dtype):
    """A meta tensor for every spec of ``spec_tree``, cut to this rank's
    share under its spec in ``pspecs`` (same tree)."""
    def one(spec, ps):
        return torch.empty(local_shape(spec, mesh, ps).shape, dtype=spec.dtype or dtype,
                           device="meta")
    return _zip_specs(one, spec_tree, pspecs)


def _zip_specs(fn, specs, other):
    if is_spec(specs):
        return fn(specs, other)
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, v, other[k]) for k, v in specs.items()}
    return [_zip_specs(fn, v, o) for v, o in zip(specs, other)]


def build_cell(cfg0: ArchConfig, shape: ShapeConfig, mesh, *,
               opt: AdamWConfig | None = None,
               main_repeats: int | None = None,
               attn_chunk: int = 0,
               accum_steps: int = 1,
               compress_pod: bool = False) -> Cell:
    """The cell of ``cfg0`` x ``shape`` on ``mesh`` (a ``DryMesh``):
    ``main_repeats`` cuts the main stage's depth, ``attn_chunk`` query-chunks
    the plain attention, ``accum_steps`` / ``compress_pod`` as the train
    step.  Arguments: train ``(state, batch)``, prefill ``(params, batch)``,
    decode ``(params, caches, tokens, pos)``.  A mesh of one rank is one
    device: the cell runs the single-device step, with no mesh, as the
    card's single-rank runs do.  A train cell's batch is this rank's rows
    (``global_batch``): the argument bytes are what a rank's device holds,
    and a meta global batch cut inside the step would keep its whole
    storage alive as the rows' view."""
    opt = opt or AdamWConfig()
    cfg = mesh_config(prepare_arch(cfg0, mesh), mesh)
    profile = profile_for(cfg)
    B, S = shape.global_batch, shape.seq_len
    bspecs = input_specs(cfg, shape)
    bps = tree_pspecs(bspecs, mesh, fsdp=False, profile=profile)
    batch = _meta(bspecs, bps, mesh, cfg.compute_dtype)
    fsdp = cfg.fsdp and shape.step == "train"  # serving: the engine's layout
    pspecs = M.param_pspecs(cfg, mesh, fsdp=fsdp, main_repeats=main_repeats)
    params = _meta(M.param_specs(cfg, main_repeats), pspecs, mesh, cfg.compute_dtype)

    one = mesh.size_total == 1
    if shape.step == "train":
        step = make_train_step(cfg, opt, attn_chunk=attn_chunk, accum_steps=accum_steps,
                               main_repeats=main_repeats, compress_pod=compress_pod,
                               mesh=None if one else mesh, global_batch=None if one else B)
        mu, nu = init_moments(params, opt)
        state = TrainState(torch.zeros((), dtype=torch.int32, device="meta"), params, mu, nu)
        return Cell(step, (state, batch), (state_pspecs(cfg, opt, mesh, main_repeats), bps),
                    cfg)

    # each rank holds its rows of the batch
    act = (None, None, ()) if one else (mesh, profile, batch_entry(mesh, B, profile))
    if shape.step == "prefill":
        def fn(params, batch):
            with activation_mesh(*act):
                if cfg.kind == "encoder":
                    return M.encode(cfg, params, batch["frames"], attn_chunk=attn_chunk,
                                    main_repeats=main_repeats)
                return M.prefill(cfg, params, batch["tokens"], images=batch.get("images"),
                                 attn_chunk=attn_chunk, main_repeats=main_repeats)
        return Cell(fn, (params, batch), (pspecs, bps), cfg)

    def fn(params, caches, tokens, pos):
        with activation_mesh(*act):
            return M.decode_step(cfg, params, caches, tokens, pos, main_repeats=main_repeats)
    cspecs = M.cache_specs(cfg, B, S, main_repeats)
    cps = tree_pspecs(cspecs, mesh, fsdp=False, profile=profile)
    caches = _meta(cspecs, cps, mesh, cfg.compute_dtype)
    pos = torch.zeros((), dtype=torch.int32, device="meta")
    return Cell(fn, (params, caches, batch["tokens"], pos), (pspecs, cps, bps["tokens"], ()),
                cfg)

