"""Config-driven model assembly (port of ``repro.models.model``): param
specs, w8a8 quantization, slot and paged caches, the training forward and
its loss (``loss_fn``: cross-entropy plus the MoE load-balancing aux),
``prefill`` -> ``decode_step``, and the engine's chunk / decode / mixed
steps.

Weights keep the JAX package's stacked layout — one leading layer axis per
stage — so the weight bridge is a plain reshape; the ``lax.scan`` over that
axis becomes a Python loop.  The ported mixers are attention (GQA, or MLA
when ``cfg.use_mla``), Mamba-2 SSD (``models.ssd``) and the VLM's cross
layer (self-attention, then a gated cross-attention over the image), each
with a dense, a capacity-routed MoE or no FFN.  An encoder (``kind=
"encoder"``, hubert) runs only the cache-free forward, bidirectionally: it
has no prefill or decode.  Caches are updated in place by the decode and
chunk steps.  A cache leaf with a ``kv_seq`` axis holds rows (paged as a
pool by the engine); one without (SSD state, a cross layer's image K/V) is
indexed by slot.

Under a mesh (``launch.sharding.activation_mesh``) every entry point runs
this rank's shard: params from :func:`shard_params`, pools from
``init_paged_cache(mesh=...)``; the embedding is a masked lookup in this
rank's vocab rows summed over the model group, the head's vocab shards are
gathered whole before any caller sees the logits, and a paged decode step
splits its batch over the data group (:func:`forward_hidden`).  The
training loss (:func:`loss_fn`) runs on this rank's rows of the batch: a
leaf sharded over FSDP axes (``shard_params(fsdp=True)``) is gathered when
its layer runs (``launch.mesh.fsdp_gather``, again under remat's
recompute), and the cross entropy is vocab-parallel: the max and the sum of
exponentials are joined over the vocab shards, never the logits.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core import resolve_device
from repro_torch.core.gemm import cgra_gemm
from repro_torch.core.quant import QTensor, quantize_over
from repro_torch.kernels.ops import CGRA_MATMUL
from repro_torch.launch.mesh import fsdp_gather, leave_tp
from repro_torch.launch.sharding import (activation_context, activation_mesh, current_mesh,
                                         fsdp_dims, local_shape, local_slice,
                                         profile_for, tree_pspecs)
from repro_torch.models import layers as L
from repro_torch.models import ssd as S
from repro_torch.models.params import (ParamSpec, init_params, is_spec, stack_tree,
                                       tree_map_specs)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _check_layer(spec: LayerSpec):
    if (spec.mixer not in ("attn_global", "attn_local", "ssm", "cross")
            or spec.ffn not in ("dense", "moe", "none")):
        raise NotImplementedError(
            f"layer {spec} is not ported yet (attention, SSD or cross mixers; "
            f"dense, MoE or no FFN)")


def _layer_param_specs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    _check_layer(spec)
    if spec.mixer == "ssm":
        mixer = S.ssd_specs(cfg)
    elif cfg.use_mla:
        mixer = L.mla_specs(cfg)
    elif spec.mixer == "cross":
        mixer = {"self": L.attn_specs(cfg), "cross": L.cross_attn_specs(cfg),
                 "norm_cross": L.norm_specs(cfg)}
    else:
        mixer = L.attn_specs(cfg)
    d = {"norm1": L.norm_specs(cfg), "mixer": mixer}
    if spec.ffn != "none":
        d["norm2"] = L.norm_specs(cfg)
        d["ffn"] = L.moe_specs(cfg) if spec.ffn == "moe" else L.ffn_specs(cfg)
    return d


def param_specs(cfg: ArchConfig, main_repeats: int | None = None) -> dict:
    """The parameter spec tree; ``main_repeats`` cuts the main stage's
    depth (``ArchConfig.stages``)."""
    D, Vp = cfg.d_model, cfg.padded_vocab
    tree: dict = {"embed": ParamSpec((Vp, D), ("vocab", "embed"), "normal")}
    if cfg.audio_frontend:
        tree["frontend_proj"] = ParamSpec((cfg.frontend_dim, D), ("frontend", "embed"))
    if cfg.vision_tokens:
        tree["vision_proj"] = ParamSpec((cfg.vision_dim, D), ("frontend", "embed"))
    tree["stages"] = [
        stack_tree({str(i): _layer_param_specs(cfg, sp)
                    for i, sp in enumerate(stage.group)}, stage.repeats)
        for stage in cfg.stages(main_repeats)]
    tree["final_norm"] = L.norm_specs(cfg)
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((D, Vp), ("embed", "vocab"), "normal")
    return tree


def init(cfg: ArchConfig, seed: int = 0, device=None, main_repeats: int | None = None) -> dict:
    """Random weights from the JAX package's init rules, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``) and stored in
    the compute dtype (``param_specs(cfg, main_repeats)``'s tree)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(param_specs(cfg, main_repeats), gen, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# w8a8 weight quantization (one-time, at load)
# ---------------------------------------------------------------------------

# every weight consumed by ``layers.dense_proj``; norm scales, biases, the
# cross-attention gate, the embedding table, the frontend and vision
# projections (plain matmuls in the reference too) and a MoE FFN's router
# and experts (batched matmuls, not ``dense_proj``) stay float
_QUANT_NAMES = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                          "w1", "w2", "wq_a", "wkv_a", "lm_head"})


def _n_red(name: str, ndim: int, lead: int) -> int:
    """How many leading dims (after ``lead`` stacked ones) of a float GEMM
    weight of ``ndim`` dims are its contraction: ``wo`` [*, H, dh, D]
    contracts (H, dh), every other weight its first dim."""
    return ndim - lead - 1 if name == "wo" else 1


def _pack(qt: QTensor, lead: int, n_red: int) -> QTensor:
    """JAX layout [*lead, *contraction, *out] -> the int8 kernel's layout:
    q [*lead, N, K] contiguous (K contiguous), scale [*lead, 1, N]."""
    lead_shape = tuple(qt.q.shape[:lead])
    K = math.prod(qt.q.shape[lead:lead + n_red])
    N = math.prod(qt.q.shape[lead + n_red:])
    q = qt.q.reshape(*lead_shape, K, N).transpose(-1, -2).contiguous()
    return QTensor(q, qt.scale.reshape(*lead_shape, 1, N))


def quantize_params(cfg: ArchConfig, params: dict) -> dict:
    """Quantize every GEMM weight to int8 once at load: the w8a8 path.  The
    model dispatches on the ``QTensor`` weights this returns (the engine
    calls it at init under ``EngineConfig(quant="w8a8")``).

    Each ``dense_proj`` weight becomes a ``QTensor`` holding the JAX
    package's int8 values and per-output-channel f32 scales, packed for the
    int8 kernel: q [R, N, K] (stacked layers; the transpose of the JAX
    [K, N] operand) and scale [R, 1, N].  A tied head gets its own int8
    copy ``lm_head_q`` (q [Vp, D] — the embedding table's own layout); the
    embedding stays float for the gather.  A MoE FFN (a dict holding
    ``"router"``) passes through as the same tensors, not copies.
    Idempotent.  Inference only."""
    def walk(tree):
        if "router" in tree:
            return tree
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                out[name] = walk(v)
            elif (name in _QUANT_NAMES and not isinstance(v, QTensor)
                  and v.dim() >= 2):
                n = _n_red(name, v.dim(), 1)
                out[name] = _pack(quantize_over(v, tuple(range(1, 1 + n))), 1, n)
            else:
                out[name] = v
        return out

    new = dict(params)
    new["stages"] = [walk(st) for st in params["stages"]]
    if "lm_head" in params and not isinstance(params["lm_head"], QTensor):
        new["lm_head"] = _pack(quantize_over(params["lm_head"], (0,)), 0, 1)
    if cfg.tie_embeddings and "lm_head_q" not in params:
        # per vocab row of embed [Vp, D] == per column of JAX's embed.T
        qt = quantize_over(params["embed"], (1,))
        new["lm_head_q"] = QTensor(qt.q, qt.scale.reshape(1, -1))
    return new


def param_pspecs(cfg: ArchConfig, mesh, *, fsdp: bool = False,
                 main_repeats: int | None = None) -> dict:
    """The spec of every leaf a rank holds after :func:`shard_params`, in
    ``param_specs(cfg, main_repeats)``'s tree: ``resolve_pspec`` under the
    config's profile (``launch.sharding.profile_for``), with ``fsdp``; a MoE
    layer's ``router`` whole (see :func:`shard_params`)."""
    profile = profile_for(cfg)
    ps = tree_pspecs(param_specs(cfg, main_repeats), mesh, fsdp=fsdp, profile=profile)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: ((None,) * len(v) if k == "router" else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(ps)


def _slice_qtensor(qt: QTensor, shape: tuple, pspec: tuple, lead: int, n_red: int,
                   mesh) -> QTensor:
    """This rank's slice of a packed w8a8 weight (q [*lead, N, K], scale
    [*lead, 1, N]) under ``pspec``, the spec of its float leaf of ``shape``
    [*lead, *contraction (n_red dims), *out]: q is viewed in those dims
    (out before contraction), cut as the float leaf would be and packed
    again.  A cut output dim takes the same columns of the scale; a cut
    contraction dim keeps the whole scale, which a column's max over the
    whole K gave (the weight is quantized before it is sliced)."""
    lead_shape, red, out = shape[:lead], shape[lead:lead + n_red], shape[lead + n_red:]
    ps_lead, ps_red, ps_out = pspec[:lead], pspec[lead:lead + n_red], pspec[lead + n_red:]
    q = local_slice(qt.q.reshape(*lead_shape, *out, *red), mesh, ps_lead + ps_out + ps_red)
    scale = local_slice(qt.scale.reshape(*lead_shape, 1, *out), mesh,
                        ps_lead + (None,) + ps_out)
    lead_l = q.shape[:lead]
    N = math.prod(q.shape[lead:lead + len(out)])
    return QTensor(q.reshape(*lead_l, N, -1), scale.reshape(*lead_l, 1, N))


def shard_params(cfg: ArchConfig, params: dict, mesh, *, fsdp: bool = False,
                 main_repeats: int | None = None) -> dict:
    """This rank's slice of ``params`` on ``mesh``: each leaf cut along the
    dimensions ``launch.sharding.resolve_pspec`` gives its spec under the
    config's profile (heads / kv_heads / ffn / vocab / experts over
    ``model`` in ``"2d"``, the divisibility fallback intact; with ``fsdp``
    one more dim over the FSDP axes, ZeRO-3), as a tensor of its own, so the
    whole tree can be freed after (:func:`param_pspecs`; ``main_repeats``
    for a tree made at that depth).  A ``QTensor`` leaf (w8a8, packed by
    :func:`quantize_params`) is cut by its float leaf's spec
    (:func:`_slice_qtensor`): a column split takes its columns and their
    scales, a row split its slice of K and the whole scales; a tied head's
    ``lm_head_q`` (q [Vp, D], scale [1, Vp]) takes the embedding's vocab
    rows.  Quantize first, then shard: a weight's per-column scale spans
    the whole K, so a slice quantized alone would get other scales.  One
    leaf stays whole here: a MoE layer's ``router``, whose logits every
    rank needs whole to route (the reference's partitioner gathers them;
    the port has none)."""
    specs = param_pspecs(cfg, mesh, fsdp=fsdp, main_repeats=main_repeats)
    shapes = param_specs(cfg, main_repeats)

    def walk(spec, val, shape, name, lead):
        if isinstance(spec, tuple):
            if not isinstance(val, QTensor):
                return local_slice(val, mesh, spec)
            return _slice_qtensor(val, shape.shape, spec, lead,
                                  _n_red(name, len(shape.shape), lead), mesh)
        if isinstance(spec, dict):
            return {k: (walk(spec[k], v, shape[k], k, lead) if k in spec else v)
                    for k, v in val.items()}
        return [walk(sp, v, sh, name, 1) for sp, v, sh in zip(spec, val, shape)]

    out = walk(specs, params, shapes, None, 0)
    if "lm_head_q" in params:  # the embedding's layout [Vp, D]: its spec
        qt, ps = params["lm_head_q"], specs["embed"]
        out["lm_head_q"] = QTensor(local_slice(qt.q, mesh, ps),
                                   local_slice(qt.scale, mesh, (None, ps[0])))
    return out


def fsdp_plan(cfg: ArchConfig, params: dict, mesh, main_repeats: int | None = None):
    """For every leaf of ``params`` (this rank's tree), the (dim, axes) of
    each FSDP shard it holds -- a dim its spec with FSDP cuts over FSDP
    axes and that is shorter here than the whole -- in the params' tree;
    None when no leaf is FSDP-sharded."""
    profile = profile_for(cfg)
    specs = param_specs(cfg, main_repeats)
    pss = tree_pspecs(specs, mesh, fsdp=True, profile=profile)
    found = False

    def walk(spec, ps, val):
        nonlocal found
        if is_spec(spec):
            dims = [(d, ax) for d, ax in fsdp_dims(ps, profile)
                    if not isinstance(val, QTensor) and val.shape[d] < spec.shape[d]]
            found = found or bool(dims)
            return dims
        if isinstance(spec, dict):
            return {k: walk(spec[k], ps[k], v) for k, v in val.items() if k in spec}
        return [walk(a, b, v) for a, b, v in zip(spec, ps, val)]

    plan = walk(specs, pss, params)
    return plan if found else None


def fsdp_gathered(tree, plan, mesh, skip: int = 0):
    """``tree`` with every leaf's FSDP shards gathered whole
    (``launch.mesh.fsdp_gather``: all-gather forward, reduce-scatter
    backward); ``skip`` leading dims of the plan's are gone from the leaves
    (1 for one layer of a stacked tree)."""
    if isinstance(tree, dict):
        return {k: (fsdp_gathered(v, plan[k], mesh, skip) if k in plan else v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [fsdp_gathered(v, p, mesh, skip) for v, p in zip(tree, plan)]
    for d, axes in plan:
        tree = fsdp_gather(tree, mesh, axes, d - skip)
    return tree


def _stack_dim_gathered(tree, plan, mesh):
    """(tree, plan) with the leaves FSDP-sharded on their stacked layer
    axis gathered whole (a layer's weights cannot be gathered layer by
    layer then) and the plan left for the others."""
    if isinstance(tree, dict):
        pairs = {k: _stack_dim_gathered(v, plan[k], mesh) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()}, {k: b for k, (_, b) in pairs.items()})
    for d, axes in plan:
        if d == 0:
            tree = fsdp_gather(tree, mesh, axes, 0)
    return tree, [(d, a) for d, a in plan if d != 0]


# ---------------------------------------------------------------------------
# Slot caches (the direct prefill -> decode_step loop)
# ---------------------------------------------------------------------------

def _layer_cache_specs(cfg: ArchConfig, spec: LayerSpec, batch: int,
                       seq: int, local: bool) -> dict:
    _check_layer(spec)
    if spec.mixer == "ssm":
        return S.ssd_cache_specs(cfg, batch)
    if cfg.use_mla:
        return L.mla_cache_specs(cfg, batch, seq)
    c = L.attn_cache_specs(cfg, batch, seq, local=local)
    if spec.mixer == "cross":  # the image's K/V: slot state, no kv_seq axis
        img = ParamSpec((batch, cfg.vision_tokens, cfg.num_kv_heads, cfg.head_dim),
                        ("batch", None, "kv_heads", "qk"), "zeros")
        c.update(ck=img, cv=img)
    return c


def cache_specs(cfg: ArchConfig, batch: int, seq: int,
                main_repeats: int | None = None) -> list:
    """Per-stage slot-cache specs: global layers k/v [R, batch, seq, K, dh]
    (linear), sliding-window layers a ring of ``min(seq, window)`` rows, MLA
    layers one fused kv [R, batch, seq, kvr + dr], SSD layers their state
    (``ssd.ssd_cache_specs``, no ``kv_seq`` axis), cross layers k/v and the
    image's ck/cv [R, batch, vision_tokens, K, dh] (no ``kv_seq`` axis).
    ``main_repeats`` as :func:`param_specs`."""
    out = []
    for stage in cfg.stages(main_repeats):
        group = {str(i): _layer_cache_specs(cfg, sp, batch, seq,
                                            local=sp.mixer == "attn_local")
                 for i, sp in enumerate(stage.group)}
        out.append(stack_tree(group, stage.repeats))
    return out


def init_cache(cfg: ArchConfig, batch: int, seq: int, device=None,
               main_repeats: int | None = None) -> list:
    dev = resolve_device(device)
    return tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.dtype or cfg.compute_dtype,
                              device=dev),
        cache_specs(cfg, batch, seq, main_repeats))


def cache_leaves(specs: list, *trees):
    """Yield ``(spec, leaf, ...)`` for every leaf of ``specs`` (a stacked
    cache spec tree) and the same leaf of each of ``trees``: slot caches,
    page pools and a prefill's new rows share one structure.  ``"kv_seq" in
    spec.axes`` tells a row leaf from a slot-indexed state leaf."""
    for si, stage in enumerate(specs):
        for gi, group in stage.items():
            for name, spec in group.items():
                yield (spec, *(t[si][gi][name] for t in trees))


def pad_cache_len(cfg: ArchConfig, caches: list, new_len: int) -> list:
    """Zero-pad every ``kv_seq`` axis up to its ``new_len`` capacity (a ring
    up to ``min(new_len, window)``), so that a prefill's caches can be
    decoded into directly; state leaves are returned as they are."""
    specs = cache_specs(cfg, 1, new_len)

    def grow(spec, leaf):
        if "kv_seq" not in spec.axes:
            return leaf
        ax = spec.axes.index("kv_seq")
        pad = spec.shape[ax] - leaf.shape[ax]
        if pad <= 0:
            return leaf
        shape = list(leaf.shape)
        shape[ax] = pad
        return torch.cat([leaf, leaf.new_zeros(shape)], ax)

    return [{gi: {name: grow(spec, caches[si][gi][name]) for name, spec in group.items()}
             for gi, group in stage.items()} for si, stage in enumerate(specs)]


# ---------------------------------------------------------------------------
# Paged caches
# ---------------------------------------------------------------------------

def paged_cache_specs(cfg: ArchConfig, max_batch: int, n_pages: int,
                      page_size: int, mesh=None) -> list:
    """Per-stage paged cache specs: every ``kv_seq`` leaf becomes a pool
    shared across sequences — an attention layer's k/v ``[R, n_pages,
    page_size, K, dh]`` (R = the stage's stacked layers; sliding-window
    layers keep every row), an MLA layer's kv ``[R, n_pages, page_size,
    kvr + dr]``; page 0 is the engine's trash page.  Leaves without a
    ``kv_seq`` axis (SSD state) stay slot-indexed ``[R, max_batch, ...]``.
    With ``mesh``, each leaf's shape is this rank's share (``kv_heads``
    over the model axis, as the reference places the pools)."""
    def to_pool(spec):
        if "kv_seq" not in spec.axes:
            return spec
        b = spec.axes.index("batch")
        shape, axes = list(spec.shape), list(spec.axes)
        shape[b], axes[b] = n_pages, None  # the pool's page axis is no batch axis
        return ParamSpec(tuple(shape), tuple(axes), "zeros", spec.dtype)

    out = []
    for stage in cfg.stages():
        group = {str(i): _layer_cache_specs(cfg, sp, max_batch, page_size, local=False)
                 for i, sp in enumerate(stage.group)}
        out.append(stack_tree(group, stage.repeats))
    out = tree_map_specs(to_pool, out)
    return out if mesh is None else tree_map_specs(lambda s: local_shape(s, mesh), out)


def _pool(spec: ParamSpec, dtype, device):
    """Zeroed pool [R, P, ps, ...] whose every layer slice has one spare
    drop row after its last page (see ``layers._rows_with_drop``)."""
    R, P, ps, *rest = spec.shape
    base = torch.zeros((R, P * ps + 1, *rest), dtype=spec.dtype or dtype,
                       device=device)
    row = base.stride(1)
    return base.as_strided((R, P, ps, *rest),
                           (base.stride(0), ps * row, row, *base.stride()[2:]))


def init_paged_cache(cfg: ArchConfig, max_batch: int, n_pages: int,
                     page_size: int, device=None, mesh=None) -> list:
    dev = resolve_device(device)

    def make(s):
        if "kv_seq" in s.axes:
            return _pool(s, cfg.compute_dtype, dev)
        return torch.zeros(s.shape, dtype=s.dtype or cfg.compute_dtype, device=dev)

    return tree_map_specs(make, paged_cache_specs(cfg, max_batch, n_pages, page_size, mesh))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _unstack(tree, R: int) -> list:
    """The first R layers of a stacked tree (parameters or caches), each
    leaf unbound once along its layer axis (views, no copies, so a cache's
    in-place writes reach the stack).  Under autograd one ``unbind`` a leaf
    stacks the layers' gradients once, where indexing each layer would
    scatter every layer's gradient into a zero tensor of the whole stack."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, R) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(R)]
    if isinstance(tree, QTensor):
        return [QTensor(q, s) for q, s in zip(tree.q.unbind(0)[:R], tree.scale.unbind(0))]
    return list(tree.unbind(0)[:R])


def _stack_layers(per_layer: list) -> dict:
    """[{gi: {name: leaf}} per repeat] -> {gi: {name: [R, ...]}}."""
    return {gi: {n: torch.stack([c[gi][n] for c in per_layer])
                 for n in per_layer[0][gi]} for gi in per_layer[0]}


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, p: dict, x, *, mode: str,
                 cache, rows: L.StepRows, img=None, full_kv: bool = False,
                 attn_chunk: int = 0):
    """Returns (x, cache, aux).  decode / chunk: ``cache`` is the layer's
    slot cache or page pools, updated in place.  prefill: ``cache`` is the
    layer's past KV or None, and the returned cache holds the new rows
    (``full_kv``: a sliding-window layer's every row, linear).  train: no
    cache; ``aux`` is a MoE layer's load-balancing loss (``layers.moe_aux``),
    None for other layers and in the other modes (serving does not compute
    it).  ``rows`` holds the step's shared positions, tables and bounds;
    ``img`` the projected image [B,T,D] (prefill and train of a cross
    model).  MLA, SSD and cross layers have no chunk step (the fused
    latent cache, the SSD state and the image K/V are not
    prefix-decomposable: the engine prefills MLA and SSD whole) and no
    cached-prefix prefill.  A layer with ``ffn="none"`` (mamba2) is its
    mixer and residual alone.  ``attn_chunk`` query-chunks the plain
    self-attention of the train and prefill modes (``layers.plain_attention``)."""
    _check_layer(spec)
    local = spec.mixer == "attn_local"
    h = L.apply_norm(cfg, p["norm1"], x)
    if spec.mixer == "ssm":
        m, cache = _apply_ssd(cfg, p["mixer"], h, mode=mode, cache=cache)
    elif spec.mixer == "cross":
        x, m, cache = _apply_cross(cfg, p["mixer"], x, h, mode=mode, cache=cache,
                                   rows=rows, img=img, attn_chunk=attn_chunk)
    elif cfg.use_mla:
        m, cache = _apply_mla(cfg, p["mixer"], h, mode=mode, cache=cache, rows=rows,
                              attn_chunk=attn_chunk)
    elif mode == "decode":
        m, cache = L.attn_decode(cfg, p["mixer"], cache, h, rows, local=local)
    elif mode == "chunk":
        m, cache = L.attn_chunk_prefill(cfg, p["mixer"], cache, h, rows,
                                        local=local)
    elif mode == "prefill":
        m, cache = L.attn_prefill(cfg, p["mixer"], h, rows, local=local,
                                  past_kv=cache, full_kv=full_kv, attn_chunk=attn_chunk)
    elif mode == "train":
        m = L.attn_forward(cfg, p["mixer"], h, rows, local=local, attn_chunk=attn_chunk)[0]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + m
    if spec.ffn == "none":
        return x, cache, None
    h = L.apply_norm(cfg, p["norm2"], x)
    aux = None
    if spec.ffn == "moe":
        f, route = _moe_whole_batch(cfg, p["ffn"], h, rows)
        if mode == "train":
            aux = L.moe_aux(cfg, route)
    else:
        f = L.ffn_forward(cfg, p["ffn"], h)
    return x + f, cache, aux


def _moe_whole_batch(cfg: ArchConfig, p: dict, h, rows: L.StepRows):
    """``layers.moe_forward`` of a step's rows.  A data shard of a decode
    batch gathers the whole batch first and keeps its own rows of the
    output: capacity is shared by every row of a call, so the route must
    see them all, as on one device."""
    if rows.full is None:
        return L.moe_forward(cfg, p, h)
    mesh = current_mesh()
    n, i = h.shape[0], mesh.index("data")
    f, route = L.moe_forward(cfg, p, mesh.all_gather(h, "data", 0))
    return f[i * n:(i + 1) * n], route


def _apply_ssd(cfg: ArchConfig, p: dict, h, *, mode: str, cache):
    """The SSD mixer of :func:`_apply_layer`: returns (out, cache)."""
    if mode == "decode":
        return S.ssd_decode(cfg, p, cache, h)
    if mode == "prefill":
        if cache is not None:
            raise NotImplementedError("SSD prefill does not continue a cached prefix")
        return S.ssd_forward(cfg, p, h, return_cache=True)
    if mode == "train":
        return S.ssd_forward(cfg, p, h), None
    if mode == "chunk":
        raise NotImplementedError("chunked prefill requires a prefix-decomposable "
                                  "mixer; SSM state is not")
    raise ValueError(f"unknown mode {mode!r}")


def _apply_cross(cfg: ArchConfig, p: dict, x, h, *, mode: str, cache,
                 rows: L.StepRows, img, attn_chunk: int = 0):
    """The cross layer of :func:`_apply_layer` (the reference's ``mixer ==
    "cross"`` branch): causal self-attention and its residual, then
    ``norm_cross`` and the gated cross-attention over the image, whose
    output the caller adds.  Prefill returns the image's K/V as ``ck`` /
    ``cv`` beside the self k/v; decode reads them and returns the same
    tensors.  Returns (x, cross out, cache)."""
    if mode == "decode":
        m, sc = L.attn_decode(cfg, p["self"], {"k": cache["k"], "v": cache["v"]}, h, rows,
                              local=False)
        img_kv = (cache["ck"], cache["cv"])
    elif mode == "prefill":
        if cache is not None:
            raise NotImplementedError("cross-attention prefill does not continue a "
                                      "cached prefix")
        m, sc = L.attn_prefill(cfg, p["self"], h, rows, local=False, attn_chunk=attn_chunk)
        img_kv = None
    elif mode == "train":
        m = L.attn_forward(cfg, p["self"], h, rows, local=False, attn_chunk=attn_chunk)[0]
        sc = img_kv = None
    elif mode == "chunk":
        raise NotImplementedError("chunked prefill does not support cross-attention "
                                  "image KV")
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + m
    hc = L.apply_norm(cfg, p["norm_cross"], x)
    mc, (ck, cv) = L.cross_attn(cfg, p["cross"], hc, img, img_kv)
    return x, mc, (None if sc is None else dict(sc, ck=ck, cv=cv))


def _apply_mla(cfg: ArchConfig, p: dict, h, *, mode: str, cache, rows: L.StepRows,
               attn_chunk: int = 0):
    """The MLA mixer of :func:`_apply_layer`: returns (out, cache)."""
    if mode == "decode":
        return L.mla_decode(cfg, p, cache, h, rows)
    if mode == "prefill":
        if cache is not None:
            raise NotImplementedError("MLA prefill does not continue a cached prefix")
        return L.mla_prefill(cfg, p, h, rows, attn_chunk)
    if mode == "train":
        return L.mla_forward(cfg, p, h, rows, attn_chunk), None
    if mode == "chunk":
        raise NotImplementedError("chunked prefill over the paged past "
                                  "does not support MLA's fused cache")
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, params, tokens):
    """Token rows of the embedding table.  A rank holding a vocab shard
    (fewer rows than ``padded_vocab``) looks up its own rows, zeros the
    others and sums over the model group: one nonzero term a row, so the
    sum is exact."""
    emb, t = params["embed"], tokens.long()
    if emb.shape[0] == cfg.padded_vocab:
        x = emb[t].to(cfg.compute_dtype)
    else:
        mesh = current_mesh()
        local = t - mesh.index("model") * emb.shape[0]
        ok = ((local >= 0) & (local < emb.shape[0]))[..., None]
        x = torch.where(ok, emb[torch.where(ok[..., 0], local, 0)], 0).to(cfg.compute_dtype)
        x = leave_tp(x, mesh)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    return x


def _project(cfg: ArchConfig, x, w):
    """x [B, T, F] @ w [F, D] summed in f32 and cast once to the compute
    dtype: the reference's ``preferred_element_type=F32`` einsum, a plain
    matmul there as here (no ``dense_proj``, no kernel)."""
    return torch.matmul(x.to(cfg.compute_dtype).float(),
                        w.to(cfg.compute_dtype).float()).to(cfg.compute_dtype)


def embed_inputs(cfg: ArchConfig, params, tokens=None, frames=None):
    """The stack's input rows: the audio encoder's frame embeddings [B, T,
    frontend_dim] through ``frontend_proj``, or the token embeddings."""
    if cfg.audio_frontend:
        if frames is None:
            raise ValueError(f"{cfg.name} reads frame embeddings: pass frames=[B, T, "
                             f"{cfg.frontend_dim}]")
        return _project(cfg, frames, params["frontend_proj"])
    if tokens is None:
        raise ValueError(f"{cfg.name} reads tokens")
    return embed_tokens(cfg, params, tokens)


def project_images(cfg: ArchConfig, params, images):
    """Patch embeddings [B, vision_tokens, vision_dim] through
    ``vision_proj`` to [B, T, D]; None without images or a vision stub."""
    if not cfg.vision_tokens or images is None:
        return None
    return _project(cfg, images, params["vision_proj"])


def head_logits(cfg: ArchConfig, params, hidden):
    """f32 logits of this rank's vocab shard (all of them off a mesh): the
    head of :func:`lm_logits` before its gather."""
    if cfg.tie_embeddings:
        if "lm_head_q" in params:
            return L.dense_proj(cfg, hidden, params["lm_head_q"], out_dtype=F32,
                                shard=("col", cfg.padded_vocab))
        emb = params["embed"]
        if emb.shape[0] != cfg.padded_vocab:  # a vocab shard: enter the region
            hidden = L.tp_input(hidden, emb, ("col", cfg.padded_vocab))
        return cgra_gemm(hidden, emb, out_dtype=F32, trans_b=True)
    return L.dense_proj(cfg, hidden, params["lm_head"], out_dtype=F32,
                        shard=("col", cfg.padded_vocab))


def lm_logits(cfg: ArchConfig, params, hidden):
    """f32 logits straight from the GEMM's f32 accumulator.  A tied head
    reads the [Vp, D] embedding table in place as the GEMM's [N, K] operand
    (no per-call transpose), or its int8 copy ``lm_head_q`` under w8a8.
    Under a mesh the head is vocab-parallel (``shard=("col",
    padded_vocab)``, the reference's): each rank computes its vocab shard
    and the shards are gathered over the model group, so every rank holds
    the whole row for its sampler."""
    logits = head_logits(cfg, params, hidden)
    if logits.shape[-1] != cfg.padded_vocab:
        logits = current_mesh().all_gather(logits, "model", dim=-1)
    return logits


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _rows(x, B: int, device) -> torch.Tensor:
    """[B] int32 on ``device`` from an int or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(B).contiguous()
    return torch.full((B,), int(x), dtype=torch.int32, device=device)


REMAT_POLICIES = ("none", "dots_nb", "dots", "full")


def _remat(policy: str):
    """The activation rematerialisation of a training step's layer group:
    the port's reading of the reference's ``_remat`` (``repro/models/
    model.py:359-371``), as ``torch.utils.checkpoint.checkpoint(...,
    use_reentrant=False)`` around each group of the layer loop, or None.

    - ``none``: no checkpoint; autograd keeps every activation.
    - ``full`` (``jax.checkpoint`` with no policy): the group keeps its
      input only, and its forward runs again in the backward pass, so a
      GEMM of the group launches 4 times a step instead of 3.
    - ``dots_nb`` (``checkpoint_dots_with_no_batch_dims``): the outputs of
      every weight GEMM (the registered :data:`~repro_torch.kernels.ops.
      CGRA_MATMUL`) are saved, the rest is recomputed; the GEMMs do not run
      again.
    - ``dots`` (``checkpoint_dots``): those plus every batched product
      (``aten.bmm``): the plain attention's scores and P·V (and a MoE
      layer's experts, an SSD layer's chunk products).

    Non-reentrant only: a reentrant checkpoint runs its first forward
    without grad, where the GEMM and attention would take their inference
    routes and the gradient would not be that of the loss."""
    if policy == "none":
        return None
    if policy == "full":
        ctx = noop_context_fn
    elif policy in ("dots_nb", "dots"):
        saved = [CGRA_MATMUL] + ([torch.ops.aten.bmm.default] if policy == "dots" else [])
        ctx = functools.partial(create_selective_checkpoint_contexts, saved)
    else:
        raise ValueError(f"remat_policy={policy!r}: one of {REMAT_POLICIES}")
    return functools.partial(checkpoint, use_reentrant=False, context_fn=ctx,
                             preserve_rng_state=False)


def _in_context(fn, act: tuple):
    """``fn`` run under the activation context ``act``
    (:func:`~repro_torch.launch.sharding.activation_context`): a
    checkpointed group runs again in the backward pass, on the autograd
    engine's thread for a CUDA device, which does not see the forward's
    context variables."""
    def run(*args):
        with activation_mesh(*act):
            return fn(*args)
    return run


def forward_hidden(cfg: ArchConfig, params, tokens=None, *, mode: str = "train",
                   caches=None, pos=None, pages=None, past_len=0,
                   chunk_len=None, images=None, frames=None, full_kv: bool = False,
                   return_aux: bool = False, attn_chunk: int = 0,
                   main_repeats: int | None = None, plan=None):
    """Run the stack; returns (hidden, caches), or with ``return_aux``
    (hidden, aux, caches) as the reference does: ``aux`` the f32 sum of the
    MoE layers' load-balancing losses in train mode (0 without MoE layers
    and in the other modes).

    train: tokens [B, S] (an audio encoder: ``frames`` [B, S,
    frontend_dim]), no caches (None is returned); an encoder attends
    bidirectionally.  When autograd records, each layer group runs under
    ``cfg.remat_policy`` (:func:`_remat`).  prefill: tokens [B, S] at positions ``past_len +
    arange(S)``; ``caches``, if given, is the past KV tree of a cached
    prefix of ``past_len`` rows, and the returned tree holds only the new
    rows (sliding-window layers as rolled rings, or every row linear with
    ``full_kv``, which the paged engine's whole prefill asks for).  decode:
    tokens [B, 1], pos [B]; ``caches`` are slot caches, or page pools with ``pages``,
    updated in place.  chunk: tokens [B, C], ``past_len`` rows already in
    the pages and ``chunk_len`` valid rows in the buffer (ints or [B]
    tensors), pools updated in place.  A cross model's train and prefill
    read ``images`` [B, vision_tokens, vision_dim]; its decode reads the
    image K/V its prefill cached.  An encoder has only the train mode.
    ``attn_chunk`` query-chunks the plain attention (train and prefill);
    ``main_repeats`` runs the main stage at that depth (params and caches
    made for it, or the first layers of deeper ones).  ``plan``: the
    params' :func:`fsdp_plan` under the current mesh: each layer gathers its
    FSDP shards when it runs, inside its remat group (the top-level leaves
    are the caller's to gather, as :func:`loss_fn` does)."""
    if cfg.kind == "encoder" and mode != "train":
        raise ValueError(f"{cfg.name} is an encoder: it has no causal {mode} step; run "
                         f"forward_hidden(mode='train') and lm_logits on every frame")
    x = embed_inputs(cfg, params, tokens, frames)
    img = project_images(cfg, params, images)
    if cfg.vision_tokens and mode in ("train", "prefill") and img is None:
        raise ValueError(f"{cfg.name} cross-attends over an image: pass images=[B, "
                         f"{cfg.vision_tokens}, {cfg.vision_dim}]")
    B, C = x.shape[0], x.shape[1]
    dev = x.device
    mesh = current_mesh()
    data_shard = None
    if mode == "chunk":
        past = _rows(past_len, B, dev)
        positions = past[:, None] + torch.arange(C, dtype=torch.int32,
                                                 device=dev)[None]
        rows = L.StepRows(positions, pages, _rows(chunk_len, B, dev))
    elif mode == "decode":
        rows = L.StepRows(pos[:, None], pages)
        nd = mesh.size("data") if mesh is not None else 1
        if nd > 1 and pages is not None and B % nd == 0:
            # the reference's "batch" rule: the decode batch splits over the
            # data group (a batch it does not divide stays whole everywhere)
            lo = mesh.index("data") * (B // nd)
            data_shard = slice(lo, lo + B // nd)
            rows = L.StepRows(pos[data_shard, None], pages[data_shard], full=rows)
            x = x[data_shard]
    else:
        rows = L.StepRows(torch.arange(C, dtype=torch.int32, device=dev)
                          + int(past_len), None)
    remat = _remat(cfg.remat_policy) if mode == "train" and torch.is_grad_enabled() else None
    new_caches = []
    aux = torch.zeros((), dtype=F32, device=dev) if mode == "train" or return_aux else None
    for si, stage in enumerate(cfg.stages(main_repeats)):
        sc = None if caches is None else caches[si]

        stage_params, lplan = params["stages"][si], None
        if plan is not None:
            stage_params, lplan = _stack_dim_gathered(stage_params, plan["stages"][si], mesh)

        # the specs are bound here: a checkpoint recomputes the group in the
        # backward pass, when ``stage`` already holds the last stage
        def group(x, aux, lp, lc, specs=stage.group, lplan=lplan):
            if lplan is not None:  # this layer's FSDP shards, gathered now
                lp = fsdp_gathered(lp, lplan, mesh, skip=1)
            out = {}
            for gi, spec in enumerate(specs):
                c_in = None if lc is None else lc[str(gi)]
                x, out[str(gi)], a = _apply_layer(cfg, spec, lp[str(gi)], x, mode=mode,
                                                  cache=c_in, rows=rows, img=img,
                                                  full_kv=full_kv, attn_chunk=attn_chunk)
                if a is not None:
                    aux = aux + a
            return x, aux, out

        per_layer = []
        layer_caches = [None] * stage.repeats if sc is None else _unstack(sc, stage.repeats)
        # each stacked leaf is unbound here, outside any checkpoint: a
        # recompute must not scatter the stack's gradient again
        for lp, lc in zip(_unstack(stage_params, stage.repeats), layer_caches):
            if remat is None:
                x, aux, out = group(x, aux, lp, lc)
            else:
                x, aux, out = remat(_in_context(group, activation_context()), x, aux, lp, lc)
            per_layer.append(out)
        if mode == "prefill":
            new_caches.append(_stack_layers(per_layer))
    hidden = L.apply_norm(cfg, params["final_norm"], x)
    if data_shard is not None:
        hidden = mesh.all_gather(hidden, "data", 0)
    if mode == "prefill":
        out_caches = new_caches
    else:
        out_caches = caches if mode in ("decode", "chunk") else None
    return (hidden, aux, out_caches) if return_aux else (hidden, out_caches)


NEG_INF = -1e9  # the reference's masked logit (``repro.models.layers.NEG_INF``)


def cross_entropy(cfg: ArchConfig, logits, labels):
    """Mean cross-entropy over every position, in f32; the padded vocab's
    columns are masked out (the reference's ``cross_entropy``).  logits
    [B, S, Vp] (any float dtype), labels [B, S]."""
    lf = logits.to(F32)
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab, device=lf.device)
        lf = torch.where(col < cfg.vocab_size, lf, torch.full_like(lf, NEG_INF))
    lse = torch.logsumexp(lf, -1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def vocab_parallel_cross_entropy(cfg: ArchConfig, logits, labels, mesh):
    """:func:`cross_entropy` of logits held as vocab shards over the model
    group (logits [B, S, Vp / tp], this rank's columns): the row max joined
    by a max all-reduce (no gradient: the log-sum-exp does not depend on
    it), the sum of exponentials and each row's label logit (from the one
    shard that holds it) by f32 all-reduces whose backward is the identity
    (``leave_tp``); the padded vocab's columns are masked by their global
    index.  No rank sees a whole row of logits."""
    lf = logits.to(F32)
    Vl = lf.shape[-1]
    lo = mesh.index("model") * Vl
    col = torch.arange(lo, lo + Vl, device=lf.device)
    if cfg.padded_vocab != cfg.vocab_size:
        lf = torch.where(col < cfg.vocab_size, lf, torch.full_like(lf, NEG_INF))
    m = mesh.all_max(lf.detach().amax(-1), "model")
    se = leave_tp(torch.exp(lf - m[..., None]).sum(-1), mesh)
    lse = m + torch.log(se)
    local = labels.long() - lo
    ok = (local >= 0) & (local < Vl)
    ll = torch.gather(lf, -1, torch.where(ok, local, 0)[..., None])[..., 0]
    ll = leave_tp(torch.where(ok, ll, torch.zeros_like(ll)), mesh)
    return torch.mean(lse - ll)


def loss_fn(cfg: ArchConfig, params, batch: dict, *, attn_chunk: int = 0,
            main_repeats: int | None = None):
    """The training loss of the reference's ``loss_fn``: ``ce + 0.01 *
    aux`` and ``{"ce", "aux"}``.  ``batch`` holds tensors: ``labels`` [B, S]
    and ``tokens`` [B, S], or an audio encoder's ``frames`` [B, S,
    frontend_dim] (one label a frame); a cross model also reads
    ``images``.  ``attn_chunk`` / ``main_repeats``: see
    :func:`forward_hidden`.

    Under a mesh ``params`` is this rank's shard and ``batch`` its rows: the
    loss is the mean over those rows (the train step averages the data
    ranks), FSDP shards are gathered where they are read (the embedding,
    final norm and head here, each layer's in :func:`forward_hidden`), and a
    vocab-sharded head takes :func:`vocab_parallel_cross_entropy`."""
    mesh = current_mesh()
    plan = fsdp_plan(cfg, params, mesh, main_repeats) if mesh is not None else None
    if plan is not None:
        params = dict(params, **{k: fsdp_gathered(v, plan[k], mesh)
                                 for k, v in params.items() if k != "stages" and k in plan})
    hidden, aux, _ = forward_hidden(cfg, params, batch.get("tokens"), mode="train",
                                    images=batch.get("images"),
                                    frames=batch.get("frames"), return_aux=True,
                                    attn_chunk=attn_chunk, main_repeats=main_repeats,
                                    plan=plan)
    logits = head_logits(cfg, params, hidden)
    if logits.shape[-1] != cfg.padded_vocab:
        ce = vocab_parallel_cross_entropy(cfg, logits, batch["labels"], mesh)
    else:
        ce = cross_entropy(cfg, logits, batch["labels"])
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(cfg: ArchConfig, params, tokens, *, images=None, past=None,
            past_len: int = 0, full_kv: bool = False, cache_len: int | None = None,
            attn_chunk: int = 0, main_repeats: int | None = None):
    """Whole-prompt prefill of tokens [B, S].  Returns (last-row logits
    [B, 1, Vp] f32, caches).  ``images`` [B, vision_tokens, vision_dim]: a
    cross model's patch embeddings (required there; their K/V are cached).
    ``past``/``past_len``: a cached prefix's KV tree and its length (the
    prompt continues it; the returned caches hold only the new rows).
    ``full_kv``: keep a sliding-window layer's every row linear instead of
    the rolled ring (the paged engine's whole prefill: the pool holds every
    row and decode windows through ``start``).
    ``cache_len``: zero-pad every ``kv_seq`` leaf to that capacity so that
    ``decode_step`` can decode into it directly (SSD state and image K/V
    leaves are already whole).  ``attn_chunk`` / ``main_repeats``: see
    :func:`forward_hidden`.  An encoder has no prefill."""
    hidden, caches = forward_hidden(cfg, params, tokens, mode="prefill",
                                    caches=past, past_len=past_len, images=images,
                                    full_kv=full_kv, attn_chunk=attn_chunk,
                                    main_repeats=main_repeats)
    logits = lm_logits(cfg, params, hidden[:, -1:].contiguous())
    if cache_len is not None:
        caches = pad_cache_len(cfg, caches, cache_len)
    return logits, caches


def encode(cfg: ArchConfig, params, frames, *, attn_chunk: int = 0,
           main_repeats: int | None = None):
    """An encoder's inference forward (hubert): frames [B, S,
    frontend_dim] -> every frame's f32 logits [B, S, Vp], attending both
    ways; the attention on its kernel outside autograd.  The dry run's
    prefill cell of an encoder, which has no causal prefill.
    ``attn_chunk`` / ``main_repeats``: see :func:`forward_hidden`."""
    hidden, _ = forward_hidden(cfg, params, mode="train", frames=frames,
                               attn_chunk=attn_chunk, main_repeats=main_repeats)
    return lm_logits(cfg, params, hidden)


def decode_step(cfg: ArchConfig, params, caches, token, pos, *, pages=None,
                main_repeats: int | None = None):
    """One-token decode.  token: [B, 1]; pos: an int (every slot at the
    same row) or [B] int32 (each slot at its own row).  ``pages`` [B, npp]
    int32 switches ``caches`` from slot caches (linear for global layers, a
    ring for sliding-window ones) to page pools.  The new row is written in
    place; a cross model reads its prefill's image K/V.  ``main_repeats``:
    see :func:`forward_hidden`.  Returns (logits
    [B, 1, Vp] f32, caches)."""
    B = token.shape[0]
    pos = _rows(pos, B, token.device)
    hidden, caches = forward_hidden(cfg, params, token, mode="decode",
                                    caches=caches, pos=pos, pages=pages,
                                    main_repeats=main_repeats)
    return lm_logits(cfg, params, hidden), caches


def chunk_step(cfg: ArchConfig, params, caches, tokens, pages, past_len,
               chunk_len):
    """One chunked-prefill step: tokens [B, C] chunk buffer (``chunk_len``
    valid rows), pages [B, npp]; ``past_len`` rows of this prompt are
    already in the pages.  Returns (last-valid-row logits [B, 1, Vp],
    caches)."""
    hidden, caches = forward_hidden(cfg, params, tokens, mode="chunk",
                                    caches=caches, pages=pages,
                                    past_len=past_len, chunk_len=chunk_len)
    if isinstance(chunk_len, int):
        last = hidden[:, chunk_len - 1: chunk_len]
    else:
        idx = _rows(chunk_len, tokens.shape[0], tokens.device).long() - 1
        last = torch.take_along_dim(hidden, idx[:, None, None], dim=1)
    return lm_logits(cfg, params, last.contiguous()), caches


def mixed_step(cfg: ArchConfig, params, caches, chunk_tokens, chunk_pages,
               chunk_past_len, chunk_len, dec_token, dec_pos, dec_pages):
    """One prompt chunk plus one decode token per slot.  The chunk runs
    first; the two touch disjoint pages.  Returns (chunk_logits [Bc,1,Vp],
    dec_logits [B,1,Vp], caches)."""
    chunk_logits, caches = chunk_step(cfg, params, caches, chunk_tokens,
                                      chunk_pages, chunk_past_len, chunk_len)
    dec_logits, caches = decode_step(cfg, params, caches, dec_token, dec_pos,
                                     pages=dec_pages)
    return chunk_logits, dec_logits, caches
