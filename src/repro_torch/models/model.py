"""Config-driven model assembly on the serving path (port of
``repro.models.model``): param specs, paged caches, chunk / decode / mixed
steps.

Weights keep the JAX package's stacked layout — one leading layer axis per
stage — so the weight bridge is a plain reshape; the ``lax.scan`` over that
axis becomes a Python loop.  Only attention mixers with a dense FFN are
ported; every other mixer or FFN raises ``NotImplementedError``.  Page
pools are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.params import (ParamSpec, init_params, stack_tree,
                                       tree_map_specs)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _check_layer(spec: LayerSpec):
    if spec.mixer not in ("attn_global", "attn_local") or spec.ffn != "dense":
        raise NotImplementedError(
            f"layer {spec} is not ported yet (attention + dense FFN only)")


def _layer_param_specs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    _check_layer(spec)
    if cfg.use_mla:
        raise NotImplementedError("MLA is not ported yet")
    return {"norm1": L.norm_specs(cfg), "mixer": L.attn_specs(cfg),
            "norm2": L.norm_specs(cfg), "ffn": L.ffn_specs(cfg)}


def param_specs(cfg: ArchConfig) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    if cfg.audio_frontend or cfg.vision_tokens:
        raise NotImplementedError("frontends are not ported yet")
    tree: dict = {"embed": ParamSpec((Vp, D), ("vocab", "embed"), "normal")}
    tree["stages"] = [
        stack_tree({str(i): _layer_param_specs(cfg, sp)
                    for i, sp in enumerate(stage.group)}, stage.repeats)
        for stage in cfg.stages()]
    tree["final_norm"] = L.norm_specs(cfg)
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((D, Vp), ("embed", "vocab"), "normal")
    return tree


def init(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random weights from the JAX package's init rules, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``) and stored in
    the compute dtype."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(param_specs(cfg), gen, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Paged caches
# ---------------------------------------------------------------------------

def paged_cache_specs(cfg: ArchConfig, max_batch: int, n_pages: int,
                      page_size: int) -> list:
    """Per-stage pool specs: every attention layer owns k/v pools
    ``[R, n_pages, page_size, K, dh]`` (R = the stage's stacked layers);
    page 0 is the engine's trash page."""
    del max_batch  # pools are shared across sequences
    out = []
    for stage in cfg.stages():
        group = {}
        for i, sp in enumerate(stage.group):
            _check_layer(sp)
            group[str(i)] = L.attn_cache_specs(cfg, n_pages, page_size)
        out.append(stack_tree(group, stage.repeats))
    return out


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
                     page_size: int, device=None) -> list:
    dev = resolve_device(device)
    return tree_map_specs(lambda s: _pool(s, cfg.compute_dtype, dev),
                          paged_cache_specs(cfg, max_batch, n_pages, page_size))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _index(tree, r: int):
    """Layer ``r`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, p: dict, x, *, mode: str,
                 cache, rows: L.StepRows):
    """Returns (x, cache).  ``cache`` is the layer's page pools (updated in
    place); ``rows`` the step's shared positions, tables and bounds."""
    _check_layer(spec)
    local = spec.mixer == "attn_local"
    h = L.apply_norm(cfg, p["norm1"], x)
    if mode == "decode":
        m, cache = L.attn_decode(cfg, p["mixer"], cache, h, rows, local=local)
    elif mode == "chunk":
        m, cache = L.attn_chunk_prefill(cfg, p["mixer"], cache, h, rows,
                                        local=local)
    else:
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    x = x + m
    h = L.apply_norm(cfg, p["norm2"], x)
    return x + L.ffn_forward(cfg, p["ffn"], h), cache


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, params, tokens):
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    return x


def lm_logits(cfg: ArchConfig, params, hidden):
    """f32 logits straight from the GEMM's f32 accumulator."""
    head = (params["embed"].T.contiguous() if cfg.tie_embeddings
            else params["lm_head"])
    return L.dense_proj(cfg, hidden, head, out_dtype=F32)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _rows(x, B: int, device) -> torch.Tensor:
    """[B] int32 on ``device`` from an int or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(B).contiguous()
    return torch.full((B,), int(x), dtype=torch.int32, device=device)


def forward_hidden(cfg: ArchConfig, params, tokens, *, mode: str, caches,
                   pos=None, pages=None, past_len=0, chunk_len=None):
    """Run the stack; returns (hidden, caches).  decode: tokens [B, 1], pos
    [B].  chunk: tokens [B, C], ``past_len`` rows already in the pages and
    ``chunk_len`` valid rows in the buffer (ints or [B] tensors).  The pools
    in ``caches`` are updated in place."""
    x = embed_tokens(cfg, params, tokens)
    B, C = tokens.shape
    dev = tokens.device
    if mode == "chunk":
        past = _rows(past_len, B, dev)
        positions = past[:, None] + torch.arange(C, dtype=torch.int32,
                                                 device=dev)[None]
        rows = L.StepRows(positions, pages, _rows(chunk_len, B, dev))
    else:
        rows = L.StepRows(pos[:, None], pages)
    for si, stage in enumerate(cfg.stages()):
        sp, sc = params["stages"][si], caches[si]
        for r in range(stage.repeats):
            lp, lc = _index(sp, r), _index(sc, r)
            for gi, spec in enumerate(stage.group):
                x, _ = _apply_layer(cfg, spec, lp[str(gi)], x, mode=mode,
                                    cache=lc[str(gi)], rows=rows)
    return L.apply_norm(cfg, params["final_norm"], x), caches


def decode_step(cfg: ArchConfig, params, caches, token, pos, *, pages):
    """One-token decode.  token: [B, 1]; pos: [B] int32 (each slot at its
    own row); pages: [B, npp] int32.  Returns (logits [B, 1, Vp] f32,
    caches)."""
    B = token.shape[0]
    pos = _rows(pos, B, token.device)
    hidden, caches = forward_hidden(cfg, params, token, mode="decode",
                                    caches=caches, pos=pos, pages=pages)
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
