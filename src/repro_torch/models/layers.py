"""Transformer layers (port of ``repro.models.layers``).

Every weight-activation matmul funnels through :func:`dense_proj` (the block
GEMM, or the packed int8 GEMM for ``QTensor`` weights under w8a8),
whole-prompt attention and cross-attention over an image (at decode too)
through the dense flash-attention kernel,
chunked-prefill attention through the paged one, and decode attention
through flash-decode on page pools or on linear / ring slot caches (MLA's
latent decode too; MLA's whole-prompt attention stays plain PyTorch, as
the reference's jnp ``attend``).  A tensor's device chooses between each
kernel and its plain version.  Training (autograd recording) differentiates
the GEMMs through ``ops.cgra_matmul``'s backward kernels and runs attention
in its plain version, by rule (:func:`dense_attention`).

Caches are updated **in place** (the JAX engine donates them instead).  A
pool made by ``model.init_paged_cache`` has one spare *drop row* in its
storage right past its last page: a write whose row falls off the page
table, or that belongs to a chunk's padding, lands there — the counterpart
of JAX's ``.at[].set(mode="drop")`` with no host round trip, and never a
clamp onto a real row.  A slot cache drops a write past its last row by
writing that row's old value back (:func:`_slot_write`).

Under a mesh (``launch.sharding.activation_mesh``, set by the serving
engine's runner) each layer computes this rank's shard, as the reference's
``shard_map`` bodies do: a projection with the ``shard=("col", blocks)``
hint yields this rank's output columns, one with ``("row", blocks)`` sums
its partial GEMM over the model group in f32 (a w8a8 weight: in int32,
exactly, ``core.gemm.cgra_gemm_w8a8_row``), anything else (no hint, or
``blocks`` not a multiple of the model axis: the weight was left whole) is
whole.  Attention runs on this rank's heads over its KV-pool shard, and MoE
on its ``E / tp`` experts (``cfg.moe_shard_map``) or, where tp does not
divide E, on its ``moe_d_ff / tp`` of every expert's FFN.  The same code trains:
a replicated tensor that enters rank-specific compute (a column-parallel
projection's input, a replicated weight applied to this rank's heads, a
tensor a rank slices for itself) goes through ``launch.mesh.enter_tp``,
whose backward sums the ranks' partial gradients, and every sum of partial
results through ``leave_tp``, whose backward is the identity; so each
replicated tensor's gradient is whole on every rank.  Under the
``"fsdp"`` profile nothing is tensor parallel (``tp_size`` is 1).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import round_up, span
from repro_torch.core.cache import CacheLayout
from repro_torch.core.gemm import cgra_gemm, cgra_gemm_w8a8, cgra_gemm_w8a8_row, quantize_act
from repro_torch.core.quant import QTensor
from repro_torch.kernels import dry
from repro_torch.kernels._build import records
from repro_torch.kernels.ops import attend_decode, attention
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch.mesh import enter_tp, leave_tp, mean_across
from repro_torch.launch.sharding import current_batch_axes, current_mesh, tp_size
from repro_torch.models.params import ParamSpec

F32 = torch.float32


# ---------------------------------------------------------------------------
# Dense projection — the single GEMM choke point of the model
# ---------------------------------------------------------------------------

def _split(shard) -> str | None:
    """"col" / "row" when the hint ``shard`` splits its GEMM on the current
    mesh (its ``blocks`` a multiple of the model axis, as the rule that
    sliced the weight), else None (the weight is whole)."""
    tp = tp_size()
    if tp == 1 or not shard or shard[1] % tp:
        return None
    return shard[0]


def tp_input(x, w, shard):
    """``x`` as the input of a projection of ``w`` with the hint ``shard``:
    entered into the tensor-parallel region (``enter_tp``) when the
    projection is column-split, else ``x`` itself.  A caller whose input
    feeds several column-split projections enters it once here and passes
    ``entered=True`` to each (one all-reduce of its gradient, not one a
    projection); a replicated parameter applied to a shard's heads is
    entered the same way (``w`` itself as ``x``)."""
    if isinstance(w, QTensor) or _split(shard) != "col":
        return x
    return enter_tp(x, current_mesh())


def dense_proj(cfg: ArchConfig, x, w, out_shape: tuple = (), out_dtype=None,
               shard: tuple | None = None, entered: bool = False):
    """x: [..., K] @ w -> [..., N] (or [..., *out_shape]).  ``w`` is a float
    weight whose dims reshape row-major to [K, N] (wq [D,H,dh] -> [D, H*dh];
    wo [H,dh,D] -> [H*dh, D] with the caller flattening x's head dims),
    stored in the compute dtype at load, or a ``QTensor`` packed by
    ``model.quantize_params`` (q [N, K] int8), served by the int8 GEMM.
    ``out_dtype`` overrides the accumulator's store dtype (default the
    compute dtype; the LM head asks for f32).  Under w8a8, ``x`` may be the
    activation already quantized by :func:`shared_input` (one quantize for
    every projection that reads it).

    ``shard=("col"|"row", blocks)`` is the reference's tensor-parallel hint
    (``blocks`` the head / kv-head / ffn / vocab count), read under a mesh:
    "col" — ``w`` is this rank's column slice and the output (``out_shape``
    with its leading count cut to ``blocks / tp``) this rank's shard; "row"
    — ``x`` and ``w`` are this rank's slices of the contraction: each
    partial product leaves the GEMM's f32 accumulator unrounded, the
    partials are summed over the model group in f32 and the sum is rounded
    once to the store dtype, as the single device rounds its one sum (the
    reference rounds each partial first, then sums in f32).  A ``QTensor``
    weight is sliced by the same rule (``model.shard_params``): "col" runs
    the int8 GEMM on its column slice, "row" the row-parallel int8 GEMM
    (``core.gemm.cgra_gemm_w8a8_row``: the whole row's scale and an exact
    int32 sum), whose output equals the single device's bit for bit.
    Under autograd a "col" input enters the region (:func:`tp_input`,
    unless the caller did: ``entered``) and a "row" sum leaves it
    (``leave_tp``)."""
    split = _split(shard)
    if isinstance(w, QTensor):
        if split == "row":
            out = cgra_gemm_w8a8_row(x, w, current_mesh(),
                                     out_dtype=out_dtype or cfg.compute_dtype)
        else:
            out = cgra_gemm_w8a8(x, w, out_dtype=out_dtype or cfg.compute_dtype)
    elif split == "row":
        out = cgra_gemm(x, w.reshape(x.shape[-1], -1), out_dtype=F32)
        out = leave_tp(out, current_mesh()).to(out_dtype or x.dtype)
    else:
        if split == "col" and not entered:
            x = tp_input(x, w, shard)
        out = cgra_gemm(x, w.reshape(x.shape[-1], -1), out_dtype=out_dtype)
    if out_shape:
        if split == "col":
            out_shape = (out_shape[0] // tp_size(), *out_shape[1:])
        out = out.reshape(*out.shape[:-1], *out_shape)
    return out


def shared_input(x, w):
    """``x`` for several projections with weights like ``w``: quantized once
    here when ``w`` is a w8a8 ``QTensor`` (the int8 values and every output
    stay bit-identical to quantizing per projection), else ``x``.  Only for
    readers of the whole activation -- whole or column-split projections;
    a row-split one quantizes its slice itself, with the whole row's
    scale."""
    return quantize_act(x) if isinstance(w, QTensor) else x


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------

def norm_specs(cfg: ArchConfig) -> dict:
    if cfg.norm_type == "rmsnorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm_type == "layernorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones"),
                "bias": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    return {}  # layernorm_nonparam


def apply_norm(cfg: ArchConfig, p: dict, x):
    """Norm computed in f32, cast back to x's dtype (eps 1e-6, as the JAX
    layers).  ``F.layer_norm`` accumulates in f32 for bf16 input itself."""
    D = (x.shape[-1],)
    if cfg.norm_type == "layernorm_nonparam":
        return F.layer_norm(x, D, eps=1e-6)
    xf = x.to(F32)
    if cfg.norm_type == "rmsnorm":
        return F.rms_norm(xf, D, p["scale"].to(F32), eps=1e-6).to(x.dtype)
    return F.layer_norm(xf, D, p["scale"].to(F32), p["bias"].to(F32),
                        eps=1e-6).to(x.dtype)


def rms_only(x, scale, eps=1e-6):
    """RMS norm over the last axis in f32 with a scale (qk-norm)."""
    return F.rms_norm(x.to(F32), (x.shape[-1],), scale.to(F32),
                      eps=eps).to(x.dtype)


def rope_tables(positions, d: int, theta: float):
    """RoPE factors for positions [S] or [B, S], shaped [..., S, 1, d] f32:
    ``(cos, sin)`` with the rotate-half sign folded into sin, so that
    ``rope(x) = x * cos + roll(x, d/2) * sin`` — one table per step, shared
    by every layer that uses ``theta``."""
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=positions.device) / half)
    ang = positions.to(F32)[..., :, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], -1)[..., :, None, :],
            torch.cat([-sin, sin], -1)[..., :, None, :])


def apply_rope(x, tables):
    """x: [B, S, n, d] rotated by ``rope_tables`` output: first half
    ``x1*cos - x2*sin``, second half ``x2*cos + x1*sin``."""
    cos, sin = tables
    xf = x.to(F32)
    return torch.addcmul(xf * cos, torch.roll(xf, x.shape[-1] // 2, -1),
                         sin).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (global or sliding-window local)
# ---------------------------------------------------------------------------

def attn_specs(cfg: ArchConfig) -> dict:
    H, K, dh = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    D = cfg.d_model
    p = {
        "wq": ParamSpec((D, H, dh), ("embed", "heads", "qk")),
        "wk": ParamSpec((D, K, dh), ("embed", "kv_heads", "qk")),
        "wv": ParamSpec((D, K, dh), ("embed", "kv_heads", "qk")),
        "wo": ParamSpec((H, dh, D), ("heads", "qk", "embed")),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = ParamSpec((dh,), (None,), "ones")
        p["k_norm"] = ParamSpec((dh,), (None,), "ones")
    return p


def attn_cache_specs(cfg: ArchConfig, batch: int, seq: int,
                     local: bool = False) -> dict:
    """k/v [batch, S, K, dh]; a sliding-window layer's slot cache is a ring
    of ``S = min(seq, window)`` rows (page pools pass ``local=False``: they
    keep every row and window through ``start``)."""
    K, dh = cfg.num_kv_heads, cfg.head_dim
    S = min(seq, cfg.window_size) if (local and cfg.window_size) else seq
    return {
        "k": ParamSpec((batch, S, K, dh), ("batch", "kv_seq", "kv_heads", "qk"), "zeros"),
        "v": ParamSpec((batch, S, K, dh), ("batch", "kv_seq", "kv_heads", "qk"), "zeros"),
    }


def _qkv(cfg, p, x):
    H, K, dh = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    xs = shared_input(x, p["wq"])
    xq = tp_input(xs, p["wq"], ("col", H))
    # K heads split only where H's do (K divides H): whole k / v read xs
    xk = xq if _split(("col", K)) == "col" else xs
    q = dense_proj(cfg, xq, p["wq"], (H, dh), shard=("col", H), entered=True)
    k = dense_proj(cfg, xk, p["wk"], (K, dh), shard=("col", K), entered=True)
    v = dense_proj(cfg, xk, p["wv"], (K, dh), shard=("col", K), entered=True)
    if "q_norm" in p:  # replicated scales on this rank's heads
        q = rms_only(q, tp_input(p["q_norm"], p["q_norm"], ("col", H)))
        k = rms_only(k, tp_input(p["k_norm"], p["k_norm"], ("col", K)))
    return q, k, v


def local_kv(cfg, t, dim: int):
    """The KV heads of ``t`` (whole K heads at ``dim``) that this rank's
    query heads read, when the query heads split over the model axis and
    the KV heads do not (the reference gathers q there and slices the
    output; reading each local head's own KV head instead gives the same
    per-head products).  Every other case returns ``t``: both split (the
    GQA fold intact on the shard) or neither (whole)."""
    tp = tp_size()
    H, K = cfg.padded_heads, cfg.num_kv_heads
    if tp == 1 or H % tp or K % tp == 0:
        return t
    Hl, G = H // tp, H // K
    first = current_mesh().index("model") * Hl
    t = enter_tp(t, current_mesh())  # each rank reads its own heads' share
    if Hl % G == 0:  # whole groups: a contiguous run of KV heads
        return t.narrow(dim, first // G, Hl // G).contiguous()
    idx = torch.arange(first, first + Hl, device=t.device) // G
    return t.index_select(dim, idx)


def _rows_with_drop(pool):
    """[P*ps + 1, ...] view of a pool's rows plus the spare drop row that
    ``model.init_paged_cache`` allocates right past the pool's end."""
    P, ps = pool.shape[0], pool.shape[1]
    rest = tuple(pool.shape[2:])
    row = pool.stride(1)
    if not pool[0].is_contiguous() or pool.stride(0) != ps * row:
        raise ValueError("page pool must be contiguous [P, ps, ...]")
    need = (pool.storage_offset() + (P * ps + 1) * row) * pool.element_size()
    if pool.untyped_storage().nbytes() < need:
        raise ValueError("page pool has no drop row: allocate it with "
                         "model.init_paged_cache")
    return pool.as_strided((P * ps + 1, *rest), (row, *pool.stride()[2:]),
                           pool.storage_offset())


def _row_index(P: int, ps: int, pages, positions, n=None):
    """Pool rows (int64, [B*S]) for logical rows ``positions`` [B, S]:
    ``pages[b, r // ps] * ps + r % ps``, or the drop row ``P * ps`` where
    ``i >= n[b]`` (a chunk's padding, ``n`` [B] or None for none) or the
    page index falls off the table."""
    npp = pages.shape[1]
    ipage = positions // ps
    ok = ipage < npp
    if n is not None:
        i = torch.arange(positions.shape[1], dtype=torch.int32,
                         device=positions.device)[None]
        ok = ok & (i < n[:, None])
    pid = torch.gather(pages, 1, torch.clamp(ipage, max=npp - 1).long())
    flat = torch.where(ok, pid * ps + positions % ps,
                       torch.full_like(positions, P * ps))
    return flat.reshape(-1).long()


def _write_rows(pool, rows, idx):
    """pool[idx] = rows in place, through the pool's drop-row view.
    rows: [B*S, ...]."""
    _rows_with_drop(pool).index_put_((idx,), rows.to(pool.dtype))
    return pool


class StepRows:
    """What every layer of one model step shares, computed once per step:
    the step's positions ([B, S], or [S] shared by a prompt batch), RoPE
    tables per theta, the pool rows its new KV lands in, and the attention
    bounds.  ``pages`` is None off the paged cache; ``n`` [B] is the valid
    row count of a chunk (None for decode: every row is valid)."""

    def __init__(self, positions, pages, n=None, full: "StepRows | None" = None):
        self.positions = positions
        self.pages = pages
        self.n = n
        #: the whole batch's rows when this step's rows are one data shard
        #: of it (a decode step under a mesh with ``data > 1``): new KV rows
        #: are gathered over the data group and every rank writes them all,
        #: so the pools stay whole on every data rank
        self.full = full
        self._cache: dict = {}

    def write(self, pool, new):
        """Write this step's new rows ``new`` [B*S, ...] into ``pool`` in
        place through the page table (the whole batch's, gathered over the
        data group, when the step holds one data shard)."""
        if self.full is not None:
            new = current_mesh().all_gather(new, "data", 0)
            return _write_rows(pool, new, self.full.rows(pool))
        return _write_rows(pool, new, self.rows(pool))

    def _memo(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def rope(self, d: int, theta: float):
        return self._memo(("rope", d, theta),
                          lambda: rope_tables(self.positions, d, theta))

    def rows(self, pool):
        P, ps = pool.shape[0], pool.shape[1]
        return self._memo(("rows", P, ps), lambda: _row_index(
            P, ps, self.pages, self.positions, self.n))

    def pos0(self):
        return self._memo("pos0", lambda: self.positions[:, 0].contiguous())

    def k_len(self):
        return self._memo("k_len", lambda: (self.pos0() + self.n).contiguous())

    def start(self, window: int):
        pos = self.pos0()
        return self._memo(("start", window), lambda: (
            torch.clamp(pos - window + 1, min=0) if window
            else torch.zeros_like(pos)))


def _qkv_rope(cfg, p, x, rows: StepRows, local: bool):
    """q/k/v projections with RoPE on q and k at the step's positions."""
    q, k, v = _qkv(cfg, p, x)
    tables = rows.rope(q.shape[-1], cfg.rope_theta if not local else 10_000.0)
    return apply_rope(q, tables), apply_rope(k, tables), v


def _attn_inputs(cfg, p, cache, x, rows: StepRows, local: bool):
    """q/k/v projections, RoPE on q and k, and the new KV written through
    the page table in place.  Returns (q, k_pool, v_pool)."""
    B, S = x.shape[0], x.shape[1]
    q, k_new, v_new = _qkv_rope(cfg, p, x, rows, local)
    k = rows.write(cache["k"], k_new.reshape(B * S, *k_new.shape[2:]))
    v = rows.write(cache["v"], v_new.reshape(B * S, *v_new.shape[2:]))
    return q, k, v


def plain_attention(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
                    chunk: int = 0):
    """The plain attention (``kernels.ref.flash_attention_ref``), q
    [B,H,Sq,d] over k/v [B,K,Sk,d] (v's width may differ), optionally
    query-chunked as the reference's ``attend`` (``repro/models/layers.py:
    336-350``): with ``0 < chunk < Sq`` the queries are padded to a multiple
    of ``chunk`` and each block of ``chunk`` rows runs over all keys at its
    own positions, so a block's f32 scores are [B,H,chunk,Sk] instead of
    [B,H,Sq,Sk]; the padded rows are sliced off.  Inside a dry run its
    traffic, forward and backward, is also booked as ``attn_core``
    (``kernels.dry.scoped``): what a flash kernel would keep on chip."""
    return dry.scoped("attn_core", _plain_attention, q, k, v, causal=causal, window=window,
                      softcap=softcap, chunk=chunk)


def _plain_attention(q, k, v, *, causal: bool, window: int, softcap: float, chunk: int):
    Sq, Sk = q.shape[2], k.shape[2]
    if not chunk or Sq <= chunk:
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    pad = (-Sq) % chunk
    qp = F.pad(q, (0, 0, 0, pad))
    out = torch.cat([flash_attention_ref(qp[:, :, i:i + chunk], k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         q_start=Sk - Sq + i)
                     for i in range(0, Sq + pad, chunk)], 2)
    return out[:, :, :Sq]


def dense_attention(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
                    chunk: int = 0):
    """Whole-prompt attention, q [B,H,Sq,d] over k/v [B,K,Sk,d]: the dense
    flash kernel, or its plain version when autograd records.  That is a
    rule, not a fallback: the reference's flash kernel has no VJP, and the
    JAX package trains attention through its plain ``attend``
    (``repro/models/layers.py:155-158``: "train/finetune with
    ``kernel_mode="reference"``"), so the port does the same on both
    devices; the kernel wrapper itself refuses to be recorded.  The plain
    call runs in a ``plain_attention`` profiler range, by which a trace
    finds attention's forward ops and, through their autograd sequence
    numbers, its backward ones.  ``chunk`` (the reference's ``attn_chunk``)
    query-chunks the plain version (:func:`plain_attention`); the kernel
    keeps no score matrix and takes the whole query block."""
    if records(q, k, v):
        with span("plain_attention"):
            return plain_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, chunk=chunk)
    return attention(q, k, v, causal=causal, window=window, softcap=softcap)


def attn_forward(cfg: ArchConfig, p: dict, x, rows: StepRows, *, local: bool,
                 past_kv=None, causal: bool | None = None, attn_chunk: int = 0):
    """Whole-prompt self-attention (training forward and prefill).  x:
    [B,S,D] at ``rows.positions`` [S]; ``past_kv`` ({"k","v"} [B,s,K,dh],
    post-RoPE) is a cached prefix the prompt continues: attention runs over
    concat(past, new) with the last query aligned with the last key.
    ``causal`` None: causal for a decoder, bidirectional for an encoder
    (``cfg.kind``), as the reference's training forward.  Returns (out, k,
    v) with the new rows' post-RoPE k/v [B,S,K,dh].  ``attn_chunk``: see
    :func:`dense_attention`."""
    if causal is None:
        causal = cfg.kind == "decoder"
    q, k, v = _qkv_rope(cfg, p, x, rows, local)
    k_all, v_all = k, v
    if past_kv is not None:
        k_all = torch.cat([past_kv["k"].to(k.dtype), k], 1)
        v_all = torch.cat([past_kv["v"].to(v.dtype), v], 1)
    o = dense_attention(q.transpose(1, 2), local_kv(cfg, k_all, 2).transpose(1, 2),
                        local_kv(cfg, v_all, 2).transpose(1, 2),
                        causal=causal, window=cfg.window_size if local else 0,
                        softcap=cfg.logit_softcap, chunk=attn_chunk)
    o = o.transpose(1, 2)  # [B, S, H, dh]; free on the card (see flash_attention)
    out = dense_proj(cfg, o.reshape(*o.shape[:-2], -1), p["wo"],
                     shard=("row", cfg.padded_heads))
    return out, k, v


def attn_prefill(cfg: ArchConfig, p: dict, x, rows: StepRows, *, local: bool,
                 past_kv=None, full_kv: bool = False, attn_chunk: int = 0):
    """Causal :func:`attn_forward` that also returns the prompt's cache
    (post-RoPE k/v of the new rows).  A sliding-window layer keeps only the
    last ``window`` rows, rolled so that entry ``pos % window`` holds row
    ``pos``: decode continues the ring; with ``full_kv`` it keeps every row
    linearly instead (the paged engine stores every row and windows at
    decode time, as the reference's ``full_cache``).  Returns (out, {"k",
    "v"})."""
    out, k, v = attn_forward(cfg, p, x, rows, local=local, past_kv=past_kv, causal=True,
                             attn_chunk=attn_chunk)
    window = cfg.window_size if local else 0
    S = k.shape[1]
    if window and not full_kv and past_kv is None and S > window:
        k = torch.roll(k[:, -window:], (S - window) % window, 1)
        v = torch.roll(v[:, -window:], (S - window) % window, 1)
    return out, {"k": k, "v": v}


def attn_chunk_prefill(cfg: ArchConfig, p: dict, cache: dict, x, rows: StepRows,
                       *, local: bool):
    """Chunked prefill over a paged past: one fixed-size prompt chunk.

    x: [B, C, D] chunk buffer; ``rows`` holds the chunk's positions [B, C],
    its valid row counts ``n`` [B] and the page tables [B, npp]; cache: page
    pools [P, ps, K, dh] (updated in place).  Writes the chunk's post-RoPE KV
    through the page table and attends the chunk over logical rows
    ``[0, past_len + n)``.  Padding rows give outputs the caller ignores.
    Returns (out, cache)."""
    q, k, v = _attn_inputs(cfg, p, cache, x, rows, local)
    window = cfg.window_size if local else 0
    o = attention(q.transpose(1, 2), local_kv(cfg, k, 2), local_kv(cfg, v, 2),
                  window=window, softcap=cfg.logit_softcap, pages=rows.pages,
                  q_start=rows.pos0(), k_len=rows.k_len())
    o = o.transpose(1, 2)  # [B, C, H, dh]; free on the card (see flash_attention_paged)
    out = dense_proj(cfg, o.reshape(*o.shape[:-2], -1), p["wo"],
                     shard=("row", cfg.padded_heads))
    return out, {"k": k, "v": v}


def _slot_write(cache, new, widx):
    """cache[b, widx[b]] = new[b] in place for a slot cache [B, S, ...].
    A row at ``widx >= S`` is dropped, as JAX's ``mode="drop"``: row S-1
    gets its own old value back, with no host sync and never a clamp."""
    B, S = cache.shape[0], cache.shape[1]
    bidx = torch.arange(B, device=cache.device)
    idx = torch.clamp(widx, max=S - 1).long()
    drop = (widx >= S).view(B, *([1] * (new.dim() - 1)))
    cache[bidx, idx] = torch.where(drop, cache[bidx, idx], new.to(cache.dtype))


def attn_decode(cfg: ArchConfig, p: dict, cache: dict, x, rows: StepRows, *,
                local: bool):
    """One-token decode.  x: [B,1,D]; ``rows`` holds the current rows
    ``pos`` ([B, 1] positions) and the page tables, if any.

    Paged: the new row is written through the table in place, then
    attention follows the table over rows ``[start, pos]`` (``start = max(0,
    pos - window + 1)`` on sliding-window layers, else 0).  Slot caches
    [B,S,K,dh]: a sliding-window layer's ring takes the row at ``pos % S``
    and reads in the ring layout; a global layer's linear cache takes it at
    ``pos`` (dropped when ``pos >= S``) and reads rows ``[0, pos]``."""
    B = x.shape[0]
    window = cfg.window_size if local else 0
    if rows.pages is not None:
        q, k, v = _attn_inputs(cfg, p, cache, x, rows, local)
        o = attend_decode(q[:, 0].contiguous(), local_kv(cfg, k, 2), local_kv(cfg, v, 2),
                          rows.pos0(), rows.start(window), layout=CacheLayout.PAGED,
                          pages=rows.pages, softcap=cfg.logit_softcap)
    else:
        q, k_new, v_new = _qkv_rope(cfg, p, x, rows, local)
        k, v = cache["k"], cache["v"]
        ring = bool(local and cfg.window_size)
        pos = rows.pos0()
        widx = torch.remainder(pos, k.shape[1]) if ring else pos
        _slot_write(k, k_new[:, 0], widx)
        _slot_write(v, v_new[:, 0], widx)
        o = attend_decode(q[:, 0].contiguous(), local_kv(cfg, k, 2), local_kv(cfg, v, 2),
                          pos, rows.start(0),
                          layout=CacheLayout.RING if ring else CacheLayout.LINEAR,
                          softcap=cfg.logit_softcap)
    out = dense_proj(cfg, o.reshape(B, 1, -1), p["wo"], shard=("row", cfg.padded_heads))
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2 / MiniCPM3 style)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ArchConfig) -> dict:
    D, H = cfg.d_model, cfg.padded_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": ParamSpec((D, qr), ("embed", "lora")),
        "q_norm": ParamSpec((qr,), (None,), "ones"),
        "wq_b": ParamSpec((qr, H, dn + dr), ("lora", "heads", "qk")),
        "wkv_a": ParamSpec((D, kvr + dr), ("embed", "lora")),
        "kv_norm": ParamSpec((kvr,), (None,), "ones"),
        "wkv_b": ParamSpec((kvr, H, dn + dv), ("lora", "heads", "qk")),
        "wo": ParamSpec((H, dv, D), ("heads", "qk", "embed")),
    }


def mla_cache_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """One fused ``[latent | k_rope]`` cache a layer, [batch, seq, kvr + dr]:
    decode reads it as both keys (full width) and values (the first
    ``kv_lora_rank`` columns)."""
    return {"kv": ParamSpec((batch, seq, cfg.kv_lora_rank + cfg.qk_rope_dim),
                            ("batch", "kv_seq", None), "zeros")}


def _mla_q(cfg, p, xs, rows: StepRows):
    """Low-rank queries, RoPE on their ``qk_rope_dim`` half: (q_nope
    [B,S,H,dn], q_rope [B,S,H,dr]).  ``xs`` is ``shared_input`` of x."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_only(dense_proj(cfg, xs, p["wq_a"]), p["q_norm"])
    q = dense_proj(cfg, cq, p["wq_b"], (cfg.padded_heads, dn + dr),
                   shard=("col", cfg.padded_heads))
    return q[..., :dn], apply_rope(q[..., dn:], rows.rope(dr, cfg.rope_theta))


def _mla_latent(cfg, p, xs, rows: StepRows):
    """The normed latent [B,S,kvr] and the shared rotated key [B,S,dr]."""
    kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    ckv = dense_proj(cfg, xs, p["wkv_a"])
    latent = rms_only(ckv[..., :kvr], p["kv_norm"])
    k_rope = apply_rope(ckv[..., None, kvr:], rows.rope(dr, cfg.rope_theta))[:, :, 0]
    return latent, k_rope


def _mla_attend(cfg, p, x, rows: StepRows, attn_chunk: int = 0):
    """Whole-prompt MLA: the latent expanded to per-head keys and values,
    then causal attention in plain PyTorch (q/k width dn + dr differs from
    v's dv, as in the reference's ``attend``; no kernel lies behind it),
    query-chunked by ``attn_chunk`` (:func:`plain_attention`).  Returns
    (out [B,S,D], latent, k_rope)."""
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    xs = shared_input(x, p["wq_a"])
    q_nope, q_rope = _mla_q(cfg, p, xs, rows)
    H = q_nope.shape[2]  # this rank's heads under a mesh
    latent, k_rope = _mla_latent(cfg, p, xs, rows)
    kv = dense_proj(cfg, latent, p["wkv_b"], (cfg.padded_heads, dn + dv),
                    shard=("col", cfg.padded_heads))
    # the one shared key, read by this rank's heads: entered, so that its
    # gradient (and that of wkv_a's rope columns) is summed over the group
    k_rope_h = tp_input(k_rope, p["wkv_b"], ("col", cfg.padded_heads))
    k_rope_h = k_rope_h[:, :, None, :].expand(*k_rope.shape[:2], H, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([kv[..., :dn], k_rope_h], -1)
    o = plain_attention(q.transpose(1, 2), k.transpose(1, 2), kv[..., dn:].transpose(1, 2),
                        causal=True, chunk=attn_chunk)
    o = o.transpose(1, 2)  # [B, S, H, dv]
    return (dense_proj(cfg, o.reshape(*o.shape[:-2], -1), p["wo"],
                       shard=("row", cfg.padded_heads)), latent, k_rope)


def mla_forward(cfg: ArchConfig, p: dict, x, rows: StepRows, attn_chunk: int = 0):
    """Training forward and prefill attention of an MLA layer: x [B,S,D] at
    ``rows.positions`` [S] -> [B,S,D]."""
    return _mla_attend(cfg, p, x, rows, attn_chunk)[0]


def mla_prefill(cfg: ArchConfig, p: dict, x, rows: StepRows, attn_chunk: int = 0):
    """:func:`mla_forward` plus the prompt's cache ``{"kv": [B,S,kvr+dr]}``
    (the normed latent and the rotated shared key)."""
    out, latent, k_rope = _mla_attend(cfg, p, x, rows, attn_chunk)
    return out, {"kv": torch.cat([latent, k_rope.to(latent.dtype)], -1)}


def mla_decode(cfg: ArchConfig, p: dict, cache: dict, x, rows: StepRows):
    """Weight-absorbed MLA decode: attention runs in the latent space over
    the fused ``[latent | k_rope]`` cache, which is never re-expanded.

    The new row is written in place: through the page table into the pool
    [P,ps,kvr+dr] (``rows.pages``), or at ``pos`` of the linear slot cache
    [B,S,kvr+dr] (dropped when ``pos >= S``).  The absorbed query
    ``[q_nope @ wk | q_rope]`` meets the cache in flash-decode as MQA (H
    query heads over one kv-head): the cache is both k (width kvr + dr)
    and v (its first kvr columns), at ``scale = (dn + dr)^-0.5``; the latent
    output expands through ``wv`` to the value heads."""
    dn, dr, kvr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    B = x.shape[0]
    xs = shared_input(x, p["wq_a"])
    q_nope, q_rope = _mla_q(cfg, p, xs, rows)  # [B,1,H,dn], [B,1,H,dr]
    latent, k_rope = _mla_latent(cfg, p, xs, rows)
    row = torch.cat([latent, k_rope.to(latent.dtype)], -1)[:, 0]  # [B, kvr+dr]
    pos = rows.pos0()
    kv = cache["kv"]
    if rows.pages is not None:
        rows.write(kv, row)
        layout = CacheLayout.PAGED
    else:
        _slot_write(kv, row, pos)
        layout = CacheLayout.LINEAR
    kv4 = kv[:, :, None]  # one kv-head: the same tensor as k and as v
    wkv_b = p["wkv_b"]  # [kvr, H, dn + dv], float under w8a8 too
    # the absorption einsums as batched products over the heads that sum
    # and store f32 and round once, as the reference's
    # preferred_element_type=F32 einsums
    q_lat = matmul_f32(q_nope[:, 0].transpose(0, 1), wkv_b[..., :dn].permute(1, 2, 0)) \
        .transpose(0, 1).to(q_nope.dtype)  # [B, H, kvr]
    q_cat = torch.cat([q_lat, q_rope[:, 0].to(q_lat.dtype)], -1).contiguous()
    o_lat = attend_decode(q_cat, kv4, kv4, pos, rows.start(0), layout=layout,
                          pages=rows.pages, scale=(dn + dr) ** -0.5, dv=kvr)
    o = matmul_f32(o_lat.transpose(0, 1), wkv_b[..., dn:].transpose(0, 1)) \
        .transpose(0, 1).to(o_lat.dtype)  # [B, H, dv]
    out = dense_proj(cfg, o.reshape(B, 1, -1), p["wo"], shard=("row", cfg.padded_heads))
    return out, {"kv": kv}


# ---------------------------------------------------------------------------
# Cross-attention sub-block (Llama-3.2-Vision style)
# ---------------------------------------------------------------------------

def cross_attn_specs(cfg: ArchConfig) -> dict:
    """The projections of :func:`attn_specs` and a scalar ``gate`` (zeros:
    ``tanh(0) = 0`` closes the sub-block until the gate is trained)."""
    p = attn_specs(cfg)
    p["gate"] = ParamSpec((), (), "zeros")
    return p


def cross_attn(cfg: ArchConfig, p: dict, x, img=None, img_kv=None):
    """Text rows x [B,S,D] attend over the image: keys and values from the
    projected image embeddings ``img`` [B,T,D] (prefill, training), or the
    cached ``img_kv`` = (k, v) [B,T,K,dh] (decode).  No RoPE; bidirectional,
    through the dense flash-attention kernel at Sq = S (1 at decode) over
    Sk = T (its plain version when autograd records: :func:`dense_attention`).
    The output is gated by ``tanh(gate)``.  Under w8a8 the image's
    k and v projections share one quantize.  Returns (out, (k, v))."""
    H, K, dh = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    if img_kv is None:  # the image enters the region once for both projections
        xs = tp_input(shared_input(img, p["wk"]), p["wk"], ("col", K))
        k = dense_proj(cfg, xs, p["wk"], (K, dh), shard=("col", K), entered=True)
        v = dense_proj(cfg, xs, p["wv"], (K, dh), shard=("col", K), entered=True)
        if "q_norm" in p:  # replicated scales on this rank's heads, as in _qkv
            k = rms_only(k, tp_input(p["k_norm"], p["k_norm"], ("col", K)))
    else:
        k, v = img_kv
    q = dense_proj(cfg, x, p["wq"], (H, dh), shard=("col", H))
    if "q_norm" in p:
        q = rms_only(q, tp_input(p["q_norm"], p["q_norm"], ("col", H)))
    o = dense_attention(q.transpose(1, 2), local_kv(cfg, k, 2).transpose(1, 2),
                        local_kv(cfg, v, 2).transpose(1, 2), causal=False)
    o = o.transpose(1, 2)  # [B, S, H, dh]; free on the card
    o = dense_proj(cfg, o.reshape(*o.shape[:-2], -1), p["wo"], shard=("row", H))
    return torch.tanh(p["gate"].to(F32)).to(o.dtype) * o, (k, v)


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU, GeGLU, GELU MLP)
# ---------------------------------------------------------------------------

def ffn_kind(cfg: ArchConfig) -> str:
    if cfg.name.startswith("gemma"):
        return "geglu"
    if cfg.family == "audio":
        return "gelu_mlp"
    return "swiglu"


def ffn_specs(cfg: ArchConfig) -> dict:
    D, Fdim = cfg.d_model, cfg.d_ff
    if ffn_kind(cfg) == "gelu_mlp":
        return {"w1": ParamSpec((D, Fdim), ("embed", "ffn")),
                "b1": ParamSpec((Fdim,), ("ffn",), "zeros"),
                "w2": ParamSpec((Fdim, D), ("ffn", "embed")),
                "b2": ParamSpec((D,), ("embed",), "zeros")}
    return {"w_gate": ParamSpec((D, Fdim), ("embed", "ffn")),
            "w_up": ParamSpec((D, Fdim), ("embed", "ffn")),
            "w_down": ParamSpec((Fdim, D), ("ffn", "embed"))}


def ffn_forward(cfg: ArchConfig, p: dict, x):
    """SwiGLU / GeGLU, or the audio encoder's GELU MLP ``gelu(x w1 + b1) w2
    + b2``: each bias added in the compute dtype after the GEMM's store, and
    the tanh form of GELU (``jax.nn.gelu``'s default), as the reference."""
    Fdim = cfg.d_ff
    if ffn_kind(cfg) == "gelu_mlp":
        dt = cfg.compute_dtype
        h = dense_proj(cfg, x, p["w1"], shard=("col", Fdim)) + p["b1"].to(dt)
        return dense_proj(cfg, F.gelu(h, approximate="tanh"), p["w2"],
                          shard=("row", Fdim)) + p["b2"].to(dt)
    xs = tp_input(shared_input(x, p["w_gate"]), p["w_gate"], ("col", Fdim))
    g = dense_proj(cfg, xs, p["w_gate"], shard=("col", Fdim), entered=True)
    u = dense_proj(cfg, xs, p["w_up"], shard=("col", Fdim), entered=True)
    act = (F.gelu(g, approximate="tanh") if ffn_kind(cfg) == "geglu"
           else F.silu(g))
    return dense_proj(cfg, act * u, p["w_down"], shard=("row", Fdim))


# ---------------------------------------------------------------------------
# MoE FFN — capacity-factor top-k dispatch (Switch-style)
# ---------------------------------------------------------------------------

def moe_specs(cfg: ArchConfig) -> dict:
    """The router (f32, its own dtype in the reference too) and ``E``
    stacked SwiGLU experts."""
    D, Fdim, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        "router": ParamSpec((D, E), ("embed", "experts"), "normal", F32),
        "w_gate": ParamSpec((E, D, Fdim), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((E, D, Fdim), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((E, Fdim, D), ("experts", "ffn", "embed")),
    }


def moe_capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    """Slots per expert and group: ``T * k * capacity_factor / E``, at
    least 4 and a multiple of 4 (the reference's arithmetic)."""
    c = int(tokens_per_group * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(4, round_up(max(c, 1), 4))


class MoeRoute(NamedTuple):
    """Routing of one MoE call over xt [G, T, D]: ``probs`` [G, T, E] f32,
    the top-k experts ``topi`` [G, T, k] (descending probability) with
    their renormalised weights ``topw``, each choice's slot ``pos`` within
    its expert (a choice at ``pos >= C`` is dropped) and the capacity
    ``C``."""
    probs: torch.Tensor
    topi: torch.Tensor
    topw: torch.Tensor
    pos: torch.Tensor
    C: int

    @property
    def kept(self):
        return self.pos < self.C


class GroupSpan(NamedTuple):
    """One dispatch group whose tokens lie on ``s`` consecutive batch
    ranks, ``T / s`` a rank, this rank holding slice ``j``.  ``gather``
    takes this slice's choices of each expert at each priority, [k, E]
    int32, to every slice's [s, k, E], in slice order."""
    s: int
    j: int
    gather: Callable


def moe_route(cfg: ArchConfig, p: dict, xt, span: GroupSpan | None = None) -> MoeRoute:
    """The router of :func:`moe_forward`.  Logits ``xt @ router`` in f32,
    as the reference's einsum (with TF32 off, as everywhere in the port: a
    TF32 router flips top-k choices).  Then softmax, top-k, weights
    renormalised.  Slots go by first-choice priority: a
    choice's slot is the count of earlier choices of its expert in (k, t)
    order, so every token's first choice is placed before any second
    choice.

    ``span``: xt [1, T/s, D] is slice j of a group of T tokens spread over
    s ranks (:class:`GroupSpan`).  The capacity is the group's,
    ``moe_capacity(T)``, and a priority-k choice of expert e at local token
    t takes the slot the whole group's (k, t) order gives it: every slice's
    choices of e at priorities below k, then slices 0..j-1's at priority k,
    then this slice's before t.  Only the slices' integer counts cross
    ranks (``span.gather``); each token's route is its own.

    ``torch.topk`` does not promise the lower index on a tie, as
    ``lax.top_k`` does: the two frameworks agree wherever the k-th and
    (k+1)-th probabilities differ.  The one-hot is a comparison with
    ``arange(E)`` (no ``F.one_hot``: it checks its input on the device and
    syncs, which a CUDA graph cannot capture)."""
    G, T, D = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(xt.float() @ p["router"].float(), -1)
    topw, topi = torch.topk(probs, k, -1)  # [G, T, k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    sel = topi.transpose(1, 2).reshape(G, k * T)  # priority-major (k, t)
    onehot = sel[..., None] == torch.arange(E, device=xt.device)  # [G, kT, E]
    count = torch.cumsum(onehot, 1)  # choices of each expert so far, this one included
    pos = torch.gather(count, 2, sel[..., None]).reshape(G, k, T).transpose(1, 2) - 1
    if span is None:
        return MoeRoute(probs, topi, topw, pos, moe_capacity(cfg, T))
    if G != 1:
        raise ValueError(f"a group spread over ranks is one group a rank, not {G}")
    mine = onehot.view(k, T, E).sum(1, dtype=torch.int32)  # this slice's [k, E]
    every = span.gather(mine)  # [s, k, E]
    other = every.sum(0) - mine  # the other slices' choices at each priority
    # the local cumsum counts this slice's lower priorities; add the other
    # slices' lower priorities and the earlier slices' at the same one
    extra = torch.cumsum(other, 0) - other + every[:span.j].sum(0)  # [k, E]
    pos = pos + torch.gather(extra, 1, topi[0].transpose(0, 1)).transpose(0, 1)[None]
    return MoeRoute(probs, topi, topw, pos, moe_capacity(cfg, T * span.s))


def _group_layout(cfg: ArchConfig, tokens: int):
    """(G, span) of this rank's ``tokens`` (its rows of a step's batch, split
    n ways over ``current_batch_axes``): the step's ``groups = max(1,
    min(num_moe_groups, n * tokens))`` dispatch groups (the reference's
    clamp, of the global batch) are ``G = groups / n`` whole groups a rank
    where n divides them; where they divide n, one group spans ``s = n /
    groups`` consecutive batch ranks (``launch.sharding.batch_rows``'
    order, pod-major) and this rank is its slice ``b % s`` (G = 1 and a
    :class:`GroupSpan`).  Where s divides the minor batch axis (the
    ``"fsdp"`` profile's groups are its lines), the counts are gathered
    over that axis alone."""
    mesh, axes = current_mesh(), current_batch_axes()
    n, b = 1, 0  # the batch split's ranks; this rank's index in it
    for a in axes:
        n, b = n * mesh.size(a), b * mesh.size(a) + mesh.index(a)
    groups = max(1, min(cfg.num_moe_groups, n * tokens))
    if groups % n == 0:
        return groups // n, None
    if n % groups:
        raise NotImplementedError(
            f"{cfg.name}: {groups} MoE dispatch groups over a batch split {n} ways: neither "
            f"divides the other, so a rank's rows are neither whole groups nor one slice "
            f"of a group (ROADMAP Queue 3); prepare_arch makes pod * data groups")
    s = n // groups
    minor = [a for a in axes if mesh.size(a) > 1][-1]
    over, first = (minor, mesh.index(minor) // s * s) if mesh.size(minor) % s == 0 \
        else (axes, b // s * s)

    def gather(c):
        return mesh.all_gather(c[None], over, 0)[first:first + s]
    return 1, GroupSpan(s, b % s, gather)


class _BmmF32(torch.autograd.Function):
    """``a @ b`` (2-D, or batched 3-D) as f32 of two bf16 operands: the
    reference's einsum with ``preferred_element_type=F32``.  On the card
    (and on meta, whose dry run follows the card) the bf16 product itself
    writes f32 (``mm`` / ``bmm``'s ``out_dtype``), so no f32 copy of an
    operand is made or saved; the CPU lacks that product and casts the
    operands (the same values: a bf16 product is exact in f32).
    ``out_dtype`` has no derivative in PyTorch: the backward is the f32
    products an f32 product of the cast operands would run, each gradient
    cast back to its operand's dtype, as the reference's transpose does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cpu":
            return torch.matmul(a.float(), b.float())
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype) \
            if ctx.needs_input_grad[0] else None
        db = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype) \
            if ctx.needs_input_grad[1] else None
        return da, db


def matmul_f32(a, b):
    """``a @ b`` (2-D or batched 3-D) accumulated and stored in f32 (the
    reference's ``preferred_element_type=F32``; analysis rule J002):
    :class:`_BmmF32` for bf16 / f16 operands, the plain product for f32
    (and f64) ones."""
    if a.dtype in (torch.bfloat16, torch.float16):
        return _BmmF32.apply(a, b)
    return torch.matmul(a, b)


def moe_forward(cfg: ArchConfig, p: dict, x):
    """x: [B, S, D] -> (out [B, S, D], route).  The reference's capacity-routed
    MoE (``repro.models.layers.moe_forward``, its unsharded expert block):
    tokens in ``G = max(1, min(num_moe_groups, B*S))`` groups of T, routed
    by :func:`moe_route`, ``C = moe_capacity(T)`` slots per expert and
    group.  Every row of x takes capacity, padding and idle rows included
    (a chunk buffer's zero tail, a decode batch's frozen and empty slots),
    as the reference's callers feed it.

    Dispatch gathers each slot's token row ([E, G*C, D]; an empty slot is a
    zero row); every expert runs SwiGLU on all its slots (batched matmuls
    summing in f32, rounded to the compute dtype, as the reference's
    ``preferred_element_type=F32`` einsums).  The combine is a gather: each
    token adds ``out_slot * weight`` (each product rounded to the compute
    dtype) over its kept choices in ascending expert order, rounding after
    each add -- the order of the reference's scatter-add over slots, with
    no float atomics (``index_add_`` on the card is not deterministic).
    The token -> slot inversion is an integer ``scatter_`` with dropped
    choices sent to a trash slot; nothing here syncs with the host, so the
    decode step captures.  The reference's second result, the aux loss,
    is :func:`moe_aux` of the returned route (serving does not need it).

    In a mesh's train step each batch rank holds its own rows of the batch
    (``current_batch_axes``, n ranks) and routes them
    (:func:`_group_layout`) as ``num_moe_groups / n`` whole groups
    (``prepare_arch`` makes the groups the data ranks, so under ``"2d"`` one
    a rank), or, where a group spans ranks (the ``"fsdp"`` profile, whose
    batch splits over ``model`` too), as its slice of one group, whose slots
    the ranks place together from each other's int32 choice counts
    (:class:`GroupSpan`); dispatch, experts and combine run on the rank's
    own tokens.

    The experts under tensor parallelism (model axis tp), the route
    computed whole on every rank:

    - expert-parallel (``cfg.moe_shard_map``, tp divides E: the
      reference's ``_moe_expert_block(axis="model")``): this rank
      dispatches, runs and combines only the choices of its ``E / tp``
      experts (its slice of the expert weights), and one f32 all-reduce
      over the model group sums the partial outputs;
    - FFN-parallel (tp does not divide E and divides ``moe_d_ff``: the
      weights' ``ffn`` dim is cut, and the reference leaves its whole
      expert block to XLA's partitioner): every rank runs all E experts on
      its ``moe_d_ff / tp`` columns of gate / up and rows of down,
      Megatron's column / row split inside each expert.  The down product
      stays f32, the combine sums the f32 partials and one f32 all-reduce
      of the [G, T, D] output over the model group is cast to the compute
      dtype (in bf16 a rounding order other than the reference's, ROADMAP
      Queue 3).

    Either way the tokens it dispatches and their routing weights enter the
    tensor-parallel region and its partial output leaves it (``enter_tp`` /
    ``leave_tp``)."""
    B, S, D = x.shape
    E, k, dt = cfg.num_experts, cfg.experts_per_token, cfg.compute_dtype
    mesh = current_mesh()
    G, span = _group_layout(cfg, B * S)
    T = (B * S) // G
    dev = x.device
    xt = x.reshape(G, T, D)
    r = moe_route(cfg, p, xt, span)
    C, GC = r.C, G * r.C
    El, Fl = p["w_gate"].shape[0], p["w_gate"].shape[-1]  # this rank's experts, FFN width
    base, mine, w_route = 0, r.kept, r.topw
    if El != E:
        if not cfg.moe_shard_map or mesh is None or E != El * mesh.size("model"):
            raise ValueError(f"{El} of {E} experts held: expert-parallel MoE needs "
                             f"cfg.moe_shard_map and a mesh whose model axis is E / {El}")
        base = mesh.index("model") * El
        mine = mine & (r.topi >= base) & (r.topi < base + El)
    cut = Fl != cfg.moe_d_ff
    if cut and (El != E or cfg.moe_d_ff != Fl * tp_size()):
        raise ValueError(f"{Fl} of each expert's {cfg.moe_d_ff} FFN columns held: an FFN "
                         f"cut needs all {E} experts and a tensor-parallel model axis of "
                         f"{cfg.moe_d_ff} / {Fl}")
    if El != E or cut:
        xt, w_route = enter_tp(xt, mesh), enter_tp(r.topw, mesh)
    # slot of each choice as a row of the [El, G, C] expert batch; El*G*C is
    # the trash row / the zero row of the combine (another rank's choices
    # and dropped ones point there)
    grp = torch.arange(G, device=dev)[:, None, None]
    row = torch.where(mine, (r.topi - base) * GC + grp * C + r.pos, El * GC)  # [G, T, k]
    tok = (torch.arange(G * (T + 1), device=dev).reshape(G, T + 1)[:, 1:, None]
           .expand(G, T, k))  # the token's row in x_pad
    slot_tok = torch.zeros(El * GC + 1, dtype=torch.int64, device=dev)
    slot_tok.scatter_(0, row.reshape(-1), tok.reshape(-1))
    # x_pad: every group's row 0 is zero (an empty slot points there, to the
    # first group's: also zero)
    xd = xt.to(dt)
    x_pad = torch.cat([xd.new_zeros(G, 1, D), xd], 1).reshape(-1, D)
    ein = x_pad.index_select(0, slot_tok[:-1]).view(El, GC, D)
    # the reference's three einsums with preferred_element_type=F32: each
    # product accumulates and stores f32 and is cast once
    h = F.silu(matmul_f32(ein, p["w_gate"]).to(dt)) * matmul_f32(ein, p["w_up"]).to(dt)
    eout = matmul_f32(h, p["w_down"])
    if not cut:  # an FFN cut keeps this rank's f32 partial of every slot's output
        eout = eout.to(dt)
    eout = eout.view(El * GC, D)
    eout = torch.cat([eout, eout.new_zeros(1, D)])
    order = torch.argsort(r.topi, -1)  # each token's choices by expert id
    rows = torch.gather(row, -1, order)
    w = torch.gather(w_route, -1, order).to(eout.dtype)
    terms = eout.index_select(0, rows.reshape(-1)).view(G, T, k, D) * w[..., None]
    out = terms[:, :, 0]
    for j in range(1, k):
        out = out + terms[:, :, j]
    if El != E or cut:
        out = leave_tp(out, mesh).to(dt)
    return out.reshape(B, S, D), r


def moe_aux(cfg: ArchConfig, r: MoeRoute):
    """The Switch load-balancing loss of one :func:`moe_forward` call,
    ``E * sum_e f_e * p_e``: f_e the share of all (token, choice) pairs
    that chose e, dropped ones included; p_e the mean router probability.
    In a mesh's train step both means run over every group of the step:
    this rank's groups' means averaged over the batch axes
    (``mean_across``) before their product."""
    E = cfg.num_experts
    load = (r.topi[..., None] == torch.arange(E, device=r.topi.device)).sum((0, 1, 2))
    me, fe = r.probs.mean((0, 1)), load.to(F32) / r.topi.numel()
    axes = current_batch_axes()
    if axes:
        me, fe = mean_across(me, current_mesh(), axes), mean_across(fe, current_mesh(), axes)
    return E * torch.sum(me * fe)
