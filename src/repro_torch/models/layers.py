"""Transformer layers (port of ``repro.models.layers``).

Every weight-activation matmul funnels through :func:`dense_proj` (the block
GEMM, or the packed int8 GEMM for ``QTensor`` weights under w8a8),
whole-prompt attention through the dense flash-attention kernel,
chunked-prefill attention through the paged one, and decode attention
through flash-decode on page pools or on linear / ring slot caches.  A
tensor's device chooses between each kernel and its plain version.

Caches are updated **in place** (the JAX engine donates them instead).  A
pool made by ``model.init_paged_cache`` has one spare *drop row* in its
storage right past its last page: a write whose row falls off the page
table, or that belongs to a chunk's padding, lands there — the counterpart
of JAX's ``.at[].set(mode="drop")`` with no host round trip, and never a
clamp onto a real row.  A slot cache drops a write past its last row by
writing that row's old value back (:func:`_slot_write`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cache import CacheLayout
from repro_torch.core.gemm import cgra_gemm, cgra_gemm_w8a8, quantize_act
from repro_torch.core.quant import QTensor
from repro_torch.kernels.ops import attend_decode, attention
from repro_torch.models.params import ParamSpec

F32 = torch.float32


# ---------------------------------------------------------------------------
# Dense projection — the single GEMM choke point of the model
# ---------------------------------------------------------------------------

def dense_proj(cfg: ArchConfig, x, w, out_shape: tuple = (), out_dtype=None):
    """x: [..., K] @ w -> [..., N] (or [..., *out_shape]).  ``w`` is a float
    weight whose dims reshape row-major to [K, N] (wq [D,H,dh] -> [D, H*dh];
    wo [H,dh,D] -> [H*dh, D] with the caller flattening x's head dims),
    stored in the compute dtype at load, or a ``QTensor`` packed by
    ``model.quantize_params`` (q [N, K] int8), served by the int8 GEMM.
    ``out_dtype`` overrides the accumulator's store dtype (default the
    compute dtype; the LM head asks for f32).  Under w8a8, ``x`` may be the
    activation already quantized by :func:`shared_input` (one quantize for
    every projection that reads it)."""
    if isinstance(w, QTensor):
        out = cgra_gemm_w8a8(x, w, out_dtype=out_dtype or cfg.compute_dtype)
    else:
        out = cgra_gemm(x, w.reshape(x.shape[-1], -1), out_dtype=out_dtype)
    if out_shape:
        out = out.reshape(*out.shape[:-1], *out_shape)
    return out


def shared_input(x, w):
    """``x`` for several projections with weights like ``w``: quantized once
    here when ``w`` is a w8a8 ``QTensor`` (the int8 values and every output
    stay bit-identical to quantizing per projection), else ``x``."""
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
    q = dense_proj(cfg, xs, p["wq"], (H, dh))
    k = dense_proj(cfg, xs, p["wk"], (K, dh))
    v = dense_proj(cfg, xs, p["wv"], (K, dh))
    if "q_norm" in p:
        q = rms_only(q, p["q_norm"])
        k = rms_only(k, p["k_norm"])
    return q, k, v


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

    def __init__(self, positions, pages, n=None):
        self.positions = positions
        self.pages = pages
        self.n = n
        self._cache: dict = {}

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
    idx = rows.rows(cache["k"])
    k = _write_rows(cache["k"], k_new.reshape(B * S, *k_new.shape[2:]), idx)
    v = _write_rows(cache["v"], v_new.reshape(B * S, *v_new.shape[2:]), idx)
    return q, k, v


def attn_forward(cfg: ArchConfig, p: dict, x, rows: StepRows, *, local: bool,
                 past_kv=None):
    """Whole-prompt self-attention (training forward and prefill).  x:
    [B,S,D] at ``rows.positions`` [S]; ``past_kv`` ({"k","v"} [B,s,K,dh],
    post-RoPE) is a cached prefix the prompt continues: attention runs over
    concat(past, new) with the last query aligned with the last key.
    Returns (out, k, v) with the new rows' post-RoPE k/v [B,S,K,dh]."""
    q, k, v = _qkv_rope(cfg, p, x, rows, local)
    k_all, v_all = k, v
    if past_kv is not None:
        k_all = torch.cat([past_kv["k"].to(k.dtype), k], 1)
        v_all = torch.cat([past_kv["v"].to(v.dtype), v], 1)
    o = attention(q.transpose(1, 2), k_all.transpose(1, 2), v_all.transpose(1, 2),
                  causal=True, window=cfg.window_size if local else 0,
                  softcap=cfg.logit_softcap)
    o = o.transpose(1, 2)  # [B, S, H, dh]; free on the card (see flash_attention)
    out = dense_proj(cfg, o.reshape(*o.shape[:-2], -1), p["wo"])
    return out, k, v


def attn_prefill(cfg: ArchConfig, p: dict, x, rows: StepRows, *, local: bool,
                 past_kv=None):
    """:func:`attn_forward` that also returns the prompt's cache (post-RoPE
    k/v of the new rows).  A sliding-window layer keeps only the last
    ``window`` rows, rolled so that entry ``pos % window`` holds row ``pos``:
    decode continues the ring.  Returns (out, {"k", "v"})."""
    out, k, v = attn_forward(cfg, p, x, rows, local=local, past_kv=past_kv)
    window = cfg.window_size if local else 0
    S = k.shape[1]
    if window and past_kv is None and S > window:
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
    o = attention(q.transpose(1, 2), k, v, window=window,
                  softcap=cfg.logit_softcap, pages=rows.pages,
                  q_start=rows.pos0(), k_len=rows.k_len())
    o = o.transpose(1, 2)  # [B, C, H, dh]; free on the card (see flash_attention_paged)
    out = dense_proj(cfg, o.reshape(*o.shape[:-2], -1), p["wo"])
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
        o = attend_decode(q[:, 0].contiguous(), k, v, rows.pos0(),
                          rows.start(window), layout=CacheLayout.PAGED,
                          pages=rows.pages, softcap=cfg.logit_softcap)
    else:
        q, k_new, v_new = _qkv_rope(cfg, p, x, rows, local)
        k, v = cache["k"], cache["v"]
        ring = bool(local and cfg.window_size)
        pos = rows.pos0()
        widx = torch.remainder(pos, k.shape[1]) if ring else pos
        _slot_write(k, k_new[:, 0], widx)
        _slot_write(v, v_new[:, 0], widx)
        o = attend_decode(q[:, 0].contiguous(), k, v, pos, rows.start(0),
                          layout=CacheLayout.RING if ring else CacheLayout.LINEAR,
                          softcap=cfg.logit_softcap)
    out = dense_proj(cfg, o.reshape(B, 1, -1), p["wo"])
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU, GeGLU)
# ---------------------------------------------------------------------------

def ffn_kind(cfg: ArchConfig) -> str:
    if cfg.name.startswith("gemma"):
        return "geglu"
    if cfg.family == "audio":
        return "gelu_mlp"
    return "swiglu"


def ffn_specs(cfg: ArchConfig) -> dict:
    if ffn_kind(cfg) == "gelu_mlp":
        raise NotImplementedError("the GELU MLP FFN is not ported yet")
    D, Fdim = cfg.d_model, cfg.d_ff
    return {"w_gate": ParamSpec((D, Fdim), ("embed", "ffn")),
            "w_up": ParamSpec((D, Fdim), ("embed", "ffn")),
            "w_down": ParamSpec((Fdim, D), ("ffn", "embed"))}


def ffn_forward(cfg: ArchConfig, p: dict, x):
    xs = shared_input(x, p["w_gate"])
    g = dense_proj(cfg, xs, p["w_gate"])
    u = dense_proj(cfg, xs, p["w_up"])
    act = (F.gelu(g, approximate="tanh") if ffn_kind(cfg) == "geglu"
           else F.silu(g))
    return dense_proj(cfg, act * u, p["w_down"])
