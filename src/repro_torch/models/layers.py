"""Transformer layers on the serving path (port of ``repro.models.layers``).

Every weight-activation matmul funnels through :func:`dense_proj` (the block
GEMM), chunked-prefill attention through the paged flash-attention kernel
and decode attention through paged flash-decode.  A tensor's device chooses
between each kernel and its plain version.

Page pools are updated **in place** (the JAX engine donates them instead).
A pool made by ``model.init_paged_cache`` has one spare *drop row* in its
storage right past its last page: a write whose row falls off the page
table, or that belongs to a chunk's padding, lands there — the counterpart
of JAX's ``.at[].set(mode="drop")`` with no host round trip, and never a
clamp onto a real row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cache import CacheLayout
from repro_torch.core.gemm import cgra_gemm
from repro_torch.kernels.ops import attend_decode, attention
from repro_torch.models.params import ParamSpec

F32 = torch.float32


# ---------------------------------------------------------------------------
# Dense projection — the single GEMM choke point of the model
# ---------------------------------------------------------------------------

def dense_proj(cfg: ArchConfig, x, w, out_shape: tuple = (), out_dtype=None):
    """x: [..., K] @ w -> [..., N] (or [..., *out_shape]).  ``w``'s dims
    reshape row-major to [K, N] (wq [D,H,dh] -> [D, H*dh]; wo [H,dh,D] ->
    [H*dh, D] with the caller flattening x's head dims).  Weights are stored
    in the compute dtype at load, so no cast happens here.  ``out_dtype``
    overrides the accumulator's store dtype (the LM head asks for f32)."""
    out = cgra_gemm(x, w.reshape(x.shape[-1], -1), out_dtype=out_dtype)
    if out_shape:
        out = out.reshape(*out.shape[:-1], *out_shape)
    return out


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
# GQA attention over paged KV pools
# ---------------------------------------------------------------------------

def attn_specs(cfg: ArchConfig) -> dict:
    H, K, dh = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    D = cfg.d_model
    if cfg.use_qk_norm:
        raise NotImplementedError("qk-norm is not ported yet")
    return {
        "wq": ParamSpec((D, H, dh), ("embed", "heads", "qk")),
        "wk": ParamSpec((D, K, dh), ("embed", "kv_heads", "qk")),
        "wv": ParamSpec((D, K, dh), ("embed", "kv_heads", "qk")),
        "wo": ParamSpec((H, dh, D), ("heads", "qk", "embed")),
    }


def attn_cache_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    K, dh = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": ParamSpec((batch, seq, K, dh), ("batch", "kv_seq", "kv_heads", "qk"), "zeros"),
        "v": ParamSpec((batch, seq, K, dh), ("batch", "kv_seq", "kv_heads", "qk"), "zeros"),
    }


def _qkv(cfg, p, x):
    H, K, dh = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense_proj(cfg, x, p["wq"], (H, dh))
    k = dense_proj(cfg, x, p["wk"], (K, dh))
    v = dense_proj(cfg, x, p["wv"], (K, dh))
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
    the step's positions [B, S], RoPE tables per theta, the pool rows its
    new KV lands in, and the attention bounds.  ``n`` [B] is the valid row
    count of a chunk (None for decode: every row is valid)."""

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


def _attn_inputs(cfg, p, cache, x, rows: StepRows, local: bool):
    """q/k/v projections, RoPE on q and k, and the new KV written through
    the page table in place.  Returns (q, k_pool, v_pool)."""
    B, S = x.shape[0], x.shape[1]
    q, k_new, v_new = _qkv(cfg, p, x)
    tables = rows.rope(q.shape[-1], cfg.rope_theta if not local else 10_000.0)
    q = apply_rope(q, tables)
    k_new = apply_rope(k_new, tables)
    idx = rows.rows(cache["k"])
    k = _write_rows(cache["k"], k_new.reshape(B * S, *k_new.shape[2:]), idx)
    v = _write_rows(cache["v"], v_new.reshape(B * S, *v_new.shape[2:]), idx)
    return q, k, v


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
    o = attention(q.transpose(1, 2).contiguous(), k, v, window=window,
                  softcap=cfg.logit_softcap, pages=rows.pages,
                  q_start=rows.pos0(), k_len=rows.k_len())
    o = o.transpose(1, 2).contiguous()  # [B, C, H, dh]
    out = dense_proj(cfg, o.reshape(*o.shape[:-2], -1), p["wo"])
    return out, {"k": k, "v": v}


def attn_decode(cfg: ArchConfig, p: dict, cache: dict, x, rows: StepRows, *,
                local: bool):
    """One-token decode over page pools.  x: [B,1,D]; ``rows`` holds the
    current rows ``pos`` ([B, 1] positions) and the page tables.  The new
    row is written through the table in place, then attention follows the
    table over rows ``[start, pos]`` (``start = max(0, pos - window + 1)``
    on sliding-window layers, else 0)."""
    B = x.shape[0]
    q, k, v = _attn_inputs(cfg, p, cache, x, rows, local)
    window = cfg.window_size if local else 0
    o = attend_decode(q[:, 0].contiguous(), k, v, rows.pos0(),
                      rows.start(window), layout=CacheLayout.PAGED,
                      pages=rows.pages, softcap=cfg.logit_softcap)
    out = dense_proj(cfg, o.reshape(B, 1, -1), p["wo"])
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

def ffn_kind(cfg: ArchConfig) -> str:
    if cfg.name.startswith("gemma"):
        return "geglu"
    if cfg.family == "audio":
        return "gelu_mlp"
    return "swiglu"


def ffn_specs(cfg: ArchConfig) -> dict:
    if ffn_kind(cfg) != "swiglu":
        raise NotImplementedError(f"{ffn_kind(cfg)} FFN is not ported yet")
    D, Fdim = cfg.d_model, cfg.d_ff
    return {"w_gate": ParamSpec((D, Fdim), ("embed", "ffn")),
            "w_up": ParamSpec((D, Fdim), ("embed", "ffn")),
            "w_down": ParamSpec((Fdim, D), ("ffn", "embed"))}


def ffn_forward(cfg: ArchConfig, p: dict, x):
    g = dense_proj(cfg, x, p["w_gate"])
    u = dense_proj(cfg, x, p["w_up"])
    return dense_proj(cfg, torch.nn.functional.silu(g) * u, p["w_down"])
