"""Mamba-2 SSD (state-space duality) block (port of ``repro.models.ssd``).

The chunked SSD algorithm re-expresses the selective-SSM recurrence as
block-diagonal products (intra-chunk) plus a short inter-chunk recurrence.
The reference computes it in plain JAX (einsums and a ``lax.scan``, no
Pallas kernel), so the port computes it in plain PyTorch: its products are
``torch.matmul``, on the card as on the CPU.

Layout: d_inner = expand * d_model, H = d_inner / headdim SSD heads of head
dim P, shared (n_groups = 1) B/C of state dim N.  The decode state of a
layer is ``h`` [B, H, P, N] (f32) and the raw pre-conv tails ``conv_x``
[B, W-1, H, P], ``conv_B`` / ``conv_C`` [B, W-1, N] (compute dtype);
:func:`ssd_decode` writes all four **in place** into the tensors it is
given (views of the stacked cache leaves, whose addresses a captured decode
graph keeps).

Under a mesh (``launch.sharding.activation_mesh``) the layer is
head-parallel, as the reference's logical axes place it: a rank holds its
heads' share of every ``"heads"`` leaf (``w_z``, ``w_x``, ``w_dt``,
``conv_x``, ``dt_bias``, ``A_log``, ``D_skip``, ``norm`` and ``w_out``;
the state's ``h`` and ``conv_x``), and ``w_B`` / ``w_C`` / ``conv_B`` /
``conv_C`` (axis ``"state"``) are whole on every rank.  Everything up to
the gated norm is per head, so it runs on the rank's heads as it is; the
norm's mean over (H, P) sums each rank's squares and joins the sums over
the model group (:func:`_gate_norm_out`); ``w_out`` is a row-parallel
``layers.dense_proj``.  The head count comes from the held weights, so a
model axis that does not divide H leaves every leaf whole and the layer
runs whole.  Under autograd (a mesh's train step) every tensor that is
whole on each rank but feeds only its heads enters the tensor-parallel
region once (``launch.mesh.enter_tp``): the per-head projections' input,
B and C past their conv, and the norm's joined sum; so the gradients of
x, ``w_B``, ``w_C``, ``conv_B`` and ``conv_C`` are summed over the model
group, and those of the ``"heads"`` leaves stay the rank's own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import enter_tp, leave_tp
from repro_torch.launch.sharding import current_mesh
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec

F32 = torch.float32


def ssd_specs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    W = cfg.ssm_conv_width
    return {
        "w_z": ParamSpec((D, H, P), ("embed", "heads", "qk")),
        "w_x": ParamSpec((D, H, P), ("embed", "heads", "qk")),
        "w_B": ParamSpec((D, N), ("embed", "state")),
        "w_C": ParamSpec((D, N), ("embed", "state")),
        "w_dt": ParamSpec((D, H), ("embed", "heads")),
        "dt_bias": ParamSpec((H,), ("heads",), "dt_bias", F32),
        "A_log": ParamSpec((H,), ("heads",), "ssm_a", F32),
        "D_skip": ParamSpec((H,), ("heads",), "ones", F32),
        "conv_x": ParamSpec((W, H, P), ("conv", "heads", "qk"), "normal"),
        "conv_B": ParamSpec((W, N), ("conv", "state"), "normal"),
        "conv_C": ParamSpec((W, N), ("conv", "state"), "normal"),
        "norm": ParamSpec((H, P), ("heads", "qk"), "ones"),
        "w_out": ParamSpec((H, P, D), ("heads", "qk", "embed")),
    }


def ssd_cache_specs(cfg: ArchConfig, batch: int) -> dict:
    """Slot-indexed decode state (no ``kv_seq`` axis: page pools keep these
    leaves as ``[R, max_batch, ...]``)."""
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    W = cfg.ssm_conv_width
    return {
        "h": ParamSpec((batch, H, P, N), ("batch", "heads", "qk", "state"), "zeros", F32),
        "conv_x": ParamSpec((batch, W - 1, H, P), ("batch", "conv", "heads", "qk"), "zeros"),
        "conv_B": ParamSpec((batch, W - 1, N), ("batch", "conv", "state"), "zeros"),
        "conv_C": ParamSpec((batch, W - 1, N), ("batch", "conv", "state"), "zeros"),
    }


def _causal_conv(x, w):
    """Depthwise causal conv by shifted adds, summed in the reference's
    order.  x: [B, S, *ch], w: [W, *ch] -> [B, S, *ch]."""
    Wd, S = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], Wd - 1, *x.shape[2:])), x], 1)
    y = xp[:, 0:S] * w[0]
    for j in range(1, Wd):
        y = y + xp[:, j:j + S] * w[j]
    return y


def _conv_step(state, x, w):
    """One streaming conv step: ``state`` [B, W-1, *ch] prefixes x [B, 1,
    *ch].  Returns (y [B, 1, *ch], new state [B, W-1, *ch])."""
    xc = torch.cat([state.to(x.dtype), x], 1)
    y = xc[:, 0:1] * w[0]
    for j in range(1, w.shape[0]):
        y = y + xc[:, j:j + 1] * w[j]
    return y, xc[:, 1:]


def _segsum(x):
    """x: [..., Q] -> lower-triangular cumulative segment sums [..., Q, Q]
    (-inf above the diagonal), as the reference forms them."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _heads(p: dict) -> int:
    """The SSD heads this rank holds (all of them off a mesh)."""
    return p["A_log"].shape[0]


def _proj_inputs(cfg: ArchConfig, p: dict, x):
    """The five input projections of x [B, S, D] (z / xs / dt on this
    rank's heads).  Every product accumulates and stores f32, as the
    reference's ``preferred_element_type=F32`` einsums (analysis rule
    J002); z / xs / B / C are cast once to the compute dtype (they feed the
    conv and gate path); dt stays f32, a product of f32 operands."""
    B_, S, D = x.shape
    H, P, N = _heads(p), cfg.ssm_headdim, cfg.ssm_state
    x2 = x.reshape(B_ * S, D)
    xh = _enter_heads(cfg, p, x2)  # the per-head projections' input
    dt_ = x.dtype
    z = L.matmul_f32(xh, p["w_z"].reshape(D, H * P)).to(dt_).reshape(B_, S, H, P)
    xs = L.matmul_f32(xh, p["w_x"].reshape(D, H * P)).to(dt_).reshape(B_, S, H, P)
    Bm = L.matmul_f32(x2, p["w_B"]).to(dt_).reshape(B_, S, N)
    Cm = L.matmul_f32(x2, p["w_C"]).to(dt_).reshape(B_, S, N)
    dt = (xh.to(F32) @ p["w_dt"].to(F32)).reshape(B_, S, H)
    return z, xs, Bm, Cm, dt


def _enter_heads(cfg: ArchConfig, p: dict, t):
    """``t`` (whole on every rank) entering this rank's heads: identity
    forward; under autograd the ranks' partial gradients are summed over
    the model group (``launch.mesh.enter_tp``).  ``t`` itself when the
    layer runs whole."""
    if _heads(p) == cfg.ssm_heads:
        return t
    return enter_tp(t, current_mesh())


def gated_rms(y, z, norm, heads: int, mesh=None):
    """y [B, S, h, P] (compute dtype) gated by silu(z), RMS-normed over
    (H, P) in f32 and scaled by ``norm`` [h, P]: the mean of the squares
    runs over all ``heads`` of the layer.  A rank holding ``h < heads`` of
    them sums its heads' squares in f32, the sums are joined over ``mesh``'s
    model group (f32) and the total is divided by ``heads * P``; off a mesh
    the mean is taken directly.  The joined sum feeds this rank's heads
    only, so under autograd its gradient is summed over the group too
    (``leave_tp`` then ``enter_tp``).  Returns the f32 normed rows."""
    P = y.shape[-1]
    yf = (y * F.silu(z)).to(F32)
    if y.shape[-2] == heads:
        ms = yf.square().mean((-2, -1), keepdim=True)
    else:
        ms = enter_tp(leave_tp(yf.square().sum((-2, -1), keepdim=True), mesh),
                      mesh) / (heads * P)
    return yf * torch.rsqrt(ms + 1e-6) * norm.to(F32)


def _gate_norm_out(cfg: ArchConfig, p: dict, y, z):
    """y [B, S, h, P] (compute dtype; this rank's heads) through
    :func:`gated_rms` and the row-parallel ``w_out`` to [B, S, D]."""
    B_, S, H, P = y.shape
    y = gated_rms(y, z, p["norm"], cfg.ssm_heads, current_mesh()).to(cfg.compute_dtype)
    return L.dense_proj(cfg, y.reshape(B_, S, H * P), p["w_out"],
                        shard=("row", cfg.ssm_heads))


def ssd_forward(cfg: ArchConfig, p: dict, x, return_cache: bool = False):
    """x [B, S, D] -> [B, S, D] by the chunked SSD algorithm.  The chunk Q is
    the largest divisor of S up to ``ssm_chunk`` (zero-padding would corrupt
    the decayed final state), so a prime S runs S chunks of one row.  With
    ``return_cache`` it also returns the decode state: the final ``h`` and
    the raw pre-conv tails of the last W-1 rows.  A prompt shorter than W-1
    rows has no full tail: it is refused (ValueError), where the reference
    fails to write its short tail into the cache (see ROADMAP Queue 3)."""
    B_, S, D = x.shape
    H, P, N = _heads(p), cfg.ssm_headdim, cfg.ssm_state
    W = cfg.ssm_conv_width
    if return_cache and S < W - 1:
        raise ValueError(f"an SSM prefill of {S} rows has no full conv tail of "
                         f"{W - 1} rows (ssm_conv_width {W})")
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    cdt = cfg.compute_dtype

    z, xs, Bm, Cm, dt = _proj_inputs(cfg, p, x)
    tails = [t[:, S - (W - 1):] for t in (xs, Bm, Cm)] if return_cache else None
    xs = F.silu(_causal_conv(xs, p["conv_x"].to(xs.dtype)))
    # B and C are whole on every rank and feed only its heads: entered once
    # here, past the conv, their gradients (and w_B's, w_C's, conv_B's,
    # conv_C's) are summed over the model group
    Bm = _enter_heads(cfg, p, F.silu(_causal_conv(Bm, p["conv_B"].to(Bm.dtype))))
    Cm = _enter_heads(cfg, p, F.silu(_causal_conv(Cm, p["conv_C"].to(Cm.dtype))))

    dt = F.softplus(dt + p["dt_bias"].to(F32))  # [B, S, H]
    A = -torch.exp(p["A_log"].to(F32))          # [H]

    xc = xs.reshape(B_, nc, Q, H, P)
    Bc = Bm.reshape(B_, nc, Q, N).to(F32)
    Cc = Cm.reshape(B_, nc, Q, N).to(F32)
    dtc = dt.reshape(B_, nc, Q, H)
    dA = dtc * A                                 # [B, nc, Q, H]
    dA_cs = torch.cumsum(dA, 2)
    xdt = (xc * dtc[..., None].to(xc.dtype)).to(F32)  # [B, nc, Q, H, P]

    # intra-chunk: the block-diagonal products
    Lm = torch.exp(_segsum(dA.permute(0, 3, 1, 2)))   # [B, H, nc, Q(l), Q(s)]
    CB = Cc @ Bc.transpose(-1, -2)                    # [B, nc, Q(l), Q(s)]
    Wls = CB[:, :, None] * Lm.permute(0, 2, 1, 3, 4)  # [B, nc, H, l, s]
    y_diag = (Wls @ xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk-final states: sum_s B[s, n] * decay[s, h] * xdt[s, h, p]
    decay = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # [B, nc, Q, H]
    xd = (xdt * decay[..., None]).reshape(B_, nc, Q, H * P)
    states = (xd.transpose(-1, -2) @ Bc).reshape(B_, nc, H, P, N)

    # inter-chunk recurrence, one step a chunk (the reference's lax.scan)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])[..., None, None]  # [B, nc, H, 1, 1]
    h = torch.zeros(B_, H, P, N, dtype=F32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c] + states[:, c]
    h_prev = torch.stack(h_prev, 1)                   # state entering each chunk

    # inter-chunk contribution: C[l] . h_prev, decayed into the chunk
    in_decay = torch.exp(dA_cs)                       # [B, nc, Q, H]
    Ch = Cc @ h_prev.permute(0, 1, 4, 2, 3).reshape(B_, nc, N, H * P)
    y_off = Ch.reshape(B_, nc, Q, H, P) * in_decay[..., None]

    y = (y_diag + y_off).to(cdt)
    y = y + xc * p["D_skip"].to(cdt)[:, None]
    out = _gate_norm_out(cfg, p, y.reshape(B_, S, H, P), z)
    if return_cache:
        cx, cB, cC = tails
        return out, {"h": h, "conv_x": cx, "conv_B": cB, "conv_C": cC}
    return out


def ssd_decode(cfg: ArchConfig, p: dict, cache: dict, x):
    """Single-token state update, x [B, 1, D] -> (out [B, 1, D], cache).
    ``h`` and the three conv tails of ``cache`` are overwritten in place
    with ``copy_``; nothing here syncs with the host or branches on device
    values, so the step captures into a CUDA graph."""
    z, xs, Bm, Cm, dt = _proj_inputs(cfg, p, x)
    xs, cx = _conv_step(cache["conv_x"], xs, p["conv_x"].to(xs.dtype))
    Bm, cB = _conv_step(cache["conv_B"], Bm, p["conv_B"].to(Bm.dtype))
    Cm, cC = _conv_step(cache["conv_C"], Cm, p["conv_C"].to(Cm.dtype))
    xs, Bm, Cm = F.silu(xs[:, 0]), F.silu(Bm[:, 0]), F.silu(Cm[:, 0])

    dt = F.softplus(dt + p["dt_bias"].to(F32))[:, 0]   # [B, H]
    A = -torch.exp(p["A_log"].to(F32))
    dA = torch.exp(dt * A)
    xf = xs.to(F32)                                     # [B, H, P]
    dBx = (dt[..., None] * xf)[..., None] * Bm.to(F32)[:, None, None, :]
    h = cache["h"] * dA[..., None, None] + dBx          # [B, H, P, N]
    y = (h @ Cm.to(F32)[:, None, :, None])[..., 0]      # [B, H, P]
    y = y + xf * p["D_skip"].to(F32)[:, None]
    out = _gate_norm_out(cfg, p, y[:, None].to(cfg.compute_dtype), z)
    for name, new in (("h", h), ("conv_x", cx), ("conv_B", cB), ("conv_C", cC)):
        cache[name].copy_(new)
    return out, cache
