"""Flash-attention wrappers: ``csrc/flash_attention.cu`` on the card, the
plain versions on the CPU.

Ports of ``repro.kernels.flash_attention.flash_attention`` (TPU kernel
``_fa_kernel``, dense) and ``_flash_attention_paged`` (``_fa_kernel_paged``,
chunked prefill over page pools).  Each wrapper's ``.launches`` counts its
launches.  Inside a dry run (``kernels.dry``) a meta tensor takes the CUDA
route up to the launch and reports the call instead.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.ref import flash_attention_paged_ref, flash_attention_ref
from repro_torch.kernels.spec import (READ, KernelSpec, OperandSpec, ScalarSpec, header_line,
                                      run_enumerator)

_DTYPES = (torch.float32, torch.bfloat16)
_SMEM_LIMIT = 227 * 1024  # an H100 block's dynamic shared memory
_fn = None
_fn_dense = None


def tc_tile(d: int) -> tuple[int, int]:
    """The tensor-core route's (D, key tile rows) for head dim d: d padded to
    a power of two >= 16, key tiles of 64 rows, 32 at D > 128
    (``index.cuh``'s ``fat_kt``)."""
    D = max(16, 1 << (d - 1).bit_length())
    return D, 32 if D > 128 else 64


def dense_smem_bytes(d: int, dtype) -> int:
    """Dynamic shared memory of one dense-attention block.  bf16 (tensor
    cores): 64 Q rows and a 2-stage ring of K and V tiles (:func:`tc_tile`),
    bf16, rows of D + 8 elements.  f32 (CUDA cores): 64 Q rows and 32 K rows
    of d + 1, 32 V rows of d, the 64 x 33 score tile and three 64-float row
    vectors."""
    if dtype == torch.bfloat16:
        D, kt = tc_tile(d)
        return 2 * (64 + 4 * kt) * (D + 8)
    return 4 * (96 * (d + 1) + 32 * d + 64 * 33 + 192)


def _entry_dense():
    global _fn_dense
    if _fn_dense is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn_dense = _build.bind("flash_attention", "repro_flash_attention",
                                [P] * 5 + [I] * 8 + [F, F, I, P])
    return _fn_dense


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: [B,H,Sq,d]; k/v: [B,K,Sk,d] with H % K == 0 -> [B,H,Sq,d].  Query
    row i sits at position ``i + Sk - Sq``; causal, window and softcap as
    ``flash_attention_ref``; rows with no valid key give 0.

    On the card any strides with a unit stride along d are read as they are
    (the layers pass transposed views of [B,S,H,d] tensors), and the result
    is a [B,H,Sq,d] view of a [B,Sq,H,d] buffer, so the caller's transpose
    back is free.  No backward (the reference's kernel has none either):
    training attention is the plain version, by rule (``models.layers``)."""
    _build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, softcap=softcap)
    if not dry.on_card(q):
        raise ValueError(f"flash_attention: q on {q.device}")
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or H % K or d > 256:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v need a unit stride along d")
    if dense_smem_bytes(d, q.dtype) > _SMEM_LIMIT:
        raise ValueError(f"flash_attention: head dim {d} exceeds shared memory")
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=dev).transpose(1, 2)
    if B == 0 or Sq == 0 or H == 0:
        return out
    if out.is_meta:
        pairs = attended_pairs(Sq, Sk, causal, window)
        dry.report("flash_attention", flops=4 * B * H * pairs * d,
                   nbytes=q.nbytes + k.nbytes + v.nbytes + out.nbytes, outputs=(out,))
        return out
    scale = scale if scale is not None else d ** -0.5
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    err = _entry_dense()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         strides, B, H, K, Sq, Sk, d, int(causal), int(window or 0),
                         float(scale), float(softcap or 0.0),
                         int(q.dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attended_pairs(Sq: int, Sk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs dense attention computes: every pair, or, causal,
    query row i (at position ``i + Sk - Sq``) over the ``min(pos + 1,
    window)`` keys that end at its position -- summed in closed form."""
    if not causal:
        return Sq * Sk
    a, b = max(1, Sk - Sq + 1), Sk  # keys the first and the last row see, no window
    if a > b:
        return 0
    if not window:
        return (a + b) * (b - a + 1) // 2
    c = min(b, window)
    below = (a + c) * (c - a + 1) // 2 if a <= c else 0
    return below + window * max(0, b - max(a, window + 1) + 1)


_SPLIT = 128  # key rows per piece of a paged slot (FAP_SPLIT in the source)


def key_pieces(npp: int, ps: int) -> int:
    """Pieces the bf16 paged kernel splits every slot's keys into: one per
    128 logical rows of the table.  A function of the table's shape alone,
    never of the batch, the heads or the grid, so a slot's sums are the
    same alone and in a batch."""
    return -(-npp * ps // _SPLIT)


def paged_scratch(B: int, H: int, C: int, d: int, npp: int, ps: int) -> tuple[int, int]:
    """(f32 partials, int32 tickets) one bf16 paged launch needs: per (slot,
    head, 64-row query tile, piece) O [64, d], m [64] and l [64], and one
    ticket per (slot, head, query tile); none with a single piece."""
    n = key_pieces(npp, ps)
    if n == 1:
        return 0, 0
    tiles = B * H * -(-C // 64)
    return tiles * n * 64 * (d + 2), tiles


def _attn_spec(name, B, H, K, Sq, Sk, d, causal, window, dtype, ps, npp, n_pages,
               lib) -> KernelSpec:
    """The contract of one attention launch (``flash_attention.cu``'s
    routes: tensor cores for bf16, CUDA cores for f32)."""
    tc, paged = dtype == torch.bfloat16, npp > 0
    nq = -(-Sq // 64)
    D, kt = tc_tile(d) if tc else (0, 32)
    S = npp * ps
    n_part, n_tickets = (paged_scratch(B, H, Sq, d, npp, ps) if tc and paged else (0, 0))
    nsplit = key_pieces(npp, ps) if paged else 1
    scalars = ()
    kv = OperandSpec("k", B * K * Sk, d), OperandSpec("v", B * K * Sk, d)
    if paged:
        scalars = (ScalarSpec("q_start", (B,), 0, S), ScalarSpec("k_len", (B,), 0, S),
                   ScalarSpec("pages", (B, npp), 0, n_pages - 1))
        kv = OperandSpec("k", n_pages * ps, K * d), OperandSpec("v", n_pages * ps, K * d)
    operands = (OperandSpec("q", B * H * Sq, d), *kv, OperandSpec("out", B * H * Sq, d, "out"),
                OperandSpec("part", n_part // (64 * (d + 2)), 1, "partial"),
                OperandSpec("tickets", n_tickets, 1, "ticket"),
                OperandSpec("pages", B * npp, npp, "table"))
    grid = (nq * (nsplit if tc else 1) * B * H,) if tc else (nq, H, B)

    def enumerate_(fill):
        return run_enumerator(
            "repro_enum_flash", (B, H, K, Sq, Sk, d, int(causal), int(window), int(tc), D,
                                 int(paged), ps, npp, nsplit),
            (fill.get("q_start"), fill.get("k_len"), fill.get("pages")), lib)

    def live(fill, ev, reads):
        # the keys some query row of the block sees (the reference's masks:
        # kpos < kn, causal kpos <= qpos, windowed kpos > qpos - window),
        # read a key tile of kt rows at a time
        q = ev[(ev[:, 1] == READ) & (ev[:, 2] == 0)]
        q0_of = dict(zip(q[:, 0].tolist(), q[:, 3].tolist()))
        qn_of = dict(zip(q[:, 0].tolist(), (q[:, 4] - q[:, 3]).tolist()))
        blk, r, b = reads[:, 0], reads[:, 7], reads[:, 8]
        qrow = np.array([q0_of.get(x, -1) for x in blk.tolist()])
        qn = np.array([qn_of.get(x, 0) for x in blk.tolist()])
        if paged:
            off, kn = fill["q_start"][b], np.minimum(fill["k_len"][b], S)
        else:
            off, kn = Sk - Sq, np.full_like(b, Sk)
        qlo = qrow % Sq + off  # the block's first query position
        qhi = qlo + qn - 1
        hi = np.minimum(kn - 1, qhi) if causal else kn - 1
        lo = np.maximum(0, qlo - window + 1) if window > 0 else np.zeros_like(hi)
        return (qrow >= 0) & (r < kn) & (hi >= lo) & (r // kt >= lo // kt) & (r // kt <= hi // kt)

    # each (slot, head, query tile): its first q row and its query positions
    bb, hh, iq = (a.ravel() for a in np.meshgrid(np.arange(B), np.arange(H), np.arange(nq),
                                                 indexing="ij"))
    qrow = (bb * H + hh) * Sq + iq * 64
    qn = np.minimum(iq * 64 + 64, Sq) - iq * 64
    r = np.arange(max(Sk, S))

    def needed(fill):  # the keys some query row of the tile sees
        if paged:
            off, kn = fill["q_start"][bb], np.minimum(fill["k_len"][bb], S)
        else:
            off, kn = Sk - Sq, np.full_like(bb, Sk)
        qlo = iq * 64 + off
        hi = np.minimum(kn - 1, qlo + qn - 1) if causal else kn - 1
        lo = np.maximum(0, qlo - window + 1) if window > 0 else np.zeros_like(hi)
        g, row = np.nonzero((r[None, :] >= lo[:, None]) & (r[None, :] <= hi[:, None]))
        return np.stack([qrow[g], row], 1).astype(np.int64)

    f, line = header_line("pool_row" if paged else "tile_keys")
    return KernelSpec(name=name, grid=grid, scalars=scalars, operands=operands,
                      enumerate=enumerate_, live=live, needed=needed, kv_ops=(1, 2),
                      split_groups=tc and paged and nsplit > 1, src_file=f, src_line=line)


def fa_dense_spec(B: int, H: int, K: int, Sq: int, Sk: int, d: int, *, causal: bool = True,
                  window: int = 0, dtype=torch.bfloat16, lib=None) -> KernelSpec:
    """Contract of :func:`flash_attention` (query row i at position
    ``i + Sk - Sq``) on the route ``dtype`` takes."""
    return _attn_spec("flash_attention", B, H, K, Sq, Sk, d, causal, window, dtype, 0, 0, 0,
                      lib)


def fa_paged_spec(B: int, H: int, K: int, C: int, d: int, ps: int, npp: int, n_pages: int,
                  *, window: int = 0, dtype=torch.bfloat16, lib=None) -> KernelSpec:
    """Contract of :func:`flash_attention_paged`: a C-row chunk over pools
    [n_pages, ps, K, d] through tables [B, npp]; ``q_start`` and ``k_len``
    range over the table's whole capacity (``k_len == 0``: an empty
    chunk), and bf16 splits the keys into :func:`key_pieces`."""
    return _attn_spec("flash_attention_paged", B, H, K, C, 0, d, True, window, dtype, ps, npp,
                      n_pages, lib)


def _entry():
    global _fn
    if _fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn = _build.bind("flash_attention", "repro_flash_attention_paged",
                          [P] * 11 + [I] * 9 + [F, F, I, P])
    return _fn


def flash_attention_paged(q, k, v, pages, q_start, k_len, *, window: int = 0,
                          softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: [B,H,C,d] query chunk; k/v: page pools [P,ps,K,d]; pages: [B,npp]
    int32; q_start/k_len: [B] int32 -> [B,H,C,d].  Query row ``i`` sits at
    logical position ``q_start[b] + i`` and attends causally over rows
    ``[0, k_len[b])``; rows with no valid key give 0.

    On the card q may be any view with a unit stride along d (the layers
    pass a transposed view of their [B,C,H,d] tensor) and the result is a
    [B,H,C,d] view of a [B,C,H,d] buffer.  bf16 splits each slot's keys
    into :func:`key_pieces` pieces, one CUDA block each, merged in piece
    order by the last block to finish, in the same launch.  Inference only."""
    _build.refuse_grad("flash_attention_paged", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_paged_ref(q, k, v, pages, q_start, k_len,
                                         window=window, scale=scale,
                                         softcap=softcap)
    if not dry.on_card(q):
        raise ValueError(f"flash_attention_paged: q on {q.device}")
    dev = q.device
    for name, t in (("k", k), ("v", v), ("pages", pages), ("q_start", q_start),
                    ("k_len", k_len)):
        if t.device != dev:
            raise ValueError(f"flash_attention_paged: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_paged: {name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_paged: dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    if q.dim() != 4 or q.stride(3) != 1:
        raise ValueError("flash_attention_paged: q must be [B,H,C,d] with a unit stride "
                         "along d")
    B, H, C, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != d or H % k.shape[2] \
            or d > 256:
        raise ValueError(f"flash_attention_paged: q {tuple(q.shape)} vs pools "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if pages.dim() != 2 or pages.shape[0] != B or q_start.shape != (B,) \
            or k_len.shape != (B,):
        raise ValueError("flash_attention_paged: pages [B,npp], q_start/k_len [B]")
    if any(t.dtype != torch.int32 for t in (pages, q_start, k_len)):
        raise TypeError("flash_attention_paged: pages/q_start/k_len must be int32")
    out = torch.empty((B, C, H, d), dtype=q.dtype, device=dev).transpose(1, 2)
    if B == 0 or C == 0 or H == 0:
        return out
    ps, npp = k.shape[1], pages.shape[1]
    bf16 = q.dtype == torch.bfloat16
    n_part, n_tickets = paged_scratch(B, H, C, d, npp, ps) if bf16 else (0, 0)
    if out.is_meta:  # every row of the table may be live: k_len is data
        if n_part:
            dry.scratch(n_part, n_tickets)
        K, keys = k.shape[2], npp * ps
        dry.report("flash_attention_paged", flops=4 * B * H * C * keys * d,
                   nbytes=q.nbytes + out.nbytes + pages.nbytes + q_start.nbytes
                   + k_len.nbytes + 2 * B * keys * K * d * k.element_size(),
                   outputs=(out,))
        return out
    stream = _build.stream_ptr(dev)
    part = tickets = None
    if n_part:
        part, tickets = _build.scratch(dev, stream, n_part, n_tickets)
    scale = scale if scale is not None else d ** -0.5
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (q, out)]
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pages.data_ptr(),
                   q_start.data_ptr(), k_len.data_ptr(),
                   part.data_ptr() if part is not None else None,
                   tickets.data_ptr() if tickets is not None else None,
                   out.data_ptr(), *strides, B, H, k.shape[2], C, d, ps, npp,
                   key_pieces(npp, ps), int(window or 0), float(scale),
                   float(softcap or 0.0), int(bf16), stream)
    _build.check(err, "flash_attention_paged")
    flash_attention_paged.launches += 1
    return out


flash_attention_paged.launches = 0
