"""Flash-decode wrappers: ``csrc/decode_attention.cu`` on the card, the
plain version on the CPU.

Ports of ``repro.kernels.decode_attention.flash_decode`` (TPU kernel
``_fd_kernel``: the linear and ring layouts of a slot cache) and
``_flash_decode_paged`` (``_fd_kernel_paged``).  Both launch the one CUDA
kernel: the rows of every slot are split into 64-row blocks, one CUDA
block each, and the last block of each (slot, kv-head) to finish merges
the partials in block order, in the same launch.  On rows wider than 256
columns (MLA's latent call: 40 heads over one latent head, q 288 wide) a
kv-head with more than 8 query heads has them split into
:func:`head_groups` groups, a CUDA block each.  Each wrapper's
``.launches`` counts its launches.  Inside a dry run (``kernels.dry``) a
meta tensor takes the CUDA route up to the launch and reports the call
instead, its partials and tickets included.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.ref import flash_decode_ref
from repro_torch.kernels.spec import (KernelSpec, OperandSpec, ScalarSpec, header_line,
                                      run_enumerator)

_DTYPES = (torch.float32, torch.bfloat16)
_ROWS = 64  # logical rows per CUDA block
_GROUP = 8  # most query heads a CUDA block takes
MAX_D = 288  # widest q or v row the kernel takes (MLA: kv_lora_rank 256 + qk_rope 32)
_fn = None


def _entry():
    global _fn
    if _fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn = _build.bind("decode_attention", "repro_flash_decode",
                          [P] * 9 + [I] * 11 + [F, F, I, P])
    return _fn


def head_groups(G: int, d: int) -> int:
    """Groups the G query heads of a kv-head are split into, one CUDA block
    each, for rows ``d = max(dq, dv)`` wide: 1 up to 256 columns (every GQA
    shape keeps its one-group kernel) or up to 8 heads; else G over its
    largest divisor <= 8 (MLA's G = 40 at d = 288: 5 groups of 8).  A
    function of the shape alone, so a captured decode graph's grid never
    changes."""
    if d <= 256 or G <= _GROUP:
        return 1
    return G // max(k for k in range(1, _GROUP + 1) if G % k == 0)


def decode_scratch(B: int, H: int, K: int, S: int, dv: int,
                   dq: int | None = None) -> tuple[int, int]:
    """(f32 partials, int32 tickets) one launch needs over ``S`` logical
    rows a slot: per (slot, kv-head, 64-row block) ``[m, l, acc[dv]]`` for
    each of the H/K query heads, and one ticket per (slot, kv-head, head
    group; ``dq`` defaults to ``dv``).  A slot's share is a function of S,
    H, K, dv and dq alone."""
    groups = head_groups(H // K, max(dv, dq or dv))
    return B * K * -(-S // _ROWS) * (H // K) * (dv + 2), B * K * groups


def _decode_spec(name, B, H, K, S, dq, dv, v_row, layout, kv_rows, ps, npp, n_pages,
                 lib) -> KernelSpec:
    """The contract of one decode launch (``decode_attention.cu``'s grid
    and addresses, the scratch of :func:`decode_scratch`)."""
    v_row = v_row or dv
    ng = head_groups(H // K, max(dq, dv))
    G, nblk = H // K // ng, -(-S // _ROWS)
    n_part, n_tickets = decode_scratch(B, H, K, S, dv, dq)
    paged, ring = npp > 0, layout == "ring"
    scalars = [ScalarSpec("pos", (B,), 0, S), ScalarSpec("start", (B,), 0, S)]
    if paged:
        scalars.append(ScalarSpec("pages", (B, npp), 0, n_pages - 1))
    operands = (OperandSpec("q", B * H, dq), OperandSpec("k", kv_rows, K * dq),
                OperandSpec("v", kv_rows, K * v_row), OperandSpec("out", B * H, dv, "out"),
                OperandSpec("part", n_part // (G * (dv + 2)), 1, "partial"),
                OperandSpec("tickets", n_tickets, 1, "ticket"),
                OperandSpec("pages", B * npp, npp, "table"))

    def enumerate_(fill):
        return run_enumerator("repro_enum_decode",
                              (B, H, K, ng, S, dq, dv, v_row, int(ring), int(paged), ps, npp),
                              (fill["pos"], fill["start"], fill.get("pages")), lib)

    def live(fill, ev, reads):  # the reference's: rows [start, pos], a ring's all
        b = reads[:, 8]
        p, s = fill["pos"][b], fill["start"][b]
        if ring:
            return s <= p
        return (reads[:, 7] >= np.maximum(s, 0)) & (reads[:, 7] <= np.minimum(p, S - 1))

    # the first q row of each (slot, kv-head, head group): b * H + h0
    y = np.arange(K * ng)
    h0 = (y // ng) * (H // K) + (y % ng) * G
    qrow = np.arange(B)[:, None] * H + h0[None, :]  # [B, K * ng]
    r = np.arange(S)

    def needed(fill):  # every live row of the slot, for each of its head groups
        p, s = fill["pos"][:, None], fill["start"][:, None]
        if ring:
            a = p - (p - r[None, :]) % S
            need = (s <= p) & (a >= np.maximum(s, 0))
        else:
            need = (r[None, :] >= np.maximum(s, 0)) & (r[None, :] <= np.minimum(p, S - 1))
        b, row = np.nonzero(need)
        q = qrow[b]  # [n, K * ng]
        return np.stack([q.ravel(), np.repeat(row, q.shape[1])], 1).astype(np.int64)

    f, line = header_line("page_row" if paged else "rows_to")
    return KernelSpec(name=name, grid=(nblk, K * ng, B), scalars=tuple(scalars),
                      operands=operands, enumerate=enumerate_, live=live, needed=needed,
                      kv_ops=(1, 2), src_file=f, src_line=line)


def fd_dense_spec(B: int, H: int, K: int, S: int, dq: int, dv: int, *,
                  layout: str = "linear", v_row: int | None = None, lib=None) -> KernelSpec:
    """Contract of :func:`flash_decode` on slot caches [B, S, K, *] in the
    ``layout`` given (``v_row``: v's row width when v is k, MLA's latent
    call).  Scalar domains are the reference's hostile ones: ``pos`` reaches
    ``S`` (a frozen slot) and ``start`` may pass ``pos`` (a drained one)."""
    return _decode_spec(f"flash_decode_{layout}", B, H, K, S, dq, dv, v_row, layout,
                        B * S, 0, 0, 0, lib)


def fd_paged_spec(B: int, H: int, K: int, dq: int, dv: int, ps: int, npp: int,
                  n_pages: int, *, v_row: int | None = None, lib=None) -> KernelSpec:
    """Contract of :func:`flash_decode_paged` over pools [n_pages, ps, K, *]
    and tables [B, npp] holding any pool page."""
    return _decode_spec("flash_decode_paged", B, H, K, npp * ps, dq, dv, v_row, "linear",
                        n_pages * ps, ps, npp, n_pages, lib)


def _launch(name, q, k, v, pos, start, pages, *, ring, softcap, scale, dv):
    """Checks and one launch of the decode kernel on slot caches (``pages``
    None) or page pools; raises where the kernel refuses."""
    if not dry.on_card(q):
        raise ValueError(f"{name}: q on {q.device}")
    B, H, dq = q.shape
    dev = q.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B).contiguous()
    start = (torch.zeros_like(pos) if start is None else torch.as_tensor(
        start, dtype=torch.int32, device=dev).expand(B).contiguous())
    named = [("q", q), ("k", k), ("v", v), ("pos", pos), ("start", start)]
    if pages is not None:
        named.append(("pages", pages))
    for n, t in named:
        if t.device != dev:
            raise ValueError(f"{name}: {n} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    if k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{name}: caches {tuple(k.shape)}, {tuple(v.shape)}")
    K = k.shape[2]
    if k.shape[3] != dq or H % K or dv > v.shape[3] or max(dq, dv) > MAX_D:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs caches "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, dv={dv}")
    if pages is None:
        if k.shape[0] != B:
            raise ValueError(f"{name}: caches {tuple(k.shape)} for {B} slots")
        S, ps, npp = k.shape[1], 0, 0
    else:
        if pages.dim() != 2 or pages.shape[0] != B or pages.dtype != torch.int32:
            raise ValueError(f"{name}: pages must be [B, npp] int32")
        ps, npp = k.shape[1], pages.shape[1]
        S = ps * npp
    if pos.shape != (B,) or start.shape != (B,):
        raise ValueError(f"{name}: pos/start must be [B] int32")
    out = torch.empty((B, H, dv), dtype=q.dtype, device=dev)
    if B == 0 or S == 0 or H == 0:
        return out.zero_()
    if out.is_meta:  # every row may be live: pos and start are data
        dry.scratch(*decode_scratch(B, H, K, S, dv, dq))
        rows = B * S * K  # the rows of k (and of v, unless v is k) the slots read
        kv = rows * (dq * k.element_size() + (0 if v is k else dv * v.element_size()))
        dry.report(name, flops=2 * B * S * H * (dq + dv),
                   nbytes=q.nbytes + kv + pos.nbytes + start.nbytes + out.nbytes
                   + (pages.nbytes if pages is not None else 0), outputs=(out,))
        return out
    stream = _build.stream_ptr(dev)
    part, tickets = _build.scratch(dev, stream, *decode_scratch(B, H, K, S, dv, dq))
    scale = scale if scale is not None else dq ** -0.5
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   pages.data_ptr() if pages is not None else None,
                   pos.data_ptr(), start.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                   out.data_ptr(), B, H, K, head_groups(H // K, max(dq, dv)), S, dq, dv,
                   v.shape[3],
                   int(ring), ps, npp,
                   float(scale), float(softcap or 0.0), int(q.dtype == torch.bfloat16),
                   stream)
    _build.check(err, name)
    return out


def flash_decode(q, k, v, pos, start, *, layout: str = "linear",
                 softcap: float = 0.0, scale=None, dv: int | None = None) -> torch.Tensor:
    """q: [B,H,dq]; k: [B,S,K,dq]; v: [B,S,K,>=dv] (v may be k); pos/start:
    [B] int32 or scalars (``start`` None: 0) -> [B,H,dv].  ``layout``
    "linear": rows ``[start, pos]`` are live (``pos >= S`` reads up to row
    S-1); "ring": entry j holds absolute row ``pos - ((pos - j) mod S)``,
    live iff that row is ``>= max(start, 0)``.  A slot with no live row
    gives exact zeros.  One launch on the card.  Inference only."""
    _build.refuse_grad("flash_decode", q, k, v)
    dv = dv or v.shape[-1]
    layout = str(layout)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos, start, layout=layout,
                                softcap=softcap, scale=scale, dv=dv)
    if layout not in ("linear", "ring"):
        raise ValueError(f"flash_decode: layout {layout!r}")
    out = _launch("flash_decode", q, k, v, pos, start, None, ring=layout == "ring",
                  softcap=softcap, scale=scale, dv=dv)
    flash_decode.launches += int(not out.is_meta)  # a dry run's call launches nothing
    return out


flash_decode.launches = 0


def flash_decode_paged(q, k, v, pos, start, pages, *, softcap: float = 0.0,
                       scale=None, dv: int | None = None) -> torch.Tensor:
    """q: [B,H,dq]; k/v: page pools [P,ps,K,d] (v may be k); pages: [B,npp]
    int32; pos/start: [B] int32 -> [B,H,dv].  Logical row ``r`` of slot
    ``b`` lives at pool row ``(pages[b, r // ps], r % ps)``; rows
    ``[start, pos]`` are live and a slot with none gives exact zeros.  One
    launch on the card, the slot kernel's body over the page table.
    Inference only."""
    _build.refuse_grad("flash_decode_paged", q, k, v)
    dv = dv or v.shape[-1]
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos, start, pages=pages,
                                softcap=softcap, scale=scale, dv=dv)
    out = _launch("flash_decode_paged", q, k, v, pos, start, pages, ring=False,
                  softcap=softcap, scale=scale, dv=dv)
    flash_decode_paged.launches += int(not out.is_meta)  # a dry run's call launches nothing
    return out


flash_decode_paged.launches = 0
