"""Flash-decode wrappers: ``csrc/decode_attention.cu`` on the card, the
plain version on the CPU.

Ports of ``repro.kernels.decode_attention.flash_decode`` (TPU kernel
``_fd_kernel``: the linear and ring layouts of a slot cache) and
``_flash_decode_paged`` (``_fd_kernel_paged``).  Each wrapper's
``.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_ref

_DTYPES = (torch.float32, torch.bfloat16)
_fn = None
_fn_slot = None


_SLOT_ROWS = 64  # cache rows per CUDA block of the slot kernel
_slot_scratch: dict = {}  # (device, stream) -> (partials f32, tickets int32)


def _entry_slot():
    global _fn_slot
    if _fn_slot is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn_slot = _build.bind("decode_attention", "repro_flash_decode",
                               [P] * 8 + [I] * 8 + [F, F, I, P])
    return _fn_slot


def _scratch(dev, stream: int, n_part: int, n_tickets: int):
    """The slot kernel's partials and ticket counters for launches on
    ``stream`` of ``dev``, kept between calls and grown when a call needs
    more.  The counters are zeroed once, when allocated: every launch
    leaves them at 0.  Launches on one stream run in order, so they may
    share both; each stream has its own, so launches on two streams never
    race on them."""
    key = (dev, stream)
    part, tickets = _slot_scratch.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    _slot_scratch[key] = (part, tickets)
    return part, tickets


def flash_decode(q, k, v, pos, start, *, layout: str = "linear",
                 softcap: float = 0.0, scale=None, dv: int | None = None) -> torch.Tensor:
    """q: [B,H,dq]; k: [B,S,K,dq]; v: [B,S,K,>=dv] (v may be k); pos/start:
    [B] int32 or scalars (``start`` None: 0) -> [B,H,dv].  ``layout``
    "linear": rows ``[start, pos]`` are live (``pos >= S`` reads up to row
    S-1); "ring": entry j holds absolute row ``pos - ((pos - j) mod S)``,
    live iff that row is ``>= max(start, 0)``.  A slot with no live row
    gives exact zeros.  On the card the rows are split into 64-row blocks,
    one CUDA block each, and the last block of each (slot, kv-head) to
    finish merges the partials in block order: one launch."""
    B, H, dq = q.shape
    dv = dv or v.shape[-1]
    layout = str(layout)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos, start, layout=layout,
                                softcap=softcap, scale=scale, dv=dv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: q on {q.device}")
    if layout not in ("linear", "ring"):
        raise ValueError(f"flash_decode: layout {layout!r}")
    dev = q.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B).contiguous()
    start = (torch.zeros_like(pos) if start is None else torch.as_tensor(
        start, dtype=torch.int32, device=dev).expand(B).contiguous())
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos), ("start", start)):
        if t.device != dev:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    if k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3] or k.shape[0] != B:
        raise ValueError(f"flash_decode: caches {tuple(k.shape)}, {tuple(v.shape)}")
    S, K = k.shape[1], k.shape[2]
    if k.shape[3] != dq or H % K or dv > v.shape[3] or max(dq, dv) > 256:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} vs caches "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, dv={dv}")
    if pos.shape != (B,) or start.shape != (B,) \
            or pos.dtype != torch.int32 or start.dtype != torch.int32:
        raise ValueError("flash_decode: pos/start must be [B] int32")
    out = torch.empty((B, H, dv), dtype=q.dtype, device=dev)
    if B == 0 or S == 0:
        return out.zero_()
    # per (slot, kv-head, 64-row block): [m, l, acc[dv]] for each query head;
    # one ticket counter per (slot, kv-head)
    stream = _build.stream_ptr(dev)
    part, tickets = _scratch(dev, stream,
                             B * K * -(-S // _SLOT_ROWS) * (H // K) * (dv + 2), B * K)
    scale = scale if scale is not None else dq ** -0.5
    err = _entry_slot()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                        start.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                        out.data_ptr(), B, H, K, S, dq,
                        dv, v.shape[3], int(layout == "ring"), float(scale),
                        float(softcap or 0.0), int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _entry():
    global _fn
    if _fn is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _fn = _build.bind("decode_attention", "repro_flash_decode_paged",
                          [P] * 7 + [I] * 8 + [F, F, I, P])
    return _fn


def flash_decode_paged(q, k, v, pos, start, pages, *, softcap: float = 0.0,
                       scale=None, dv: int | None = None) -> torch.Tensor:
    """q: [B,H,dq]; k/v: page pools [P,ps,K,d] (v may be k); pages: [B,npp]
    int32; pos/start: [B] int32 -> [B,H,dv].  Logical row ``r`` of slot
    ``b`` lives at pool row ``(pages[b, r // ps], r % ps)``; rows
    ``[start, pos]`` are live and a slot with none gives exact zeros."""
    B, H, dq = q.shape
    dv = dv or v.shape[-1]
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos, start, pages=pages,
                                softcap=softcap, scale=scale, dv=dv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged: q on {q.device}")
    dev = q.device
    for name, t in (("k", k), ("v", v), ("pages", pages), ("pos", pos),
                    ("start", start)):
        if t.device != dev:
            raise ValueError(f"flash_decode_paged: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode_paged: {name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("flash_decode_paged: q must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode_paged: dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    if k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_decode_paged: pools {tuple(k.shape)}, {tuple(v.shape)}")
    P, ps, K = k.shape[0], k.shape[1], k.shape[2]
    if k.shape[3] != dq or H % K or dv > v.shape[3] or max(dq, dv) > 256:
        raise ValueError(f"flash_decode_paged: q {tuple(q.shape)} vs pools "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, dv={dv}")
    if pages.dim() != 2 or pages.shape[0] != B or pos.shape != (B,) \
            or start.shape != (B,):
        raise ValueError("flash_decode_paged: pages [B,npp], pos/start [B]")
    if any(t.dtype != torch.int32 for t in (pages, pos, start)):
        raise TypeError("flash_decode_paged: pages/pos/start must be int32")
    G = H // K
    if 4 * (G * dq + 8 * G * (ps + dv + 2)) > 200 * 1024:
        raise ValueError("flash_decode_paged: G*(dq+8*(ps+dv)) exceeds shared memory")
    out = torch.empty((B, H, dv), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    scale = scale if scale is not None else dq ** -0.5
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pages.data_ptr(),
                   pos.data_ptr(), start.data_ptr(), out.data_ptr(),
                   B, H, K, dq, dv, v.shape[3], ps, pages.shape[1],
                   float(scale), float(softcap or 0.0),
                   int(q.dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(err, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
