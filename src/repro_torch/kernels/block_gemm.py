"""Block GEMM wrappers: ``csrc/block_gemm.cu`` and ``csrc/block_gemm_int8.cu``
on the card, the plain versions on the CPU.

Ports of ``repro.kernels.block_gemm.block_gemm`` (TPU kernel
``_gemm_kernel``) and ``block_gemm_int8`` (``_gemm_int8_kernel``).  A
row-parallel int8 product (K cut over a mesh's ranks) runs the int8 GEMM's
two halves apart: :func:`block_gemm_int8_acc` stores the raw int32 sums,
the ranks add them exactly, and :func:`int8_epilogue` scales the whole
sum.  Each wrapper's ``.launches`` counts its kernel launches;
``block_gemm``'s ``.trans_a_launches`` those of them that read A
transposed (the weight gradients of a train step).  Inside a dry run
(``kernels.dry``) a meta tensor takes the CUDA route up to the launch and
reports the call instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dry
from repro_torch.kernels.ref import (block_gemm_int8_acc_ref, block_gemm_int8_ref,
                                     block_gemm_ref, int8_epilogue_ref)
from repro_torch.kernels.spec import KernelSpec, OperandSpec, header_line, run_enumerator

_DTYPES = (torch.float32, torch.bfloat16)
_fn = None
_fn_int8 = None
_fn_acc = None
_fn_epi = None

GEMM_BN = 64  # the column tile of the split rule (the kernel's 64-column tiles)
_SMS = 132  # an H100's SMs
_MIN_K_CHUNK = 256
_MAX_SPLITS = 8  # a portable thread block cluster


def gemm_splits(K: int, N: int) -> int:
    """How many ways the bf16 kernel splits K: the least power of two that
    gives every SM a block of each 64-column row tile (``ceil(N/64) * S >=
    132``), at most 8 (one cluster), and no K range under 256.  A function
    of (K, N) only -- never of M -- so every output row is the same f32 sum
    for every M."""
    tiles = -(-N // GEMM_BN)
    s = 1
    while s < _MAX_SPLITS and tiles * s < _SMS and K // (2 * s) >= _MIN_K_CHUNK:
        s *= 2
    return s


INT8_BN = 128  # the column tile of the int8 split rule (the mma.sync routes' tiles)
_INT8_MIN_K_CHUNK = 256


def int8_splits(K: int, N: int) -> int:
    """How many ways the int8 kernel's mma.sync routes split K: the least
    power of two that gives every SM a block of each 128-column tile
    (``ceil(N/128) * S >= 132``), at most 8 (one portable cluster), and no
    K range under 256 bytes.  A function of (K, N) only; int32 sums are
    exact, so no split could change an output bit anyway."""
    tiles = -(-N // INT8_BN)
    s = 1
    while s < _MAX_SPLITS and tiles * s < _SMS and K // (2 * s) >= _INT8_MIN_K_CHUNK:
        s *= 2
    return s


def int8_route(M: int, N: int, sms: int = _SMS, tma_ok: bool = True) -> int:
    """Which design of ``csrc/block_gemm_int8.cu`` takes the product:
    0 -- mma.sync, 16-row tiles (M <= 16, decode); 1 -- mma.sync, 64-row
    tiles (the engine's chunks, and whatever M the wgmma kernel cannot fill
    the card with); 2 / 3 -- the persistent wgmma kernel with 128 x 128 /
    128 x 256 tiles, for M > 64 once its 128 x 128 tiles alone give every
    SM one (whole-prompt prefill) and the TMA can read the operands
    (``tma_ok``: K % 16 == 0 and 16-byte aligned bases).  The
    wider tile reads less of A per product and wins unless its tiles spread
    over the SMs in more than 15 % more columns a block than the narrower
    one's (``ceil(tiles / sms) * BN``: 3072 rows x 2048 columns take 128)."""
    if M <= 16:
        return 0
    m_tiles = -(-M // 128)
    if M > 64 and tma_ok and m_tiles * -(-N // 128) >= sms:
        cols = {bn: -(-(m_tiles * -(-N // bn)) // sms) * bn for bn in (128, 256)}
        return 3 if cols[256] <= 1.15 * cols[128] else 2
    return 1


def gemm_spec(M: int, K: int, N: int, *, int8: bool = False, sms: int = _SMS,
              lib=None) -> KernelSpec:
    """Contract of :func:`block_gemm` (bf16: the tile ``launch_bf16`` takes
    for M, K split by :func:`gemm_splits`) or, ``int8``, of
    :func:`block_gemm_int8` on the route :func:`int8_route` takes (K split
    by :func:`int8_splits` on the mma.sync routes; the persistent kernel's
    tile walk over ``sms`` blocks on the wgmma routes).  Ragged M, N and K
    are the interesting cases: the tiles' edges are masked, never padded."""
    route = int8_route(M, N, sms) if int8 else 0
    splits = (int8_splits(K, N) if route < 2 else 1) if int8 else gemm_splits(K, N)
    operands = (OperandSpec("a", M, K), OperandSpec("b", K, N), OperandSpec("c", M, N, "out"))

    def enumerate_(fill):
        return run_enumerator("repro_enum_gemm", (M, N, K, int(int8), route, splits, sms),
                              (), lib)

    f, line = header_line("walk_tile" if int8 and route >= 2 else "split_range")
    return KernelSpec(name=f"block_gemm_int8_route{route}" if int8 else "block_gemm",
                      grid=(), scalars=(), operands=operands, enumerate=enumerate_,
                      k_whole=K, src_file=f, src_line=line)


_SM_COUNTS: dict = {}


def _sm_count(dev) -> int:
    n = _SM_COUNTS.get(dev)
    if n is None:
        n = _SM_COUNTS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _entry():
    global _fn
    if _fn is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn = _build.bind("block_gemm", "repro_block_gemm",
                          [P, P, P, I, I, I, I, I, I, I, I, P])
    return _fn


def _entry_int8():
    global _fn_int8
    if _fn_int8 is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn_int8 = _build.bind("block_gemm_int8", "repro_block_gemm_int8",
                               [P, P, P, P, P, I, I, I, I, I, I, I, P])
    return _fn_int8


def _entry_acc():
    global _fn_acc
    if _fn_acc is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn_acc = _build.bind("block_gemm_int8", "repro_block_gemm_int8_acc",
                              [P, P, P, I, I, I, I, I, I, P])
    return _fn_acc


def _entry_epi():
    global _fn_epi
    if _fn_epi is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _fn_epi = _build.bind("block_gemm_int8", "repro_int8_epilogue",
                              [P, P, P, P, I, I, I, I, P])
    return _fn_epi


def block_gemm(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
               trans_b: bool = False, trans_a: bool = False) -> torch.Tensor:
    """C = A @ B with an f32 accumulator and one cast to ``out_dtype``
    (default ``a.dtype``; f32 is the LM head's store).  A is row-major
    [M, K], or [K, M] with ``trans_a`` (the weight gradient ``x^T @ g`` of
    ``ops.cgra_matmul``'s backward); B is row-major [K, N], or [N, K] with
    ``trans_b`` (the tied LM head reads the [V, D] embedding table in
    place).  Not both.  No backward: ``ops.cgra_matmul`` is the
    differentiable entry."""
    _build.refuse_grad("block_gemm", a, b)
    out_dtype = out_dtype or a.dtype
    if trans_a and trans_b:
        raise ValueError("block_gemm: trans_a and trans_b together are not supported")
    if a.device.type == "cpu":
        return block_gemm_ref(a, b, out_dtype, trans_b, trans_a)
    if not dry.on_card(a) or b.device != a.device:
        raise ValueError(f"block_gemm: a on {a.device}, b on {b.device}")
    ka, kb = (0 if trans_a else 1), (1 if trans_b else 0)
    if a.dim() != 2 or b.dim() != 2 or a.shape[ka] != b.shape[kb]:
        raise ValueError(f"block_gemm: shapes {tuple(a.shape)}{'^T' if trans_a else ''} "
                         f"@ {tuple(b.shape)}{'^T' if trans_b else ''}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"block_gemm: dtypes {a.dtype}, {b.dtype}")
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"block_gemm: out_dtype {out_dtype} for {a.dtype} inputs")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_gemm: a and b must be contiguous")
    M, K = a.shape[1 - ka], a.shape[ka]
    N = b.shape[1 - kb]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    if K == 0:
        return c.zero_()
    if c.is_meta:
        dry.report("block_gemm", flops=2 * M * N * K, nbytes=a.nbytes + b.nbytes + c.nbytes,
                   outputs=(c,))
        return c
    err = _entry()(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                   int(a.dtype == torch.bfloat16),
                   int(out_dtype == torch.bfloat16), int(trans_a), int(trans_b),
                   gemm_splits(K, N), _build.stream_ptr(a.device))
    _build.check(err, "block_gemm")
    block_gemm.launches += 1
    block_gemm.trans_a_launches += int(trans_a)
    return c


block_gemm.launches = 0
block_gemm.trans_a_launches = 0


def block_gemm_int8(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                    b_scale: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Packed-data GEMM: a_q [M,K] int8 times b_q [N,K] int8 (K contiguous:
    the packed weight layout) with exact int32 sums and the fused epilogue
    ``(acc * a_scale[m]) * b_scale[n]`` in f32, cast once to ``out_dtype``
    (f32 or bf16).  a_scale: [M, 1] f32; b_scale: [1, N] f32.  On the card
    ``int8_route`` picks the design and ``int8_splits`` the split of K.
    Inference only: no backward."""
    _build.refuse_grad("block_gemm_int8", a_q, b_q, a_scale, b_scale)
    if a_q.device.type == "cpu":
        return block_gemm_int8_ref(a_q, b_q, a_scale, b_scale, out_dtype)
    M, N, K = _int8_operands("block_gemm_int8", a_q, b_q)
    _check_scales("block_gemm_int8", a_q.device, M, N, a_scale, b_scale, out_dtype)
    c = torch.empty((M, N), dtype=out_dtype, device=a_q.device)
    if M == 0 or N == 0:
        return c
    if K == 0:
        return c.zero_()
    if c.is_meta:
        dry.report("block_gemm_int8", flops=2 * M * N * K, nbytes=a_q.nbytes + b_q.nbytes
                   + a_scale.nbytes + b_scale.nbytes + c.nbytes, outputs=(c,))
        return c
    route, splits, sms = _int8_plan(a_q, b_q)
    err = _entry_int8()(a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(),
                        b_scale.data_ptr(), c.data_ptr(), M, N, K,
                        int(out_dtype == torch.bfloat16), route, splits, sms,
                        _build.stream_ptr(a_q.device))
    _build.check(err, "block_gemm_int8")
    block_gemm_int8.launches += 1
    return c


block_gemm_int8.launches = 0


def _int8_operands(what: str, a_q, b_q) -> tuple[int, int, int]:
    """Checks a_q [M, K] and b_q [N, K] (int8, contiguous, on one card);
    returns (M, N, K)."""
    if not dry.on_card(a_q) or b_q.device != a_q.device:
        raise ValueError(f"{what}: a_q on {a_q.device}, b_q on {b_q.device}")
    if not (a_q.is_contiguous() and b_q.is_contiguous()):
        raise ValueError(f"{what}: a_q and b_q must be contiguous")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"{what}: dtypes {a_q.dtype}, {b_q.dtype}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[1]:
        raise ValueError(f"{what}: shapes {tuple(a_q.shape)} @ {tuple(b_q.shape)}^T")
    return a_q.shape[0], b_q.shape[0], a_q.shape[1]


def _check_scales(what: str, dev, M: int, N: int, a_scale, b_scale, out_dtype):
    for name, x in (("a_scale", a_scale), ("b_scale", b_scale)):
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, the operands on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: {name} dtype {x.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"{what}: out_dtype {out_dtype}")
    if a_scale.numel() != M or b_scale.numel() != N:
        raise ValueError(f"{what}: scales {tuple(a_scale.shape)}, "
                         f"{tuple(b_scale.shape)} for M={M}, N={N}")


def _int8_plan(a_q, b_q) -> tuple[int, int, int]:
    """(route, splits, SM count) of the int8 kernels for these operands."""
    M, K = a_q.shape
    N = b_q.shape[0]
    sms = _sm_count(a_q.device)
    tma_ok = K % 16 == 0 and a_q.data_ptr() % 16 == 0 and b_q.data_ptr() % 16 == 0
    route = int8_route(M, N, sms, tma_ok)
    return route, (int8_splits(K, N) if route < 2 else 1), sms


def block_gemm_int8_acc(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """The raw int32 sums of :func:`block_gemm_int8`: a_q [M, K] int8 times
    b_q [N, K] int8 -> acc [M, N] int32, with no epilogue, on the same
    route and K split as the fused product (``int8_route``,
    ``int8_splits``).  Exact while ``K * 127^2 < 2^31``; a row-parallel
    caller sums the ranks' partials as int32 and applies
    :func:`int8_epilogue` once.  Inference only."""
    _build.refuse_grad("block_gemm_int8_acc", a_q, b_q)
    if a_q.device.type == "cpu":
        return block_gemm_int8_acc_ref(a_q, b_q)
    M, N, K = _int8_operands("block_gemm_int8_acc", a_q, b_q)
    acc = torch.empty((M, N), dtype=torch.int32, device=a_q.device)
    if M == 0 or N == 0:
        return acc
    if K == 0:
        return acc.zero_()
    if acc.is_meta:
        dry.report("block_gemm_int8_acc", flops=2 * M * N * K,
                   nbytes=a_q.nbytes + b_q.nbytes + acc.nbytes, outputs=(acc,))
        return acc
    route, splits, sms = _int8_plan(a_q, b_q)
    err = _entry_acc()(a_q.data_ptr(), b_q.data_ptr(), acc.data_ptr(), M, N, K, route,
                       splits, sms, _build.stream_ptr(a_q.device))
    _build.check(err, "block_gemm_int8_acc")
    block_gemm_int8_acc.launches += 1
    return acc


block_gemm_int8_acc.launches = 0


def int8_epilogue(acc: torch.Tensor, a_scale: torch.Tensor, b_scale: torch.Tensor,
                  out_dtype=torch.float32) -> torch.Tensor:
    """The fused store of :func:`block_gemm_int8` on an int32 accumulator
    acc [M, N] (contiguous): ``(float(acc) * a_scale[m]) * b_scale[n]`` in
    f32, cast once to ``out_dtype`` (f32 or bf16).  a_scale: [M, 1] f32;
    b_scale: [1, N] f32.  Of a whole-K accumulator it equals
    ``block_gemm_int8`` bit for bit.  Inference only."""
    _build.refuse_grad("int8_epilogue", acc, a_scale, b_scale)
    if acc.device.type == "cpu":
        return int8_epilogue_ref(acc, a_scale, b_scale, out_dtype)
    if not dry.on_card(acc) or acc.dtype != torch.int32 or acc.dim() != 2 \
            or not acc.is_contiguous():
        raise ValueError(f"int8_epilogue: acc {tuple(acc.shape)} {acc.dtype} on "
                         f"{acc.device}: a contiguous [M, N] int32 on the card")
    M, N = acc.shape
    _check_scales("int8_epilogue", acc.device, M, N, a_scale, b_scale, out_dtype)
    c = torch.empty((M, N), dtype=out_dtype, device=acc.device)
    if M == 0 or N == 0:
        return c
    if c.is_meta:
        dry.report("int8_epilogue", flops=2 * M * N, nbytes=acc.nbytes + a_scale.nbytes
                   + b_scale.nbytes + c.nbytes, outputs=(c,))
        return c
    err = _entry_epi()(acc.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(), c.data_ptr(),
                       M, N, int(out_dtype == torch.bfloat16), _sm_count(acc.device),
                       _build.stream_ptr(acc.device))
    _build.check(err, "int8_epilogue")
    int8_epilogue.launches += 1
    return c


int8_epilogue.launches = 0
