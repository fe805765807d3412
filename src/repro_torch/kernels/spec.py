"""Introspectable kernel contracts (port of ``repro.kernels.spec``).

The reference proves its Pallas kernels against the BlockSpec index maps
that ``pl.pallas_call`` itself is built from.  The port keeps that
property with one header: every address a CUDA kernel computes -- a
block's rows, its page-table reads, its key tiles, its split's K range,
its partial slot and ticket -- and every decision its blocks take on them
(exits, row and tile walks, direct or merged writes, ticket counts, edge
masks) comes from ``csrc/index.cuh``, which the ``.cu`` files include and
which ``csrc/index_host.cpp`` includes too.  A
:class:`KernelSpec` names one kernel instantiation: its CUDA grid, the
hostile domain of each scalar operand (:class:`ScalarSpec`), the extent of
each operand, and an ``enumerate`` callable that runs the host enumerator
(``_build.host_library``) over every block for one fill of the scalars and
returns its events.  ``repro_torch.analysis.bounds`` proves K001-K003 over
them.  The spec builders sit beside their wrappers
(``block_gemm.gemm_spec``, ``decode_attention.fd_dense_spec`` /
``fd_paged_spec``, ``flash_attention.fa_dense_spec`` / ``fa_paged_spec``)
and take the grid from the wrappers' own planning.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np

from repro_torch.kernels import _build

#: event fields of the host enumerators: [block, kind, op, r0, r1, c0, c1, x0, x1]
EVENT_WIDTH = 9
READ, TABLE, WRITE, TICKET, PARTIAL, NAMED = range(6)


@dataclasses.dataclass(frozen=True)
class ScalarSpec:
    """Worst-case domain of one scalar operand, ``lo``/``hi`` inclusive:
    every value the kernel's API accepts that the reference's domains
    cover (``pos == S`` for a frozen slot, ``k_len == 0`` for an empty
    chunk, every pool page in a table)."""

    name: str
    shape: Tuple[int, ...]
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """One operand as the enumerators index it: ``rows`` x ``cols``.
    ``role``: "in", "out" (each element written exactly once), "partial"
    (split partial slots: at most one writer each, merged by the last
    ticket holder), "ticket" (counters), "table" (a page table
    [B * npp], each slot reading only its own row)."""

    name: str
    rows: int
    cols: int = 1
    role: str = "in"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Grid and address contract of one CUDA kernel instantiation.

    ``enumerate(fill) -> events`` runs the host enumerator for one fill of
    the scalars (a dict name -> int array).  ``live(fill, events, reads)
    -> bool mask`` says, for each K/V read event in ``reads`` (those of the
    operands ``kv_ops``), whether the row lies in the block's live set,
    computed from the reference's semantics and not from the header (rule
    K002).  ``needed(fill) -> [n, 2] int64`` lists, as (first row of the
    ``q`` operand a block reads, logical key row), every key row some query
    of those rows sees, from the same semantics: the blocks that read those
    query rows must read each such key row between them (rule K003).
    ``split_groups``: the pieces of a ticket group must read disjoint keys.
    ``k_whole``: the GEMM's K, which the splits of each output tile must
    cover exactly once (rule K003)."""

    name: str
    grid: Tuple[int, ...]  # the CUDA grid (() where it depends on the route)
    scalars: Tuple[ScalarSpec, ...]
    operands: Tuple[OperandSpec, ...]
    enumerate: Callable[[dict], np.ndarray]
    live: Optional[Callable[[dict, np.ndarray], np.ndarray]] = None
    needed: Optional[Callable[[dict], np.ndarray]] = None
    kv_ops: Tuple[int, ...] = ()
    split_groups: bool = False
    k_whole: int = 0
    src_file: str = ""
    src_line: int = 0


def provenance(fn: Callable[..., Any]) -> Tuple[str, int]:
    """(file, line) of a callable, for finding reports."""
    code = getattr(fn, "__code__", None)
    if code is None:  # functools.partial etc.
        inner = getattr(fn, "func", None)
        code = getattr(inner, "__code__", None)
    if code is None:
        return "<unknown>", 0
    return code.co_filename, code.co_firstlineno


def header_line(name: str, csrc=None) -> Tuple[str, int]:
    """(file, line) of function ``name`` in ``csrc/index.cuh``: where a
    finding about the address arithmetic points."""
    path = (_build.CSRC if csrc is None else csrc) / "index.cuh"
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if f" {name}(" in line and not line.lstrip().startswith("//"):
            return str(path), i
    return str(path), 0


_ARGTYPES = {
    "repro_enum_decode": [ctypes.c_int] * 12 + [ctypes.c_void_p] * 4 + [ctypes.c_int64],
    "repro_enum_flash": [ctypes.c_int] * 14 + [ctypes.c_void_p] * 4 + [ctypes.c_int64],
    "repro_enum_gemm": [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int64],
}


def run_enumerator(fn: str, ints, tables=(), lib=None) -> np.ndarray:
    """Events [n, 9] int64 of host enumerator ``fn`` called with the ints
    ``ints`` and the int32 arrays ``tables`` (None for an absent one), the
    buffer grown until it holds them all.  ``lib``: a host library other
    than the repository's (a mutation test's copy)."""
    lib = lib or _build.host_library()
    f = getattr(lib, fn)
    f.argtypes = _ARGTYPES[fn]
    f.restype = ctypes.c_int64
    arrs = [None if t is None else np.ascontiguousarray(t, dtype=np.int32) for t in tables]
    ptrs = [None if a is None else a.ctypes.data for a in arrs]
    cap = 1 << 14
    while True:
        ev = np.empty((cap, EVENT_WIDTH), dtype=np.int64)
        n = f(*[int(i) for i in ints], *ptrs, ev.ctypes.data, cap)
        if n <= cap:
            return ev[:n]
        cap = int(n)
