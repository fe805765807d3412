"""Bounds prover of the CUDA kernels' address arithmetic and block decisions
(rules K001-K003).

Every address a kernel computes comes from ``kernels/csrc/index.cuh``; the
host enumerators of ``csrc/index_host.cpp`` include the same header and
walk every block of a kernel's grid for one fill of its scalars, taking
each of the kernel's block decisions from the same header, recording each
read, write, partial, ticket and page-table read as an event
(``repro_torch.kernels.spec``).  The prover runs
them against the reference's hostile fills (each scalar's extremes, and
ascending / descending spreads of each table) and checks:

K001  every address lies inside its operand: rows, columns, page-table
      entries (each slot in its own row of the table), partial slots and
      tickets (against the wrapper's scratch planning), GEMM tiles at
      ragged M, N and K; and every header address function is total over
      the rows the scalars can name (``pos == S`` names row S of a frozen
      slot), as the reference's index maps are evaluated at every grid
      point;
K002  every K/V row a block reads lies in the block's live set, computed
      here from the reference's semantics and not from the header: a
      block with no live row reads nothing (dead blocks exit before they
      load, where Pallas remaps them);
K003  every output element has exactly one writer -- a block, or the last
      ticket holder of its group, whose group must draw exactly the tickets
      it expects and merge exactly the partial slots its blocks wrote --,
      each partial slot at most one, the pieces of a split group read
      disjoint keys, every key row a query sees is read by the blocks of
      its query rows (computed here from the reference's semantics, as
      K002's live set), and the K ranges of a GEMM tile's splits cover K
      once.

Since every exit, ticket count, row range and edge mask a kernel's blocks
act on is a function of ``index.cuh`` that the kernel calls too, an edit of
one of them is an edit of what the proofs read.
"""
from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np

from repro_torch.analysis.findings import Finding
from repro_torch.kernels.spec import (NAMED, PARTIAL, READ, TABLE, TICKET, WRITE,
                                      KernelSpec, ScalarSpec)


def scalar_candidates(spec: ScalarSpec) -> List[np.ndarray]:
    """Worst-case fills of one scalar operand (the reference's): uniform
    fills at the domain's extremes and middle; for a table, ascending and
    descending spreads of distinct entries."""
    lo, hi = spec.lo, spec.hi
    vals = sorted({lo, min(lo + 1, hi), (lo + hi) // 2, max(hi - 1, lo), hi})
    cands = [np.full(spec.shape, v, np.int64) for v in vals]
    if hi > lo and len(spec.shape) > 1:
        span = hi - lo + 1
        flat = np.arange(int(np.prod(spec.shape)), dtype=np.int64)
        cands.append((flat % span + lo).reshape(spec.shape))
        cands.append((flat[::-1] % span + lo).reshape(spec.shape))
    return cands


def fills(spec: KernelSpec):
    """Every combination of the scalars' candidate fills, as dicts."""
    names = [s.name for s in spec.scalars]
    for combo in itertools.product(*(scalar_candidates(s) for s in spec.scalars)):
        yield dict(zip(names, combo))


def _bounds(spec: KernelSpec, ev: np.ndarray, emit) -> None:
    ops = spec.operands
    for kind in (READ, WRITE, NAMED):
        sel = ev[ev[:, 1] == kind]
        for i, op in enumerate(ops):
            e = sel[sel[:, 2] == i]
            if not len(e):
                continue
            r1 = e[:, 3] + 1 if kind == NAMED else e[:, 4]
            bad = (e[:, 3] < 0) | (r1 > op.rows)
            if kind != NAMED:
                bad |= (e[:, 5] < 0) | (e[:, 6] > op.cols)
            if bad.any():
                x = e[np.argmax(bad)]
                what = ("the address function at named row"
                        if kind == NAMED else "read" if kind == READ else "write")
                emit("K001", f"{what} of '{op.name}' rows [{x[3]}, {r1[np.argmax(bad)]}) "
                             f"cols [{x[5]}, {x[6]}) outside [0, {op.rows}) x [0, {op.cols})"
                             + (f" (logical row {x[7]} of slot {x[8]})" if x[7] >= 0 else ""))
    tab = ev[ev[:, 1] == TABLE]
    for i, op in enumerate(ops):
        t = tab[tab[:, 2] == i]
        if not len(t):
            continue
        npp = max(op.cols, 1)
        bad = (t[:, 3] < 0) | (t[:, 3] >= op.rows) | (t[:, 3] // npp != t[:, 8])
        if bad.any():
            x = t[np.argmax(bad)]
            emit("K001", f"page table '{op.name}' read at entry {x[3]} for logical row "
                         f"{x[7]} of slot {x[8]} (the slot's entries: [{x[8] * npp}, "
                         f"{(x[8] + 1) * npp}), table {op.rows})")
    for kind, role in ((PARTIAL, "partial"), (TICKET, "ticket")):
        e = ev[ev[:, 1] == kind]
        if not len(e):
            continue
        op = ops[int(e[0, 2])]
        if op.role != role or (e[:, 3] < 0).any() or (e[:, 3] >= op.rows).any():
            emit("K001", f"{role} index in [{e[:, 3].min()}, {e[:, 3].max()}] outside "
                         f"'{op.name}' [0, {op.rows if op.role == role else 0})")
    t = ev[ev[:, 1] == TICKET]
    part = next((op for op in ops if op.role == "partial"), None)
    if len(t) and part is not None and ((t[:, 5] < 0) | (t[:, 6] > part.rows)).any():
        x = t[np.argmax((t[:, 5] < 0) | (t[:, 6] > part.rows))]
        emit("K001", f"group {x[8]}'s merge reads partial slots [{x[5]}, {x[6]}) outside "
                     f"'{part.name}' [0, {part.rows})")


def _live(spec: KernelSpec, fill, ev: np.ndarray, emit) -> None:
    if spec.live is None:
        return
    reads = ev[(ev[:, 1] == READ) & np.isin(ev[:, 2], spec.kv_ops)]
    if not len(reads):
        return
    ok = np.asarray(spec.live(fill, ev, reads), bool)
    if not ok.all():
        x = reads[np.argmax(~ok)]
        emit("K002", f"block {x[0]} reads '{spec.operands[x[2]].name}' row {x[3]} (logical "
                     f"row {x[7]} of slot {x[8]}) outside its live set; "
                     f"{int((~ok).sum())} such reads")


def _coverage(spec: KernelSpec, fill, ev: np.ndarray, emit) -> None:
    if spec.needed is None:
        return
    need = spec.needed(fill)
    if not len(need):
        return
    blk = ev[:, 0] >= 0
    q = ev[blk & (ev[:, 1] == READ) & (ev[:, 2] == 0)]
    r = ev[blk & (ev[:, 1] == READ) & (ev[:, 2] == spec.kv_ops[0])]
    qkey = np.full(int(ev[:, 0].max(initial=-1)) + 2, -1, np.int64)
    qkey[q[:, 0]] = q[:, 3]
    span = int(max(need[:, 1].max(), r[:, 7].max() if len(r) else 0)) + 1
    got = qkey[r[:, 0]] * span + r[:, 7]
    miss = ~np.isin(need[:, 0] * span + need[:, 1], got)
    if miss.any():
        x = need[np.argmax(miss)]
        emit("K003", f"the blocks of query rows from {x[0]} leave key row {x[1]} unread, "
                     f"which a query of theirs sees; {int(miss.sum())} such rows")


def _writers(spec: KernelSpec, ev: np.ndarray, emit) -> None:
    ops = spec.operands
    t = ev[ev[:, 1] == TICKET]
    complete = set()
    for g in np.unique(t[:, 8]):
        tg = t[t[:, 8] == g]
        exp = set(tg[:, 7].tolist())
        merge = {(int(a), int(b)) for a, b in tg[:, 5:7]}
        if len(exp) != 1 or len(merge) != 1:
            emit("K003", f"group {g}'s tickets disagree on the count ({sorted(exp)}) or "
                         f"the partials merged ({sorted(merge)})")
            continue
        n = exp.pop()
        if len(tg) != n:
            emit("K003", f"group {g} draws {len(tg)} tickets and waits for {n}: "
                         f"{'no block' if len(tg) < n else 'a block that is not last'} "
                         f"merges")
            continue
        blocks = set(tg[:, 0].tolist())
        p = ev[(ev[:, 1] == PARTIAL) & np.isin(ev[:, 0], list(blocks))]
        lo, hi = merge.pop()
        if sorted(p[:, 3].tolist()) != list(range(lo, hi)):
            emit("K003", f"group {g} merges partial slots [{lo}, {hi}) but its blocks "
                         f"wrote {sorted(p[:, 3].tolist())}")
            continue
        complete.add(int(g))
    p = ev[ev[:, 1] == PARTIAL]
    if len(p) and len(np.unique(p[:, 3])) != len(p):
        emit("K003", "a partial slot has more than one writer")
    w = ev[ev[:, 1] == WRITE]
    for i, op in enumerate(ops):
        if op.role != "out":
            continue
        e = w[w[:, 2] == i]
        seen, rects = set(), []
        for x in e:
            g = int(x[8])
            if g >= 0:  # the group's merge writes once, when its tickets complete
                if g not in complete or g in seen:
                    continue
                seen.add(g)
            rects.append(x)
        cover = np.zeros((op.rows, op.cols), np.int32)
        for x in rects:
            r0, r1 = max(int(x[3]), 0), min(int(x[4]), op.rows)
            c0, c1 = max(int(x[5]), 0), min(int(x[6]), op.cols)
            cover[r0:r1, c0:c1] += 1
        if (cover != 1).any():
            r, c = np.argwhere(cover != 1)[0]
            emit("K003", f"'{op.name}'[{r}, {c}] has {cover[r, c]} writers "
                         f"({int((cover == 0).sum())} elements none, "
                         f"{int((cover > 1).sum())} several)")
    if spec.split_groups and len(t):
        group_of = dict(zip(t[:, 0].tolist(), t[:, 8].tolist()))
        r = ev[(ev[:, 1] == READ) & (ev[:, 2] == spec.kv_ops[0])]
        keys = [(group_of[b], s, lr) for b, s, lr in zip(r[:, 0].tolist(), r[:, 8].tolist(),
                                                         r[:, 7].tolist()) if b in group_of]
        if len(keys) != len(set(keys)):
            emit("K003", "two pieces of one split group read the same key row")
    if spec.k_whole:
        a = ev[(ev[:, 1] == READ) & (ev[:, 2] == 0)]
        tiles: Dict[tuple, list] = {}
        for x in a:
            tiles.setdefault((int(x[7]), int(x[8])), []).append((int(x[5]), int(x[6])))
        for tile, ranges in tiles.items():
            ranges.sort()
            pos = 0
            for lo, hi in ranges:
                if lo != pos:
                    break
                pos = hi
            if pos != spec.k_whole or any(lo >= hi for lo, hi in ranges):
                emit("K003", f"the splits of output tile {tile} sum K ranges {ranges}, "
                             f"not [0, {spec.k_whole}) once")
                break


def check_kernel_spec(spec: KernelSpec, context: str = "") -> List[Finding]:
    """Run K001-K003 over one kernel instantiation, every hostile fill."""
    out: List[Finding] = []
    ctx = f"{context} kernel={spec.name}" if context else f"kernel={spec.name}"
    seen: set = set()

    def emit(rule: str, msg: str) -> None:
        if (rule, msg) not in seen:
            seen.add((rule, msg))
            out.append(Finding(rule, msg, ctx, spec.src_file, spec.src_line))

    for fill in fills(spec):
        ev = spec.enumerate(fill)
        _bounds(spec, ev, emit)
        _live(spec, fill, ev, emit)
        _writers(spec, ev, emit)
        _coverage(spec, fill, ev, emit)
    return out


def read_rows(spec: KernelSpec, fill, op: int = 1) -> Dict[int, set]:
    """{slot: the rows of operand ``op`` the kernel reads for it} under one
    fill: the rows the card touches, which the sentinel runs keep finite
    and fill every other row with NaN."""
    ev = spec.enumerate(fill)
    r = ev[(ev[:, 1] == READ) & (ev[:, 2] == op)]
    rows: Dict[int, set] = {}
    for s, lo, hi in zip(r[:, 8].tolist(), r[:, 3].tolist(), r[:, 4].tolist()):
        rows.setdefault(s, set()).update(range(lo, hi))
    return rows
