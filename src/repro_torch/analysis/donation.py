"""Cache-buffer checks (rules D001/D002): the port's counterpart of
``repro.analysis.donation``.

The reference donates the caches to its jitted steps, and XLA reuses a
donated buffer only for an output of the same shape and dtype; a donation
that matches no output is dead.  The port has no donation: a served entry
updates the caches in place.  Its hazard is the same buffer bookkeeping
seen from the other side -- an entry that leaves a cache leaf bound to a
new storage has dropped the caller's buffer and allocated a fresh one,
every call (and a captured decode graph keeps writing the old one).  So
D001 compares the storage of every cache leaf before and after an entry,
and D002 finds two cache leaves on one storage where the config declares
no alias.  MLA's declared alias, v is k, is one leaf in the port (the
fused ``kv`` pool, handed to the decode kernel as both k and v), so no two
leaves may share a storage in any config."""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix or "/", tree


def storages(caches) -> dict:
    """{leaf path: the identity of its storage} of a cache tree."""
    return {p: leaf.untyped_storage()._cdata for p, leaf in _paths(caches)}


def check_donation(before: dict, caches, context: str = "") -> List[Finding]:
    """D001: every leaf of ``caches`` still on the storage ``before``
    (:func:`storages` taken before the entry) recorded for it."""
    after = storages(caches)
    return [Finding("D001", f"cache leaf {p} is on a new storage after the entry: the "
                            f"caller's buffer was dropped and a fresh one allocated",
                    context)
            for p, key in before.items() if after.get(p) != key]


def check_aliases(caches, context: str = "", declared=()) -> List[Finding]:
    """D002: no two leaves of ``caches`` on one storage, but the pairs of
    paths in ``declared``."""
    out, seen = [], {}
    for p, key in storages(caches).items():
        q = seen.setdefault(key, p)
        if q != p and (q, p) not in declared and (p, q) not in declared:
            out.append(Finding("D002", f"cache leaves {q} and {p} share one storage and "
                                       f"the config declares no such alias", context))
    return out
