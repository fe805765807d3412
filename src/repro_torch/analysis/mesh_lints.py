"""Mesh lints (rule J007): the port's counterpart of
``repro.analysis.hlo_lints``.

The reference reads all-gathers and host transfers out of a compiled SPMD
module's HLO.  The port's collectives are explicit calls on a
``launch.mesh.Mesh``, so the analysis drives the mesh engine's entries on
a :class:`RecordingMesh` -- a ``DryMesh`` (no devices, no process group:
unlike the reference this check never skips on one device) that also keeps
each collective's result shape and payload device -- and flags:

* an all-gather whose result is a parameter leaf's shape, or that shape's
  per-layer slice, of at least ``GATHER_ELEMS_THRESHOLD`` elements: the
  placement sharded the weight and a consumer put it back together on
  every rank;
* a collective staged through host memory under ``nccl``: its payload on
  the CPU while the step runs on another device.  Gloo's staging is
  deliberate (gloo moves host memory) and is not flagged.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import DryMesh

# gathers of fewer elements are ignored: small tensors are cheap to
# regather and their shapes collide with activations'
GATHER_ELEMS_THRESHOLD = 4096


class RecordingMesh(DryMesh):
    """A :class:`DryMesh` whose :attr:`trace` keeps, for each collective,
    (kind, axis, shape, payload device): the result shape of an
    all-gather, the payload's of the others.  ``backend``: the backend the
    mesh stands for (None, "gloo", "nccl")."""

    def __init__(self, shape, axes, rank: int = 0, backend=None):
        super().__init__(shape, axes, rank)
        self.backend = backend
        self.trace: List[Tuple] = []

    def _count(self, t, kind: str, axis):
        super()._count(t, kind, axis)
        if kind != "all-gather":
            self.trace.append((kind, axis, tuple(t.shape), t.device.type))

    def all_gather(self, x, axis, dim: int = 0):
        out = super().all_gather(x, axis, dim)
        if out is not x:
            self.trace.append(("all-gather", axis, tuple(out.shape), x.device.type))
        return out


def param_gather_shapes(params) -> Set[Tuple[int, ...]]:
    """Shapes whose appearance as an all-gather result means a whole
    parameter was put back together: each leaf's shape (an int8 leaf's
    ``q``), plus the per-layer slice of a stacked ([R, ...]) leaf."""
    shapes: Set[Tuple[int, ...]] = set()
    for leaf in tree_leaves(params):
        leaf = getattr(leaf, "q", leaf)
        shp = tuple(getattr(leaf, "shape", ()) or ())
        for cand in (shp,) + ((shp[1:],) if len(shp) >= 3 else ()):
            if cand and math.prod(cand) >= GATHER_ELEMS_THRESHOLD:
                shapes.add(cand)
    return shapes


def lint_collectives(trace: Iterable[Sequence], shapes: Iterable[Sequence[int]],
                     context: str = "", backend=None, device: str = "cuda") -> List[Finding]:
    """Rule J007 over a :class:`RecordingMesh`'s trace of one entry run on
    ``device`` over a mesh of ``backend``."""
    out: List[Finding] = []
    suspicious = {tuple(s) for s in shapes}
    seen: set = set()
    for kind, axis, shape, where in trace:
        shape = tuple(shape)
        if kind == "all-gather" and shape in suspicious and shape not in seen:
            seen.add(shape)
            out.append(Finding(
                "J007", f"all-gather over '{axis}' puts a whole parameter of shape {shape} "
                        f"back together: a consumer undoes the weight's placement; shard "
                        f"the consumer or replicate the weight at placement", context))
        if backend == "nccl" and where == "cpu" and device != "cpu" \
                and ("host", kind) not in seen:
            seen.add(("host", kind))
            out.append(Finding(
                "J007", f"{kind} over '{axis}' staged through host memory under nccl "
                        f"inside a served entry", context))
    return out
