"""Roofline terms and model accounting (port of ``repro.launch.roofline``):
parameter counts from the port's ``param_specs``, the analytic model FLOPs
of a (config, shape) cell, and the three terms of a device's step:

    compute    = flops            / PEAK_FLOPS
    memory     = bytes            / HBM_BW
    collective = collective_bytes / LINK_BW

The peaks are NVIDIA's H100 SXM5 data sheet's for the card the port runs
on ("NVIDIA H100 80GB HBM3, 700 W"): dense bf16 989 TFLOP/s, HBM3 3.35
TB/s, and NVLink 4 at 900 GB/s a GPU, 450 GB/s a direction.  One link rate
for every collective, as the reference has one: a 16-wide model axis spans
two 8-GPU NVLink nodes, so the rate is optimistic there (ROADMAP Queue 3).

The dry run (``launch.dryrun``) supplies the counts: flops and bytes from
``launch.dry_costs.DryCounter`` at main-stage depths 1 and 2
(:func:`terms_from_pair`, :func:`extrapolate`), collective bytes from a
``launch.mesh.DryMesh``'s records (:func:`collective_bytes`, which reads
them where the reference parses optimized HLO text), and the attention
core's bytes from the counter's scope (:func:`scope_output_bytes`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models.model import param_specs

PEAK_FLOPS = 989e12  # dense bf16 tensor-core rate, H100 SXM5 data sheet
HBM_BW = 3.35e12     # bytes/s, HBM3, H100 SXM5 data sheet
LINK_BW = 450e9      # bytes/s a direction, NVLink 4 (900 GB/s a GPU), H100 SXM5 data sheet

# wire-byte multiplier on a collective's *output*, the reference's ring
# estimates: all-gather ~ the gathered size, all-reduce ~ 2x the buffer
# (reduce-scatter + all-gather), reduce-scatter ~ (group - 1) x its output
# (set per record), all-to-all ~ the buffer, a permute exactly one hop
_FACTORS = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
            "all-to-all": 1.0, "collective-permute": 1.0}


def collective_bytes(records) -> dict:
    """Per-device wire bytes by collective kind from a ``DryMesh``'s
    ``records`` ((kind, axis, group size, payload bytes) each), in the
    reference's output dict: each kind's bytes under :data:`_FACTORS` on the
    collective's output (an all-gather's is the payload times the group, a
    reduce-scatter's the payload over the group, at ``group - 1``), a
    ``broadcast`` key when a record is one (the output, once), ``total``,
    ``cross_pod`` and ``counts``.  ``cross_pod`` is the traffic over the
    ``pod`` axis exactly (the reference guesses it from a group of 2:
    ROADMAP Queue 3)."""
    out = {k: 0.0 for k in _FACTORS}
    counts = {k: 0 for k in _FACTORS}
    cross_pod = 0.0
    for kind, axis, group, payload in records:
        if kind not in out:
            out[kind], counts[kind] = 0.0, 0
        if kind == "all-gather":
            wire = payload * group
        elif kind == "reduce-scatter":
            wire = payload / group * max(1.0, group - 1.0)
        else:
            wire = payload * _FACTORS.get(kind, 1.0)
        out[kind] += wire
        counts[kind] += 1
        if axis == "pod":
            cross_pod += wire
    out["total"] = sum(out.values())
    out["cross_pod"] = cross_pod
    out["counts"] = counts
    return out


def scope_output_bytes(scope_bytes: dict, scope: str = "attn_core") -> float:
    """The bytes the ops inside ``scope`` moved, forward and backward, from
    a ``DryCounter``'s ``scope_bytes`` (the reference sums ~2x the output
    bytes of the ops its HLO text tags with the scope).  For the
    flash-adjusted memory term: the plain attention's scores and softmax
    traffic, which the flash kernel keeps on chip."""
    return float(scope_bytes.get(scope, 0.0))


@dataclass
class RooflineTerms:
    flops: float = 0.0  # device flops
    bytes: float = 0.0  # device memory bytes accessed
    coll_bytes: float = 0.0  # device wire bytes
    attn_core_bytes: float = 0.0  # plain-attention traffic that a flash
    # kernel keeps on chip (shared memory and registers)
    coll_detail: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BW

    @property
    def t_memory_flash(self) -> float:
        """Memory term with the attention core costed as the flash kernel."""
        return max(self.bytes - self.attn_core_bytes, 0.0) / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound_serial(self) -> float:
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def t_bound_overlap(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_bound_overlap_flash(self) -> float:
        return max(self.t_compute, self.t_memory_flash, self.t_collective)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "coll_bytes": self.coll_bytes,
                "attn_core_bytes": self.attn_core_bytes,
                "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
                "t_memory_flash_s": self.t_memory_flash,
                "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
                "coll_detail": self.coll_detail}


def extrapolate(v1: float, v2: float, repeats: int) -> float:
    """Linear depth extrapolation from main-stage repeats 1 and 2 (exact:
    a stage's layers are identical)."""
    return v1 + (v2 - v1) * (repeats - 1)


def terms_from_pair(cost1: dict, cost2: dict, coll1: dict, coll2: dict,
                    repeats: int, attn1: float = 0.0, attn2: float = 0.0) -> RooflineTerms:
    """The full-depth terms from the costs (``{"flops", "bytes accessed"}``)
    and :func:`collective_bytes` of the main stage at depths 1 and 2, and
    the attention core's bytes at each."""
    fl = extrapolate(cost1.get("flops", 0.0), cost2.get("flops", 0.0), repeats)
    by = extrapolate(cost1.get("bytes accessed", 0.0), cost2.get("bytes accessed", 0.0),
                     repeats)
    cb = extrapolate(coll1["total"], coll2["total"], repeats)
    ab = extrapolate(attn1, attn2, repeats)
    kinds = [k for k in coll1 if k not in ("total", "cross_pod", "counts")]
    detail = {k: extrapolate(coll1[k], coll2.get(k, 0.0), repeats) for k in kinds}
    return RooflineTerms(flops=fl, bytes=by, coll_bytes=cb, attn_core_bytes=ab,
                         coll_detail=detail)


def active_params(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter counts from the param specs, by
    the reference's rules: an expert FFN leaf counts ``experts_per_token /
    num_experts`` of its size, a vocab leaf (embedding, head) in full."""
    total = active = 0
    for s in tree_leaves(param_specs(cfg)):
        n = math.prod(s.shape)
        total += n
        if "experts" in str(s.axes) and "ffn" in str(s.axes):
            active += n * cfg.experts_per_token / max(1, cfg.num_experts)
        else:
            active += n
    return int(total), int(active)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6 * N_active * tokens (train) / 2 * N_active * tokens (inference; a
    decode step is one token a sequence)."""
    _, act = active_params(cfg)
    toks = shape.global_batch * (shape.seq_len if shape.step != "decode" else 1)
    mult = 6 if shape.step == "train" else 2
    return float(mult * act * toks)
