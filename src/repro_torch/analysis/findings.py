"""Finding / report data model and the rule catalogue of
``repro_torch.analysis`` (the port's copy of ``repro.analysis.findings``).

Every rule keeps the reference's stable id, with the port's meaning: ``J*``
read the ATen ops an entry runs (``op_lints``) and the collectives a dry
mesh records (``mesh_lints``), ``D*`` the cache storages around an entry
(``donation``), ``K*`` the CUDA kernels' address arithmetic in
``kernels/csrc/index.cuh`` (``bounds``), ``P*`` the paging invariants and
``R*`` the resilience scenarios (``runner``).  ``--disable RULE`` on the CLI
silences one."""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

RULES: Dict[str, str] = {
    "J001": "stray dequant: an int8/uint8 -> float copy (_to_copy) inside a "
            "served entry, outside a kernel's plain version (the int32-"
            "accumulate epilogue's stand-in)",
    "J002": "unaccumulated product: an int8 product (mm, bmm, addmm, "
            "baddbmm, _int_mm, convolution, or what matmul / einsum "
            "decompose to) without an int32 result, or a bf16/f16 product "
            "with a bf16/f16 result",
    "J003": "host transfer: a device -> host read (_local_scalar_dense) or "
            "an op whose output shape depends on data (nonzero, "
            "masked_select, unique, ...) inside a model entry; on the card "
            "any synchronising call under torch.cuda.set_sync_debug_mode; "
            "a ModelRunner tick with more than its one documented copy",
    "J004": "host constant: a host array above the size threshold copied "
            "to the step's device inside an entry (rebuilt every call, "
            "replayed stale by a captured decode graph)",
    "J005": "wide dtype leak: a float64/complex128 op output inside a "
            "served entry",
    "J006": "logit round trip: model entry returns logits in a dtype "
            "narrower than f32 (sampler upcasts quantized values)",
    "J007": "sharded-surface hazard: the mesh engine all-gathers a whole "
            "parameter (or its per-layer slice) of at least 4096 elements, "
            "or stages a collective through host memory under nccl",
    "D001": "dropped buffer: a served entry that updates the caches in "
            "place leaves a cache leaf on new storage (the caller's buffer "
            "was dropped and a fresh one allocated)",
    "D002": "aliased buffers: two cache leaves share storage where the "
            "config declares no alias (MLA's v is k is the one declared)",
    "K001": "out-of-bounds address: an address index.cuh returns for a "
            "kernel (a row, a page-table entry, a partial slot or ticket, "
            "a GEMM tile) lies outside its operand, for some block and "
            "hostile scalars",
    "K002": "dead rows read: a block reads a K/V row outside its live set, "
            "or a block with no live row reads one (the CUDA form of "
            "'dead blocks cost no DMA')",
    "K003": "writer conflict: an output element, split partial or ticket "
            "without exactly one writer (or the last ticket holder of its "
            "group), split K ranges that do not cover K once, or a key row "
            "a query sees that no block of its query rows reads",
    "P001": "paging invariant violation (PagePool/RadixCache structural "
            "check, see serving.paging.check_invariants)",
    "R001": "unreachable resilience branch: a FinishReason the Scheduler "
            "must be able to emit was not produced by the canonical "
            "degraded-mode scenario suite (see runner.check_resilience)",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    message: str
    context: str = ""          # e.g. "config=olmo-1b mode=plain entry=decode"
    file: Optional[str] = None
    line: Optional[int] = None
    severity: str = "error"

    def where(self) -> str:
        if self.file:
            return f"{self.file}:{self.line or 0}"
        return "<no provenance>"

    def __str__(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return f"{self.rule} {self.where()}{ctx}: {self.message}"

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    findings: List[Finding] = dataclasses.field(default_factory=list)
    checked: List[str] = dataclasses.field(default_factory=list)
    disabled: List[str] = dataclasses.field(default_factory=list)

    def add(self, finding: Finding) -> None:
        if finding.rule not in self.disabled:
            self.findings.append(finding)

    def extend(self, findings) -> None:
        for f in findings:
            self.add(f)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def exit_code(self, strict: bool = False) -> int:
        if strict:
            return 1 if self.findings else 0
        return 1 if self.errors() else 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "findings": [f.to_json() for f in self.findings],
            "checked": self.checked,
            "disabled": self.disabled,
            "rules": RULES,
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
