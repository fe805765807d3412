"""Model accounting (the model-FLOP part of ``repro.launch.roofline``):
parameter counts from the port's ``param_specs``, the analytic model FLOPs
of a (config, shape) cell, and the roofline terms of one card.

    compute = flops / PEAK_FLOPS
    memory  = bytes / HBM_BW

The peaks are NVIDIA's H100 SXM5 data sheet's for the card the port runs
on ("NVIDIA H100 80GB HBM3, 700 W"): dense bf16 989 TFLOP/s and HBM3
3.35 TB/s.  One card has no link term.  The reference's HLO readers
(``collective_bytes``, ``scope_output_bytes``, ``terms_from_pair``) read
XLA compile artifacts of its multi-device dry run and are not ported
(ROADMAP Queue 1 item 13); :func:`extrapolate` is their depth
extrapolation over ``main_repeats`` 1 and 2.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models.model import param_specs

PEAK_FLOPS = 989e12  # dense bf16 tensor-core rate, H100 SXM5 data sheet
HBM_BW = 3.35e12     # bytes/s, HBM3, H100 SXM5 data sheet


@dataclass
class RooflineTerms:
    flops: float = 0.0  # device flops
    bytes: float = 0.0  # device memory bytes accessed
    attn_core_bytes: float = 0.0  # plain-attention traffic that a flash
    # kernel keeps on chip (shared memory and registers)

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
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def t_bound_serial(self) -> float:
        return self.t_compute + self.t_memory

    @property
    def t_bound_overlap(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def t_bound_overlap_flash(self) -> float:
        return max(self.t_compute, self.t_memory_flash)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "attn_core_bytes": self.attn_core_bytes,
                "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
                "t_memory_flash_s": self.t_memory_flash, "bottleneck": self.bottleneck}


def extrapolate(v1: float, v2: float, repeats: int) -> float:
    """Linear depth extrapolation from main-stage repeats 1 and 2 (exact:
    a stage's layers are identical)."""
    return v1 + (v2 - v1) * (repeats - 1)


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
