"""The paper's CGRA, as configuration + first-order analytical simulator
(port of ``repro.core.cgra``).

This is the *faithful-reproduction* layer: the paper (qualitative) claims that

  C1  a 4x4 PE array executes block-wise GEMM in parallel,
  C2  a 4x2 MOB array decouples LOAD/STORE from compute (fewer PE stalls),
  C3  a switchless mesh-torus interconnect cuts dynamic power/latency vs a
      switched NoC,
  C4  block-wise execution increases data reuse and cuts external-memory
      bandwidth.

The simulator quantifies all four with first-order cycle/energy models of
the paper's array (28nm-class constants, Horowitz ISSCC'14 lineage: the
CGRA's own, kept as the reference has them).  ``select_block_shapes`` is
the same mapping decision for a GPU block: its memory budget and tile
granularity are arguments, with defaults taken from the H100 (below).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CGRAConfig:
    # heterogeneous array (paper Fig. 2)
    pe_rows: int = 4
    pe_cols: int = 4
    mob_rows: int = 4
    mob_cols: int = 2
    # each PE: one packed MAC per cycle; int8 packs 4 lanes into a 32b word
    pack: dict | None = None  # dtype -> lanes
    rf_words: int = 16  # per-PE output-register words (virtual block tiling)
    freq_mhz: float = 100.0
    # interconnect
    switched_noc: bool = False  # paper baseline comparison
    hop_cycles_switchless: int = 1
    hop_cycles_switched: int = 3
    # MOB decoupling (C2): double-buffered prefetch overlaps mem with compute
    decoupled_mob: bool = True
    # first-order energy constants, pJ (28nm-class)
    e_mac: dict | None = None  # per dtype, pJ / MAC
    e_sram_word: float = 5.0  # shared-L1 access via MOB, 32-bit word
    e_hop_word: float = 0.15  # switchless neighbor link, per word per hop
    e_router_word: float = 0.6  # extra per-hop router cost when switched
    e_pe_idle_cycle: float = 0.05  # leakage+clock per PE per cycle
    e_ctrl_cycle: float = 1.0  # array-level control per cycle

    def __post_init__(self):
        if self.pack is None:
            object.__setattr__(self, "pack", {"int8": 4, "fp16": 2, "fp32": 1})
        if self.e_mac is None:
            object.__setattr__(self, "e_mac", {"int8": 0.2, "fp16": 0.9, "fp32": 3.0})

    @property
    def n_pe(self) -> int:
        return self.pe_rows * self.pe_cols

    @property
    def n_mob(self) -> int:
        return self.mob_rows * self.mob_cols

    @property
    def words_per_cycle(self) -> int:  # one 32-bit LOAD/STORE per MOB per cycle
        return self.n_mob

    @property
    def hop_cycles(self) -> int:
        return self.hop_cycles_switched if self.switched_noc else self.hop_cycles_switchless

    @property
    def mean_hops(self) -> float:
        """Mean torus hop distance PE<->MOB/PE (torus wrap halves distances)."""
        r = (self.pe_rows // 2 + self.pe_cols // 2) / 2
        return max(1.0, r)


@dataclass
class GemmReport:
    M: int
    K: int
    N: int
    dtype: str
    bm: int
    bn: int
    macs: int = 0
    cycles: int = 0
    compute_cycles: int = 0
    mem_cycles: int = 0
    stall_cycles: int = 0
    loads_words: int = 0
    stores_words: int = 0
    hops_words: float = 0.0
    energy_pj: float = 0.0
    time_us: float = 0.0
    power_mw: float = 0.0
    pe_utilization: float = 0.0
    arithmetic_intensity: float = 0.0  # MACs per word moved

    def combine(self, other: "GemmReport") -> "GemmReport":
        out = GemmReport(self.M, self.K, self.N, self.dtype, self.bm, self.bn)
        for f in ("macs", "cycles", "compute_cycles", "mem_cycles", "stall_cycles",
                  "loads_words", "stores_words", "hops_words", "energy_pj",
                  "time_us"):
            setattr(out, f, getattr(self, f) + getattr(other, f))
        tot = out.time_us
        out.power_mw = (out.energy_pj / 1e6) / (tot / 1e6) / 1e3 if tot else 0.0
        out.pe_utilization = out.compute_cycles / max(1, out.cycles)
        words = out.loads_words + out.stores_words
        out.arithmetic_intensity = out.macs / max(1, words)
        return out


def block_shape(cfg: CGRAConfig, dtype: str = "int8") -> tuple[int, int]:
    """Output block computed per pass: the PE grid times the per-PE register
    tile (virtual blocking, C4).  rf_words split between a square-ish rm x rn."""
    rm = max(1, int(math.sqrt(cfg.rf_words)))
    rn = max(1, cfg.rf_words // rm)
    return cfg.pe_rows * rm, cfg.pe_cols * rn


def simulate_gemm(cfg: CGRAConfig, M: int, K: int, N: int,
                  dtype: str = "int8", blocked: bool = True) -> GemmReport:
    """First-order simulation of C = A[M,K] @ B[K,N] on the CGRA.

    ``blocked=False`` models the naive dataflow (each output element streams
    its full row/col with no reuse) — the paper's implicit baseline for C4.
    """
    pack = cfg.pack.get(dtype, 1)
    bm, bn = block_shape(cfg, dtype) if blocked else (1, 1)
    bm, bn = min(bm, M), min(bn, N)
    n_blocks = math.ceil(M / bm) * math.ceil(N / bn)

    rep = GemmReport(M, K, N, dtype, bm, bn)
    rep.macs = M * N * K

    # per block: stream K steps; each step needs bm + bn input words (packed)
    words_in_per_block = (bm + bn) * math.ceil(K / pack)
    words_out_per_block = bm * bn  # int32/fp32 accumulator written back
    rep.loads_words = words_in_per_block * n_blocks
    rep.stores_words = words_out_per_block * n_blocks

    # compute: PE array does n_pe MACs/cycle on packed lanes
    rep.compute_cycles = math.ceil(rep.macs / (cfg.n_pe * pack))
    # memory: MOBs move words_per_cycle words/cycle
    total_words = rep.loads_words + rep.stores_words
    rep.mem_cycles = math.ceil(total_words / cfg.words_per_cycle)

    fill = int(cfg.mean_hops * cfg.hop_cycles) * n_blocks  # pipeline fill per block
    if cfg.decoupled_mob:
        # C2: LOAD/STORE runs ahead of compute; slower side bounds throughput
        rep.cycles = max(rep.compute_cycles, rep.mem_cycles) + fill
    else:
        rep.cycles = rep.compute_cycles + rep.mem_cycles + fill
    rep.stall_cycles = rep.cycles - rep.compute_cycles

    # interconnect traffic: every input word traverses mean_hops links
    rep.hops_words = total_words * cfg.mean_hops

    e_link = cfg.e_hop_word + (cfg.e_router_word if cfg.switched_noc else 0.0)
    rep.energy_pj = (
        rep.macs * cfg.e_mac[dtype]
        + total_words * cfg.e_sram_word
        + rep.hops_words * e_link
        + rep.stall_cycles * cfg.n_pe * cfg.e_pe_idle_cycle
        + rep.cycles * cfg.e_ctrl_cycle
    )
    rep.time_us = rep.cycles / cfg.freq_mhz
    rep.power_mw = (rep.energy_pj / 1e6) / (rep.time_us / 1e6) / 1e3 if rep.time_us else 0.0
    rep.pe_utilization = rep.compute_cycles / max(1, rep.cycles)
    rep.arithmetic_intensity = rep.macs / max(1, total_words)
    return rep


def transformer_gemms(d_model: int, n_heads: int, head_dim: int, d_ff: int,
                      seq: int, vocab: int = 0) -> list[tuple[str, int, int, int]]:
    """The GEMM set of one decoder layer at sequence length `seq` (inference)."""
    H = n_heads * head_dim
    gemms = [
        ("wq", seq, d_model, H),
        ("wk", seq, d_model, H),
        ("wv", seq, d_model, H),
        ("scores", seq * n_heads, head_dim, seq),
        ("attnv", seq * n_heads, seq, head_dim),
        ("wo", seq, H, d_model),
        ("ffn_up", seq, d_model, d_ff),
        ("ffn_gate", seq, d_model, d_ff),
        ("ffn_down", seq, d_ff, d_model),
    ]
    if vocab:
        gemms.append(("lm_head", seq, d_model, vocab))
    return gemms


def simulate_transformer_layer(cfg: CGRAConfig, d_model: int, n_heads: int,
                               head_dim: int, d_ff: int, seq: int,
                               dtype: str = "int8", blocked: bool = True):
    reports = {}
    total = None
    for name, m, k, n in transformer_gemms(d_model, n_heads, head_dim, d_ff, seq):
        r = simulate_gemm(cfg, m, k, n, dtype, blocked)
        reports[name] = r
        total = r if total is None else total.combine(r)
    return total, reports


# ---------------------------------------------------------------------------
# Tile-shape selection — the CGRA "mapper" generalized to a GPU block.
# ---------------------------------------------------------------------------

#: shared memory one thread block may take on sm_90 (227 KiB: CUDA C++
#: Programming Guide, "Compute Capabilities", compute capability 9.0);
#: halved for double buffering, as the reference halves its on-chip budget
SMEM_BLOCK_BYTES = 227 * 1024
#: one warpgroup ``wgmma`` instruction's M (64: PTX ISA, "Asynchronous
#: Warpgroup Level Matrix Multiply-Accumulate Operation", shape m64nNk16)
TILE_DIM = 64


def select_block_shapes(M: int, K: int, N: int, dtype_bytes: int = 2,
                        budget: int = SMEM_BLOCK_BYTES // 2, acc_bytes: int = 4,
                        tile: int = TILE_DIM) -> tuple[int, int, int]:
    """Pick (bm, bk, bn), multiples of ``tile``, maximizing data reuse
    (large bm x bn output blocks) subject to double-buffered residency:
        2*(bm*bk + bk*bn)*dtype_bytes + bm*bn*acc_bytes <= budget.

    This is the same mapping decision the paper's Memory Controller makes
    for the 4x4 array (C1/C4), and the reference's search and reuse metric
    over a budget and granularity given as arguments.  No port kernel calls
    it: the kernels keep their own tile rules (``kernels/block_gemm.py``'s
    ``gemm_splits``, fixed 64 x 64 / 16-row tiles)."""
    def fits(bm, bk, bn):
        return 2 * (bm * bk + bk * bn) * dtype_bytes + bm * bn * acc_bytes <= budget

    def clamp(x, cap):
        return max(tile, min(((x + tile - 1) // tile) * tile, cap))

    best = (tile, tile, tile)
    best_reuse = -1.0
    caps = (clamp(M, 4096), clamp(K, 4096), clamp(N, 4096))
    for bm in range(tile, caps[0] + 1, tile):
        for bn in range(tile, caps[2] + 1, tile):
            for bk in (tile, 2 * tile, 4 * tile, 8 * tile):
                if bk > caps[1] or not fits(bm, bk, bn):
                    continue
                # reuse metric: MACs per input word moved
                reuse = (bm * bn * bk) / (bm * bk + bk * bn)
                if reuse > best_reuse:
                    best_reuse, best = reuse, (bm, bk, bn)
    return best
