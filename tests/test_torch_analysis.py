"""Mutation harness for ``repro_torch.analysis`` (the port's counterpart of
``tests/test_analysis.py``): every rule fires on a seeded defect and stays
silent on the healthy equivalent; the bounds proofs read the header the
CUDA kernels include (a clamp removed from a copy of it trips them); the
port's rule set, hostile fills and read rows are held to the reference's;
and the repaired findings stay repaired (f32 logits, f32-accumulated
products).  No spawn; the host enumerators build with the host C++
compiler (a missing one fails these tests)."""
import dataclasses
import re
import shutil

import numpy as np
import pytest
import torch

from repro_torch.analysis import (RULES, OpRecorder, RecordingMesh, Report, check_aliases,
                                  check_donation, check_kernel_spec, check_logits_dtype,
                                  lint_collectives, lint_ops, param_gather_shapes, storages)
from repro_torch.analysis import runner as R
from repro_torch.analysis.bounds import fills, read_rows, scalar_candidates
from repro_torch.analysis.findings import Finding
from repro_torch.kernels import _build, ref
from repro_torch.kernels.block_gemm import gemm_spec
from repro_torch.kernels.decode_attention import fd_dense_spec, fd_paged_spec
from repro_torch.kernels.flash_attention import fa_dense_spec, fa_paged_spec
from repro_torch.kernels.spec import READ, TABLE
from repro_torch.launch.dry_costs import DryCounter
from repro_torch.serving.paging import PagePool, RadixCache, check_invariants


def rules_of(findings):
    return {f.rule for f in findings}


def lint_of(fn, *args, device="cpu"):
    rec = OpRecorder()
    with rec:
        fn(*args)
    return lint_ops(rec.ops, device=device)


# ---------------------------------------------------------------------------
# J rules: ATen-op lints
# ---------------------------------------------------------------------------

def test_j001_fires_on_stray_int8_dequant():
    fs = lint_of(lambda x: x.float() * 2.0, torch.zeros((4, 4), dtype=torch.int8))
    assert rules_of(fs) == {"J001"}
    assert fs[0].file and "test_torch_analysis" in fs[0].file  # provenance


def test_j001_allows_int8_to_int32():
    assert lint_of(lambda x: x.to(torch.int32) + 1, torch.zeros((4, 4), dtype=torch.int8)) == []


def test_j002_fires_on_unaccumulated_bf16_product():
    a = torch.zeros((8, 8), dtype=torch.bfloat16)
    assert "J002" in rules_of(lint_of(lambda a, b: a @ b, a, a))
    b3 = torch.zeros((2, 8, 8), dtype=torch.bfloat16)
    assert "J002" in rules_of(lint_of(lambda a, b: torch.einsum("gij,gjk->gik", a, b), b3, b3))


def test_j002_fires_on_int8_product_without_int32():
    a = torch.zeros((8, 8), dtype=torch.int8, device="meta")
    assert "J002" in rules_of(lint_of(torch.mm, a, a, device="meta"))


def test_j002_silent_on_f32_accumulated_product():
    from repro_torch.models.layers import matmul_f32
    a = torch.zeros((8, 8), dtype=torch.bfloat16)
    assert lint_of(lambda a, b: matmul_f32(a, b).to(torch.bfloat16), a, a) == []
    am = a.to("meta")  # the card's route: mm with an f32 out_dtype
    assert lint_of(lambda a, b: matmul_f32(a, b).to(torch.bfloat16), am, am,
                   device="meta") == []


def test_j003_fires_on_host_reads():
    assert "J003" in rules_of(lint_of(lambda x: x.sum().item(), torch.ones(4)))
    assert "J003" in rules_of(lint_of(lambda x: torch.nonzero(x > 0), torch.ones(4)))


def test_j003_host_read_on_meta_ends_the_entry_as_a_finding():
    report = Report()
    R._lint_entry(report, lambda: torch.zeros(4, device="meta").sum().item(), "ctx", "meta")
    assert rules_of(report.findings) == {"J003"}
    assert "test_torch_analysis" in report.findings[0].file


def test_j004_fires_on_large_host_constant():
    big = np.ones((256, 256), np.float32)  # 256 KiB
    assert "J004" in rules_of(lint_of(lambda: torch.tensor(big)))
    fs = lint_of(lambda x: x + torch.from_numpy(big).to("meta"),
                 torch.zeros((256, 256), device="meta"), device="meta")
    assert "J004" in rules_of(fs)
    small = np.ones((8, 8), np.float32)
    assert lint_of(lambda: torch.tensor(small)) == []


def test_j005_fires_on_f64_leak():
    assert rules_of(lint_of(lambda x: x.double() * 2.0, torch.zeros(4))) == {"J005"}


def test_plain_versions_are_booked_not_linted():
    """The plain int8 GEMM sums int8 products in f64 (CUDA has no integer
    matmul): inside it the ops are the kernel's; the same product outside
    a plain version fires J001 and J005."""
    a = torch.randint(-127, 128, (4, 16), dtype=torch.int8)
    b = torch.randint(-127, 128, (8, 16), dtype=torch.int8)
    rec = OpRecorder()
    with rec:
        ref.block_gemm_int8_acc_ref(a, b)
    assert lint_ops(rec.ops) == [] and rec.kernels["block_gemm_int8_acc"] > 0
    fs = lint_of(lambda a, b: torch.matmul(a.to(torch.float64), b.to(torch.float64).T)
                 .to(torch.int32), a, b)
    assert {"J001", "J005"} <= rules_of(fs)


def test_j006_fires_on_bf16_logits():
    assert rules_of(check_logits_dtype(torch.zeros(2, 1, 256, dtype=torch.bfloat16))) \
        == {"J006"}
    assert check_logits_dtype(torch.zeros(2, 1, 256)) == []


# ---------------------------------------------------------------------------
# J007: the mesh engine's collectives on a recording dry mesh
# ---------------------------------------------------------------------------

def test_j007_fires_on_full_param_all_gather():
    mesh = RecordingMesh((1, 2), ("data", "model"), backend="nccl")
    w = torch.zeros(128, 16384 // 2, device="meta")  # this rank's column shard
    mesh.all_gather(w, "model", dim=1)
    fs = lint_collectives(mesh.trace, {(128, 16384)}, device="meta", backend="nccl")
    assert rules_of(fs) == {"J007"} and "(128, 16384)" in fs[0].message


def test_j007_ignores_activation_all_gather():
    mesh = RecordingMesh((1, 2), ("data", "model"))
    mesh.all_gather(torch.zeros(2, 1, 64, device="meta"), "model", dim=1)
    assert lint_collectives(mesh.trace, {(128, 16384)}, device="meta") == []


def test_j007_fires_on_host_staging_under_nccl_only():
    trace = [("all-reduce", "model", (4,), "cpu")]
    fs = lint_collectives(trace, set(), backend="nccl", device="cuda")
    assert rules_of(fs) == {"J007"} and "host memory" in fs[0].message
    assert lint_collectives(trace, set(), backend="gloo", device="cuda") == []


def test_j007_silent_on_clean_trace_and_dedupes():
    mesh = RecordingMesh((1, 2), ("data", "model"), backend="nccl")
    mesh.all_reduce(torch.zeros(64, 64, device="meta"), "model")
    assert lint_collectives(mesh.trace, {(64, 64)}, device="meta", backend="nccl") == []
    trace = [("all-gather", "model", (128, 16384), "meta")] * 3
    assert len(lint_collectives(trace, {(128, 16384)}, device="meta")) == 1


def test_param_gather_shapes_layer_slices():
    params = {"stacked": torch.zeros(4, 128, 256), "flat": torch.zeros(256, 512),
              "tiny": torch.zeros(8)}
    shapes = param_gather_shapes(params)
    assert (4, 128, 256) in shapes and (128, 256) in shapes and (256, 512) in shapes
    assert (8,) not in shapes


def test_j007_fires_on_a_mesh_entry_that_regathers_a_weight(monkeypatch):
    """The mesh engine's decode on a 1 x 2 recording mesh, with the head
    mutated to gather its vocab-sharded weight back whole: J007 fires; the
    shipped engine is silent (``test_full_matrix_is_clean``)."""
    from repro_torch.launch.sharding import current_mesh
    from repro_torch.models import model as M
    orig = M.head_logits

    def gathering(cfg, params, hidden):
        w = params.get("lm_head")
        if w is not None:
            current_mesh().all_gather(w, "model", dim=1)
        return orig(cfg, params, hidden)

    monkeypatch.setattr(M, "head_logits", gathering)
    report = Report()
    R.check_sharded("olmo-1b", report)
    assert rules_of(report.findings) == {"J007"}


# ---------------------------------------------------------------------------
# D rules: cache buffers around the in-place entries
# ---------------------------------------------------------------------------

def _caches():
    return [{"0": {"k": torch.zeros(2, 4, 8), "v": torch.zeros(2, 4, 8)}}]


def test_d001_fires_when_an_entry_drops_a_cache_buffer():
    caches = _caches()
    before = storages(caches)
    caches[0]["0"]["k"] = caches[0]["0"]["k"] + 1.0  # a fresh buffer
    assert rules_of(check_donation(before, caches)) == {"D001"}


def test_d002_fires_on_undeclared_shared_storage():
    caches = _caches()
    caches[0]["0"]["v"] = caches[0]["0"]["k"][:]
    assert rules_of(check_aliases(caches)) == {"D002"}
    assert check_aliases(caches, declared={("/0/0/k", "/0/0/v")}) == []


def test_donation_silent_on_in_place_updates():
    caches = _caches()
    before = storages(caches)
    caches[0]["0"]["k"].add_(1.0)
    caches[0]["0"]["v"][0].copy_(caches[0]["0"]["k"][1])
    assert check_donation(before, caches) == [] and check_aliases(caches) == []


def test_d001_fires_on_an_engine_entry_that_rebinds_a_pool(monkeypatch):
    from repro_torch.serving.engine import ModelRunner

    def copy_page(self, src, dst):  # a fresh buffer of the same layout, drop row included
        leaf = self.caches[0]["0"]
        t = leaf["k"]
        leaf["k"] = t.new_empty(0).set_(t.untyped_storage().clone(), t.storage_offset(),
                                        t.shape, t.stride())

    monkeypatch.setattr(ModelRunner, "copy_page", copy_page)
    report = Report()
    R.check_cell("olmo-1b", "plain", "none", report)
    assert {f.rule for f in report.findings} == {"D001"}
    assert all("copy_page" in f.context for f in report.findings)


# ---------------------------------------------------------------------------
# K rules: the header's address arithmetic
# ---------------------------------------------------------------------------

def _mutant(tmp_path, old, new):
    """The host enumerators built from a copy of the header with ``old``
    replaced by ``new``."""
    for name in ("index.cuh", "index_host.cpp"):
        shutil.copy(_build.CSRC / name, tmp_path / name)
    text = (tmp_path / "index.cuh").read_text()
    assert old in text
    (tmp_path / "index.cuh").write_text(text.replace(old, new))
    return _build.host_library(tmp_path, tmp_path / "build")


def test_kernels_include_the_header_the_prover_reads():
    for src in ("decode_attention.cu", "flash_attention.cu", "block_gemm.cu",
                "block_gemm_int8.cu", "index_host.cpp"):
        text = (_build.CSRC / src).read_text()
        assert '#include "index.cuh"' in text, src
        assert "ix::" in text or "using namespace repro::ix" in text, src


def test_paged_page_entry_oob_without_npp_clamp(tmp_path):
    """The counterpart of the reference's test_paged_kv_map_oob_without_clamp:
    without the npp - 1 clamp a frozen slot (pos == S) names a table entry
    past its row."""
    lib = _mutant(tmp_path, "imin(r / ps, npp - 1)", "r / ps")
    fs = check_kernel_spec(fd_paged_spec(2, 4, 2, 64, 64, 16, 4, 9, lib=lib))
    assert "K001" in rules_of(fs)
    assert any("page table" in f.message or "named row" in f.message for f in fs)
    assert fs[0].file.endswith("index.cuh")


def test_k001_k003_fire_without_the_live_block_clamp(tmp_path):
    lib = _mutant(tmp_path, "imin(p_b, S - 1)", "p_b")
    fs = check_kernel_spec(fd_paged_spec(2, 4, 2, 64, 64, 16, 4, 9, lib=lib))
    assert {"K001", "K003"} <= rules_of(fs)


def test_k002_fires_when_a_block_reads_past_pos(tmp_path):
    lib = _mutant(tmp_path, "imin(p_b - r0, jn - 1)", "p_b - r0")
    fs = check_kernel_spec(fd_paged_spec(2, 4, 2, 64, 64, 16, 5, 11, lib=lib))
    assert "K002" in rules_of(fs)


def test_k003_fires_when_pieces_overlap(tmp_path):
    lib = _mutant(tmp_path, "imin(key_hi, piece * FAP_SPLIT + FAP_SPLIT - 1)", "key_hi")
    fs = check_kernel_spec(fa_paged_spec(2, 4, 2, 64, 64, 16, 16, 20, lib=lib))
    assert "K003" in rules_of(fs)


def test_gemm_ragged_edges_need_their_clamps(tmp_path):
    lib = _mutant(tmp_path, "imin(K, kbeg + kc)", "kbeg + kc")
    assert {"K001", "K003"} <= rules_of(check_kernel_spec(gemm_spec(17, 300, 130, lib=lib)))


def test_gemm_split_rows_past_m_are_written_out_of_bounds(tmp_path):
    lib = _mutant(tmp_path, "imin(bm, M - m0)", "bm")
    assert "K001" in rules_of(check_kernel_spec(gemm_spec(70, 512, 1000, lib=lib)))


def test_table_reads_are_guarded_and_recorded(tmp_path):
    """A table read the header makes past the table is recorded and yields
    0 instead of touching memory (the reference's _GuardedTable)."""
    lib = _mutant(tmp_path, "imin(r / ps, npp - 1)", "r / ps")
    spec = fd_paged_spec(1, 2, 2, 16, 16, 16, 2, 3, lib=lib)
    ev = spec.enumerate({"pos": np.array([32]), "start": np.array([0]),
                         "pages": np.array([[1, 2]])})
    t = ev[ev[:, 1] == TABLE]
    assert t[:, 3].max() == 2  # entry npp of a 2-entry table, read and survived



# ---------------------------------------------------------------------------
# K rules: the header's block decisions (exits, tickets, row ranges, masks)
# ---------------------------------------------------------------------------

_KERNELS = ("decode_attention.cu", "flash_attention.cu", "block_gemm.cu", "block_gemm_int8.cu")

#: each block decision of index.cuh -> the kernels that take it; the
#: enumerators of index_host.cpp take every one of them too
_DECISIONS = {
    "decode_last_block": ("decode_attention.cu",),
    "decode_cut_to_live": ("decode_attention.cu",),
    "first_live_block": ("decode_attention.cu",),
    "last_live_block": ("decode_attention.cu",),
    "decode_live_blocks": ("decode_attention.cu",),
    "decode_block_exits": ("decode_attention.cu",),
    "decode_zero_writer": ("decode_attention.cu",),
    "decode_block_live": ("decode_attention.cu",),
    "ring_first_row": ("decode_attention.cu",),
    "ring_last_row": ("decode_attention.cu",),
    "rows_from": ("decode_attention.cu",),
    "rows_to": ("decode_attention.cu",),
    "decode_reads_row": ("decode_attention.cu",),
    "decode_writes_direct": ("decode_attention.cu",),
    "decode_tickets": ("decode_attention.cu",),
    "tile_has_pieces": ("flash_attention.cu",),
    "piece_of": ("flash_attention.cu",),
    "piece_exits": ("flash_attention.cu",),
    "piece_key_lo": ("flash_attention.cu",),
    "piece_key_hi": ("flash_attention.cu",),
    "piece_merges": ("flash_attention.cu",),
    "piece_tickets": ("flash_attention.cu",),
    "first_key_row": ("flash_attention.cu",),
    "core_tile_live": ("flash_attention.cu",),
    "first_tile": ("flash_attention.cu",),
    "tile_count": ("flash_attention.cu",),
    "split_k_tiles": ("block_gemm.cu", "block_gemm_int8.cu"),
    "whole_k_tiles": ("block_gemm_int8.cu",),
    "gemm_clustered": ("block_gemm.cu", "block_gemm_int8.cu"),
    "gemm_stores_direct": ("block_gemm.cu", "block_gemm_int8.cu"),
    "walk_first": ("block_gemm_int8.cu",),
    "walk_stride": ("block_gemm_int8.cu",),
    "inside": ("flash_attention.cu", "block_gemm.cu", "block_gemm_int8.cu"),
}

#: header helpers the decisions are made of: called nowhere but index.cuh
_HELPERS = ("piece_lo", "piece_hi", "slot_has_rows", "split_reads")


def _code(src):
    """A source file without its comments."""
    return re.sub(r"//[^\n]*", "", (_build.CSRC / src).read_text())


@pytest.mark.parametrize("name", sorted(_DECISIONS))
def test_block_decisions_are_the_headers(name):
    """Each block decision is one index.cuh function that its kernels and
    the host enumerators both call, so the proofs read the control flow the
    card runs."""
    assert re.search(rf"REPRO_HD \w+ {name}\(", _code("index.cuh")), name
    for src in _DECISIONS[name] + ("index_host.cpp",):
        assert f"ix::{name}(" in _code(src), src
    if name == "inside":  # the kernels' two-sided mask is made of it
        assert "return inside(i, ni) && inside(j, nj);" in _code("index.cuh")
        for src in _DECISIONS[name]:
            assert "ix::in_edge(" in _code(src), src


@pytest.mark.parametrize("src", _KERNELS + ("index_host.cpp",))
def test_no_block_decision_is_made_by_hand(src):
    """Neither a kernel nor an enumerator computes a live block or piece
    range, a tile or ticket count, or a helper's part of one, itself: each
    is a literal default or an index.cuh call."""
    text = _code(src)
    for helper in _HELPERS:
        assert not re.search(rf"\b{helper}\(", text), (src, helper)
    for m in re.finditer(r"[^\n]*\b(blo|bhi|plo|phi|nlive|ntiles|tickets|KT)\s*=(?!=)\s*([^;,]*)",
                         text):
        if "constexpr" not in m.group(0) and not re.fullmatch(r"-?\d+", m.group(2).strip()):
            assert "ix::" in m.group(2), (src, m.group(0).strip())
    for line in text.splitlines():
        if "atomicAdd(" in line:
            assert "ix::" in line, (src, line.strip())
    assert not re.search(r"splits\s*==\s*1|splits\s*>\s*1|t0\s*<=\s*key_hi|\+=\s*gridDim\.x",
                         text), src


@pytest.mark.parametrize("src,stmt", [
    ("decode_attention.cu", "j_lo = ring ? ix::ring_first_row() : ix::rows_from(s_b, r0);"),
    ("decode_attention.cu", "j_hi = ring ? ix::ring_last_row(jn) : ix::rows_to(p_b, r0, jn);"),
    ("decode_attention.cu", "blo = ix::first_live_block(s_b);"),
    ("decode_attention.cu", "bhi = ix::last_live_block(p_b, S);"),
    ("flash_attention.cu", "plo = ix::piece_of(key_lo);"),
    ("flash_attention.cu", "phi = ix::piece_of(key_hi);"),
])
def test_kernel_and_enumerator_spell_each_kept_shape_alike(src, stmt):
    """Where a decision keeps the kernel's shape at its call (a ternary on
    the layout, a range's two ends assigned under one header condition),
    the kernel and its enumerator spell it alike."""
    for f in (src, "index_host.cpp"):
        assert stmt in _code(f), f


_FD = dict(B=2, H=4, K=2, dq=64, dv=64, ps=16, npp=4, n_pages=9)


@pytest.mark.parametrize("old,new,make,rules", [
    pytest.param("{ return nlive <= 0 && blk == 0; }", "{ return false; }",
                 lambda lib: fd_paged_spec(**_FD, lib=lib), {"K003"},
                 id="decode-zero-write-dropped"),
    pytest.param("return paged && (blk < blo || blk > bhi);", "return false;",
                 lambda lib: fd_paged_spec(**_FD, lib=lib), {"K003"},
                 id="decode-paged-exit-removed"),
    pytest.param("int nlive) { return paged && nlive == 1; }", "int nlive) { return false; }",
                 lambda lib: fd_paged_spec(**_FD, lib=lib), {"K003"},
                 id="decode-direct-write-through-a-ticket"),
    pytest.param("imin(p_b - r0, jn - 1)", "imin(p_b - r0 - 1, jn - 1)",
                 lambda lib: fd_dense_spec(2, 4, 2, 64, 64, 64, lib=lib), {"K003"},
                 id="decode-rows-one-short"),
    pytest.param("return split && (piece < plo || piece > phi);", "return false;",
                 lambda lib: fa_paged_spec(2, 4, 2, 64, 64, 16, 16, 20, lib=lib), {"K003"},
                 id="flash-piece-exit-removed"),
    pytest.param("{ return t0 <= key_hi; }", "{ return t0 + kt <= key_hi; }",
                 lambda lib: fa_dense_spec(2, 4, 2, 96, 96, 64, dtype=torch.float32, lib=lib),
                 {"K003"}, id="flash-core-tiles-one-short"),
    pytest.param("{ return splits == 1; }", "{ return splits >= 1; }",
                 lambda lib: gemm_spec(8, 2048, 2048, lib=lib), {"K003"},
                 id="gemm-direct-store-by-split-tiles"),
    pytest.param("return static_cast<int>(grid);", "return static_cast<int>(grid) + 1;",
                 lambda lib: gemm_spec(2048, 256, 4096, int8=True, lib=lib), {"K003"},
                 id="gemm-walk-stride-off-by-one"),
    pytest.param("{ return i < n; }", "{ return i <= n; }",
                 lambda lib: gemm_spec(17, 300, 130, lib=lib), {"K001"},
                 id="edge-mask-one-past"),
])
def test_a_mutated_block_decision_trips_the_proofs(tmp_path, old, new, make, rules):
    """One decision changed in the header alone -- the one place it lives --
    is what both the kernels and the proofs read; each such defect trips
    its rule."""
    assert rules <= rules_of(check_kernel_spec(make(_mutant(tmp_path, old, new))))


def test_gemm_unsplit_tile_through_its_cluster_sum_proves_clean(tmp_path):
    """The direct store removed outright leaves a correct program: an
    unsplit tile's one block sums itself over a one-block cluster and
    stores the whole tile in slices.  The proofs stay silent."""
    lib = _mutant(tmp_path, "{ return splits == 1; }", "{ return false; }")
    for spec in (gemm_spec(17, 300, 130, lib=lib), gemm_spec(64, 128, 256, int8=True, lib=lib)):
        assert check_kernel_spec(spec) == []

@pytest.mark.parametrize("spec", [
    fa_dense_spec(2, 4, 2, 96, 96, 64), fa_dense_spec(2, 4, 2, 96, 96, 64, dtype=torch.float32),
    fa_dense_spec(1, 2, 1, 64, 512, 64, window=100),
    fa_paged_spec(2, 4, 2, 32, 64, 16, 4, 9), fa_paged_spec(2, 4, 2, 64, 64, 16, 16, 20),
    fa_paged_spec(2, 4, 2, 32, 64, 16, 4, 9, dtype=torch.float32),
    fd_dense_spec(2, 4, 2, 64, 64, 64, layout="linear"),
    fd_dense_spec(2, 4, 2, 64, 64, 64, layout="ring"),
    fd_paged_spec(2, 4, 2, 64, 64, 16, 4, 9), fd_paged_spec(2, 4, 2, 64, 64, 16, 5, 11),
    fd_paged_spec(2, 40, 1, 288, 256, 16, 5, 9, v_row=288),
    gemm_spec(64, 128, 256), gemm_spec(64, 128, 256, int8=True),
    gemm_spec(8, 2048, 2048), gemm_spec(8, 2048, 2048, int8=True),
    gemm_spec(17, 300, 130), gemm_spec(600, 256, 4000, int8=True),
    gemm_spec(2048, 256, 4096, int8=True)],
    ids=lambda s: s.name)
def test_shipped_kernel_specs_prove_clean(spec):
    assert check_kernel_spec(spec) == []


def test_specs_take_the_wrappers_planning():
    from repro_torch.kernels.decode_attention import decode_scratch, head_groups
    from repro_torch.kernels.flash_attention import key_pieces, paged_scratch
    spec = fd_paged_spec(2, 40, 1, 288, 256, 16, 5, 9, v_row=288)
    assert spec.grid == (2, head_groups(40, 288), 2) == (2, 5, 2)
    part = next(op for op in spec.operands if op.role == "partial")
    assert part.rows * 8 * 258 == decode_scratch(2, 40, 1, 80, 256, 288)[0]
    spec = fa_paged_spec(2, 4, 2, 64, 64, 16, 16, 20)
    assert spec.grid == (key_pieces(16, 16) * 2 * 4,) and spec.split_groups
    part = next(op for op in spec.operands if op.role == "partial")
    assert part.rows * 64 * 66 == paged_scratch(2, 4, 64, 64, 16, 16)[0]


# ---------------------------------------------------------------------------
# parity with the reference's specs
# ---------------------------------------------------------------------------

def test_rule_ids_are_the_references():
    from repro.analysis.findings import RULES as REF
    assert set(RULES) == set(REF) and len(RULES) == 14


def test_hostile_fills_are_the_references():
    from repro.analysis.bounds import _scalar_candidates
    from repro.kernels.spec import ScalarSpec as RefScalar
    for spec in (fd_paged_spec(2, 4, 2, 64, 64, 16, 4, 9),
                 fa_paged_spec(2, 4, 2, 32, 64, 16, 4, 9)):
        for s in spec.scalars:
            ours = scalar_candidates(s)
            theirs = _scalar_candidates(RefScalar(s.name, s.shape, s.lo, s.hi))
            assert len(ours) == len(theirs)
            assert all((a == b).all() for a, b in zip(ours, theirs))


def _ref_rows(spec, fill, page_rows):
    """{slot: pool rows} the reference's kv map names at its live grid
    points, each page's rows restricted by ``page_rows(slot, logical row)``."""
    names = [s.name for s in spec.scalars]
    arrs = [np.asarray(fill[n]) for n in names]
    kv = next(op for op in spec.operands if op.name == "k")
    out = {}
    for gid in np.ndindex(*spec.grid):
        if not spec.block_live(*gid, *arrs):
            continue
        blk = kv.index_map(*gid, *arrs)[0]
        b, ik = gid[0], gid[-1]
        ps = kv.block_shape[1]
        for j in range(ps):
            if page_rows(b, ik * ps + j, gid):
                out.setdefault(b, set()).add(int(blk) * ps + j)
    return out


def test_paged_decode_reads_the_references_live_rows():
    from repro.kernels.decode_attention import fd_paged_spec as ref_spec
    ours, theirs = fd_paged_spec(2, 4, 2, 64, 64, 16, 4, 9), ref_spec(2, 4, 2, 64, 64, 16, 4, 9)
    for fill in fills(ours):
        p, s = fill["pos"], fill["start"]
        want = _ref_rows(theirs, fill, lambda b, r, g: s[b] <= r <= min(p[b], 63))
        assert read_rows(ours, fill) == want


def test_linear_decode_reads_the_references_live_rows():
    from repro.kernels.decode_attention import fd_dense_spec as ref_spec
    ours = fd_dense_spec(2, 4, 2, 64, 64, 64, layout="linear")
    theirs = ref_spec(2, 4, 2, 64, 64, 64, layout="linear")
    kv = next(op for op in theirs.operands if op.name == "k")
    for fill in fills(ours):
        p, s = fill["pos"], fill["start"]
        want = {}
        for gid in np.ndindex(*theirs.grid):
            if theirs.block_live(*gid, p, s):
                b, blk = kv.index_map(*gid, p, s)[:2]
                for j in range(kv.block_shape[1]):
                    r = int(blk) * kv.block_shape[1] + j
                    if s[b] <= r <= min(p[b], 63):
                        want.setdefault(int(b), set()).add(int(b) * 64 + r)
        assert read_rows(ours, fill) == want


def test_paged_chunk_reads_within_the_references_live_pages():
    """Every pool row the port's chunk reads is a row below k_len of a page
    the reference's kv map names at a live grid point (its padded query
    tile sees at least the port's); every key a query attends is read."""
    from repro.kernels.flash_attention import fa_paged_spec as ref_spec
    C, ps, npp = 64, 16, 4
    ours, theirs = fa_paged_spec(2, 4, 2, C, 64, ps, npp, 9), ref_spec(2, 4, 2, C, 64, ps, npp, 9)
    for fill in fills(ours):
        qs, kl, pages = fill["q_start"], fill["k_len"], fill["pages"]
        want = _ref_rows(theirs, fill, lambda b, r, g: r < kl[b])
        got = read_rows(ours, fill)
        for b, rows in got.items():
            assert rows <= want.get(b, set()), (b, fill)
        for b in range(2):
            attended = {int(pages[b, r // ps]) * ps + r % ps
                        for r in range(min(kl[b], qs[b] + C, npp * ps))}
            assert attended <= got.get(b, set())


def test_k_events_carry_logical_rows_and_slots():
    spec = fd_paged_spec(2, 4, 2, 64, 64, 16, 4, 9)
    fill = next(iter(fills(spec)))
    ev = spec.enumerate(fill)
    r = ev[(ev[:, 1] == READ) & (ev[:, 2] == 1)]
    assert len(r) and (r[:, 8] >= 0).all() and (r[:, 7] >= 0).all()


# ---------------------------------------------------------------------------
# P001 / R001
# ---------------------------------------------------------------------------

def test_p001_fires_on_corrupted_refcount():
    pool = PagePool(8)
    pool.alloc()
    pool._rc[2] = 5
    bad = check_invariants(pool)
    assert bad and any("page 2" in m for m in bad)


def test_p001_fires_on_freed_trash_page():
    pool = PagePool(8)
    pool._rc[0] = 0
    pool._free.append(0)
    assert sum("trash page" in m for m in check_invariants(pool)) == 2


def test_p001_fires_on_table_mismatch():
    pool = PagePool(8)
    p = pool.alloc()
    assert any(f"page {p}" in m for m in check_invariants(pool, tables=[[p], [p]]))


def test_p001_silent_on_healthy_workload():
    pool = PagePool(8)
    radix = RadixCache(2, pool)
    a = [pool.alloc(), pool.alloc()]
    radix.insert([1, 2, 3, 4], a)
    assert check_invariants(pool, radix, [a]) == []
    for p in a:
        pool.decref(p)
    radix.evict(pool.n_pages)
    assert check_invariants(pool, radix, []) == []
    report = Report()
    R.check_paging(report)
    assert report.findings == [] and "paging workload" in report.checked


def test_r001_silent_on_healthy_engine():
    report = Report()
    R.check_resilience(report)
    assert report.findings == [] and "resilience scenarios" in report.checked


def test_r001_fires_when_deadline_expiry_disconnected(monkeypatch):
    from repro_torch.serving.engine import Scheduler
    monkeypatch.setattr(Scheduler, "expire", lambda self, now, stats: None)
    report = Report()
    R.check_resilience(report)
    msgs = [f.message for f in report.findings if f.rule == "R001"]
    assert any("DEADLINE" in m for m in msgs) and any("deadline_expired" in m for m in msgs)


def test_r001_fires_when_cancel_disconnected(monkeypatch):
    from repro_torch.serving.engine import Scheduler
    monkeypatch.setattr(Scheduler, "cancel", lambda self, rid, now, stats: False)
    report = Report()
    R.check_resilience(report)
    assert any("CANCELLED" in f.message for f in report.findings if f.rule == "R001")


# ---------------------------------------------------------------------------
# report plumbing and the CLI
# ---------------------------------------------------------------------------

def test_report_disable_and_exit_codes(tmp_path):
    import json
    r = Report(disabled=["J001"])
    r.add(Finding("J001", "suppressed"))
    r.add(Finding("J002", "kept"))
    assert [f.rule for f in r.findings] == ["J002"]
    assert r.exit_code(strict=True) == 1 and Report().exit_code(strict=True) == 0
    p = tmp_path / "report.json"
    r.dump(str(p))
    data = json.loads(p.read_text())
    assert data["findings"][0]["rule"] == "J002" and set(data["rules"]) == set(RULES)


def test_unknown_rule_rejected_by_cli():
    from repro_torch.analysis.__main__ import main
    with pytest.raises(SystemExit):
        main(["--disable", "XXXX"])


def test_list_rules_cli(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in RULES) and len(out.splitlines()) == 14


def test_cuda_mode_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda mode runs")
    with pytest.raises(RuntimeError, match="card"):
        R.run_analysis(configs=["olmo-1b"], modes=("cuda",))


def test_missing_host_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="compiler"):
        _build._cxx()


# ---------------------------------------------------------------------------
# the findings the checker surfaced, repaired
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["olmo-1b", "gemma3-4b"])
@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_logits_reach_sampler_in_f32(name, quant):
    from repro_torch.models import model as M
    cfg = R.analysis_config(name)
    assert cfg.compute_dtype == torch.bfloat16  # the trap this guards against
    params = M.init(cfg, seed=0, device="cpu")
    if quant == "w8a8":
        params = M.quantize_params(cfg, params)
    with torch.no_grad():
        hidden, _ = M.forward_hidden(cfg, params, torch.zeros((2, 16), dtype=torch.int32))
        assert M.lm_logits(cfg, params, hidden).dtype == torch.float32
    report = Report()
    R.check_cell(name, "meta", quant, report)
    assert [f for f in report.findings if f.rule == "J006"] == []


def _moe_cfg():
    from repro_torch.configs import get_config, reduce_config
    return reduce_config(get_config("qwen3-moe-30b-a3b")).with_(compute_dtype=torch.bfloat16)


def test_moe_expert_products_accumulate_in_f32(monkeypatch):
    """The repaired MoE expert block is J002-clean on the card's route
    (meta); the old form -- torch.bmm in the compute dtype -- fires J002."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = _moe_cfg()
    params = M.init(cfg, seed=0, device="cpu")
    lp = {k: v[0].to("meta") for k, v in params["stages"][0]["0"]["ffn"].items()}
    x = torch.zeros(2, 8, cfg.d_model, dtype=torch.bfloat16, device="meta")

    def run():
        rec = OpRecorder()
        with DryCounter(), torch.no_grad(), rec:
            L.moe_forward(cfg, lp, x)
        return lint_ops(rec.ops, device="meta")

    assert [f for f in run() if f.rule == "J002"] == []
    monkeypatch.setattr(L, "matmul_f32", torch.bmm)  # the old form
    assert "J002" in rules_of(run())


def test_bf16_forward_has_no_unaccumulated_products():
    report = Report()
    R.check_cell("gemma3-4b", "meta", "none", report)
    R.check_cell("mamba2-130m", "plain", "none", report)
    R.check_cell("minicpm3-4b", "meta", "none", report)
    assert [f for f in report.findings if f.rule == "J002"] == []


def test_analysis_smoke_single_config():
    report = R.run_analysis(configs=["olmo-1b"], modes=("plain", "meta"))
    assert report.findings == []
    assert any("entry=decode" in c for c in report.checked)
    assert any("kernel=" in c for c in report.checked)
    assert any("paging" in c for c in report.checked)
    assert any("mesh=1x2" in c for c in report.checked)


def test_full_matrix_is_clean():
    """``python -m repro_torch.analysis --modes plain,meta --strict`` over
    every config x quant exits 0."""
    from repro_torch.analysis.__main__ import main
    assert main(["--modes", "plain,meta", "--strict", "-q"]) == 0


def test_spec_fields_are_frozen():
    spec = gemm_spec(8, 64, 64)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.name = "x"
