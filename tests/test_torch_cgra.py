"""The port's copy of the paper's CGRA simulator (``repro_torch.core.cgra``)
against the reference's ``repro.core.cgra``: claims C1-C4 and the
ultra-low-power class as ``tests/test_core.py`` holds them, every
``GemmReport`` field equal (exactly: the same arithmetic in the same order)
over a grid of shapes, dtypes and array options, the transformer layer,
and the mapper equal when given the reference's own budget and
granularity (imported here from the reference, never written into the
port)."""
import dataclasses
import itertools

import pytest

import repro.core.cgra as J
import repro_torch.core.cgra as T

CFG = T.CGRAConfig()


def test_c4_blocking_increases_reuse_and_cuts_traffic():
    b = T.simulate_gemm(CFG, 256, 256, 256, "int8", blocked=True)
    n = T.simulate_gemm(CFG, 256, 256, 256, "int8", blocked=False)
    assert b.loads_words < n.loads_words / 2
    assert b.arithmetic_intensity > 4 * n.arithmetic_intensity
    assert b.macs == n.macs


def test_c2_mob_decoupling_cuts_stalls():
    dec = T.simulate_gemm(CFG, 256, 256, 256, "int8")
    ser = T.simulate_gemm(T.CGRAConfig(decoupled_mob=False), 256, 256, 256, "int8")
    assert dec.cycles < ser.cycles and dec.stall_cycles < ser.stall_cycles


def test_c3_switchless_torus_saves_energy_and_latency():
    t, _ = T.simulate_transformer_layer(CFG, 256, 4, 64, 1024, seq=128)
    s, _ = T.simulate_transformer_layer(T.CGRAConfig(switched_noc=True), 256, 4, 64, 1024,
                                        seq=128)
    assert s.energy_pj > t.energy_pj and s.cycles >= t.cycles


def test_c1_pe_array_throughput_scales():
    small = T.simulate_gemm(T.CGRAConfig(pe_rows=2, pe_cols=2), 512, 512, 512, "int8")
    big = T.simulate_gemm(T.CGRAConfig(pe_rows=8, pe_cols=8), 512, 512, 512, "int8")
    assert big.compute_cycles * 15 < small.compute_cycles * 16


def test_ultra_low_power_class():
    r = T.simulate_gemm(CFG, 128, 256, 128, "int8")
    assert r.power_mw < 10.0 and r.pe_utilization > 0.5


SHAPES = [(1, 1, 1), (7, 33, 5), (128, 256, 128), (256, 256, 256), (300, 1000, 77)]


@pytest.mark.parametrize("switched,decoupled", list(itertools.product([False, True],
                                                                       [False, True])))
def test_every_report_field_equals_the_reference(switched, decoupled):
    jc = J.CGRAConfig(switched_noc=switched, decoupled_mob=decoupled)
    tc = T.CGRAConfig(switched_noc=switched, decoupled_mob=decoupled)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.n_pe, jc.n_mob, jc.hop_cycles, jc.mean_hops) == (
        tc.n_pe, tc.n_mob, tc.hop_cycles, tc.mean_hops)
    for (M, K, N), dtype, blocked in itertools.product(SHAPES, ("int8", "fp16", "fp32"),
                                                       (True, False)):
        want = J.simulate_gemm(jc, M, K, N, dtype, blocked)
        got = T.simulate_gemm(tc, M, K, N, dtype, blocked)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (M, K, N, dtype, blocked)
        assert dataclasses.asdict(got.combine(got)) == dataclasses.asdict(want.combine(want))
    assert T.block_shape(tc, "int8") == J.block_shape(jc, "int8")


def test_transformer_layer_equals_the_reference():
    for seq, dtype in ((1, "int8"), (128, "int8"), (64, "fp16")):
        assert T.transformer_gemms(256, 4, 64, 1024, seq, vocab=512) == J.transformer_gemms(
            256, 4, 64, 1024, seq, vocab=512)
        jt, jr = J.simulate_transformer_layer(J.CGRAConfig(), 256, 4, 64, 1024, seq, dtype)
        tt, tr = T.simulate_transformer_layer(CFG, 256, 4, 64, 1024, seq, dtype)
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        assert {k: dataclasses.asdict(v) for k, v in tr.items()} == {
            k: dataclasses.asdict(v) for k, v in jr.items()}


@pytest.mark.parametrize("m,k,n", [(16, 16, 16), (128, 4096, 128), (1000, 333, 2048),
                                   (4096, 4096, 4096), (8, 2048, 50432)])
def test_mapper_equals_the_reference_at_its_constants(m, k, n):
    for dtype_bytes in (1, 2, 4):
        want = J.select_block_shapes(m, k, n, dtype_bytes=dtype_bytes)
        got = T.select_block_shapes(m, k, n, dtype_bytes=dtype_bytes,
                                    budget=J.TPU_VMEM_BYTES // 2, tile=J.MXU_DIM)
        assert got == want


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (8, 2048, 8192), (4096, 2048, 50432)])
def test_mapper_defaults_fit_a_hopper_block(m, k, n):
    bm, bk, bn = T.select_block_shapes(m, k, n)
    assert bm % 64 == bk % 64 == bn % 64 == 0
    assert 2 * (bm * bk + bk * bn) * 2 + bm * bn * 4 <= 227 * 1024 // 2
