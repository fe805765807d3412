"""The port's plain kernel versions (``repro_torch.kernels.ref``, the CPU
path of every wrapper) against the JAX oracles (``repro.kernels.ref``) and
the JAX Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance: f32, max abs <= 1e-5 — XLA and PyTorch sum in different orders,
so results differ by a few f32 ulps of O(1) values, never more.  The CUDA
kernels themselves run only on the card; ``chip_smoke.py`` holds them
against these plain versions there."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro.kernels.block_gemm import block_gemm_int8 as j_block_gemm_int8
from repro.kernels.decode_attention import flash_decode
from repro.kernels.flash_attention import flash_attention
from repro.models import layers as JL
from repro_torch.core import quant as tquant
from repro_torch.core.gemm import cgra_gemm, cgra_gemm_w8a8
from repro_torch.kernels import ref as tref
from repro_torch.kernels.block_gemm import (block_gemm, block_gemm_int8, gemm_splits,
                                            int8_route, int8_splits)
from repro_torch.kernels.decode_attention import decode_scratch, flash_decode_paged
from repro_torch.kernels.decode_attention import flash_decode as t_flash_decode
from repro_torch.kernels.flash_attention import flash_attention as t_flash_attention
from repro_torch.kernels.flash_attention import (dense_smem_bytes, flash_attention_paged,
                                                 key_pieces, paged_scratch)
from repro_torch.kernels.ops import attend_decode, attention
from repro_torch.kernels.quantize import quantize_rows
from repro_torch.models import layers as TL
from repro_torch.models.model import _pool
from repro_torch.models.params import ParamSpec

ATOL = 1e-5  # f32: summation order only (see module docstring)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# block GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(8, 64, 96), (1, 128, 50), (37, 100, 77),
                                   (64, 256, 64)])
def test_block_gemm_plain_matches_jax(M, K, N):
    rng = np.random.RandomState(M + K + N)
    a = rng.randn(M, K).astype(np.float32)
    b = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    want = jref.block_gemm_ref(jnp.asarray(a), jnp.asarray(b))
    close(block_gemm(t(a), t(b)), want)
    close(tref.block_gemm_ref(t(a), t(b), torch.float32), want)


ENGINE_KN = [(2048, 2048), (2048, 8192), (8192, 2048), (2048, 50432)]


def test_gemm_splits_depend_on_k_n_only_and_fill_the_card():
    """The bf16 kernel's split of K is a plain function of (K, N) -- M cannot
    reach it, so every output row is the same sum for every M -- and at the
    engine shapes (olmo-1b projections and head) and the edge ones
    (gemma3-4b) it gives every one of the H100's 132 SMs a block."""
    assert list(inspect.signature(gemm_splits).parameters) == ["K", "N"]
    for K, N in ENGINE_KN + [(2560, 2048), (2560, 10240), (10240, 2560), (2560, 262144)]:
        s = gemm_splits(K, N)
        assert s in (1, 2, 4, 8)
        assert -(-N // 64) * s >= 132, (K, N, s)
        assert s == 1 or K // s >= 256
    assert gemm_splits(64, 96) == 1  # short K is never split below 256


@pytest.mark.parametrize("d", [16, 20, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_attention_smem_fits_a_block(d, dtype):
    """Every head width the wrapper takes fits one H100 block's 227 KB; at
    d = 256 the bf16 kernel keeps two blocks on an SM."""
    assert 0 < dense_smem_bytes(d, dtype) <= 227 * 1024
    assert 2 * dense_smem_bytes(256, torch.bfloat16) <= 227 * 1024


def test_block_gemm_bf16_f32_store_matches_jax():
    """bf16 inputs with the LM head's f32 store: one cast from the f32
    accumulator, so the plain versions agree to f32 rounding."""
    rng = np.random.RandomState(0)
    a = rng.randn(4, 64).astype(np.float32)
    b = rng.randn(64, 40).astype(np.float32)
    want = jref.block_gemm_ref(jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16), jnp.float32)
    got = block_gemm(t(a).bfloat16(), t(b).bfloat16(), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    close(got, want, atol=1e-4)  # 64 bf16 products of O(1): f32 sums agree


def test_cgra_gemm_flattens_leading_dims():
    rng = np.random.RandomState(1)
    a = rng.randn(2, 3, 16).astype(np.float32)
    b = rng.randn(16, 8).astype(np.float32)
    got = cgra_gemm(t(a), t(b))
    assert got.shape == (2, 3, 8)
    close(got, np.einsum("bsk,kn->bsn", a, b))


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused — the
    wrappers never fall back to the plain version."""
    a = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError):
        block_gemm(a, a)
    a8 = torch.empty(4, 4, dtype=torch.int8, device="meta")
    sc = torch.empty(4, 1, device="meta")
    with pytest.raises(ValueError):
        block_gemm_int8(a8, a8, sc, sc.T)
    with pytest.raises(ValueError):
        t_flash_attention(torch.empty(1, 2, 3, 8, device="meta"),
                          torch.empty(1, 1, 3, 8, device="meta"),
                          torch.empty(1, 1, 3, 8, device="meta"))
    with pytest.raises(ValueError):
        t_flash_decode(torch.empty(2, 4, 8, device="meta"),
                       torch.empty(2, 5, 2, 8, device="meta"),
                       torch.empty(2, 5, 2, 8, device="meta"),
                       torch.zeros(2, dtype=torch.int32), None)
    q = torch.empty(2, 4, 8, device="meta")
    pool = torch.empty(3, 8, 2, 8, device="meta")
    rows = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        flash_decode_paged(q, pool, pool, rows, rows, torch.empty(2, 1, dtype=torch.int32,
                                                                  device="meta"))
    with pytest.raises(ValueError):
        flash_attention_paged(torch.empty(2, 4, 3, 8, device="meta"), pool, pool,
                              torch.empty(2, 1, dtype=torch.int32, device="meta"),
                              rows, rows)
    # the row quantizer refuses, on every device, what its kernel cannot take
    with pytest.raises(ValueError):
        quantize_rows(torch.empty(4, 8, device="meta"))
    with pytest.raises(ValueError):
        quantize_rows(torch.zeros(8, 4).T)  # not contiguous
    with pytest.raises(ValueError):
        quantize_rows(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError):
        quantize_rows(torch.zeros(4, 8, dtype=torch.float16))


def test_block_gemm_bf16_trans_b_matches_jax():
    """The tied head's [N, K] operand: the same product as the [K, N] one."""
    rng = np.random.RandomState(10)
    a = rng.randn(3, 48).astype(np.float32)
    e = rng.randn(70, 48).astype(np.float32)  # [Vp, D] embedding table
    want = jref.block_gemm_ref(jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(e, jnp.bfloat16).T, jnp.float32)
    got = block_gemm(t(a).bfloat16(), t(e).bfloat16(), out_dtype=torch.float32,
                     trans_b=True)
    close(got, want)
    assert cgra_gemm(t(a)[None].bfloat16(), t(e).bfloat16(), torch.float32,
                     trans_b=True).shape == (1, 3, 70)


# ---------------------------------------------------------------------------
# int8 block GEMM and quantization
# ---------------------------------------------------------------------------

def _int8(rng, *shape, lim=127):
    return rng.randint(-lim, lim + 1, shape).astype(np.int8)


@pytest.mark.parametrize("M,K,N", [(2, 64, 96), (1, 100, 50), (37, 130, 77),
                                   (70, 256, 33)])
def test_block_gemm_int8_unit_scales_exact(M, K, N):
    """Unit scales: the output is the exact integer product, equal to the
    JAX oracle's and the interpret-mode Pallas kernel's bit for bit."""
    rng = np.random.RandomState(M * K + N)
    a, b = _int8(rng, M, K), _int8(rng, K, N)
    ones_m, ones_n = np.ones((M, 1), np.float32), np.ones((1, N), np.float32)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    got = block_gemm_int8(t(a), t(np.ascontiguousarray(b.T)), t(ones_m), t(ones_n))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    for want in (jref.block_gemm_int8_ref(*map(jnp.asarray, (a, b, ones_m, ones_n))),
                 j_block_gemm_int8(*map(jnp.asarray, (a, b, ones_m, ones_n)),
                                   interpret=True)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_block_gemm_int8_scaled_matches_jax(out_dtype):
    """Per-row x per-column scales, ragged M, K, N: 1e-6 relative to the
    JAX oracle and the interpret-mode kernel (the epilogue's f32 products
    are the same; only the final bf16 cast may round differently by one
    ulp when the XLA and PyTorch casts disagree, which they do not)."""
    rng = np.random.RandomState(11)
    M, K, N = 19, 150, 45
    a, b = _int8(rng, M, K), _int8(rng, K, N)
    sa = (rng.rand(M, 1) * 0.02 + 1e-3).astype(np.float32)
    sb = (rng.rand(1, N) * 0.02 + 1e-3).astype(np.float32)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    got = block_gemm_int8(t(a), t(np.ascontiguousarray(b.T)), t(sa), t(sb), out_dtype)
    assert got.dtype == out_dtype
    for want in (jref.block_gemm_int8_ref(*map(jnp.asarray, (a, b, sa, sb)), jdt),
                 j_block_gemm_int8(*map(jnp.asarray, (a, b, sa, sb)), out_dtype=jdt,
                                   interpret=True)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("axis", [-1, 0, None])
def test_quantize_bit_identical_to_jax(axis):
    """int8 values and f32 scales equal JAX's exactly, rounding ties to
    even included (the input holds exact .5 multiples of its scale)."""
    rng = np.random.RandomState(12)
    x = rng.randn(9, 33).astype(np.float32)
    x[0, :5] = [127.0, 0.5, 1.5, -2.5, 3.5]  # amax 127 -> scale 1: ties
    jq, tq = jquant.quantize(jnp.asarray(x), axis), tquant.quantize(t(x), axis)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tquant.dequantize(tq).numpy(),
                                  np.asarray(jquant.dequantize(jq)))


@pytest.mark.parametrize("M", [1, 2, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_bit_identical_to_jax(M, dtype):
    """The row quantizer's plain path (its CPU path) gives JAX's int8 values
    and f32 scales of ``quantize(x, axis=0)`` exactly, f32 and bf16 inputs:
    half-way ties round to even, an all-zero row and a row whose amax is
    under 1e-8 take the 1e-8 floor."""
    rng = np.random.RandomState(20 + M)
    x = rng.randn(M, 48).astype(np.float32)
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, -1.5, 126.5]  # amax 127 -> scale 1: ties
    x[0, 6:] = 0.0
    if M > 1:
        x[1] = 0.0  # all-zero row
    if M > 2:
        x[2] = 3e-9
        x[2, 7] = -7e-9  # amax < 1e-8
    xt = t(x).to(dtype)
    q, scale = quantize_rows(xt)
    jq = jquant.quantize(jnp.asarray(xt.float().numpy()), 0)  # the same values
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jq.scale))
    assert q.dtype == torch.int8 and scale.shape == (M, 1) and scale.dtype == torch.float32
    assert q[0, :6].tolist() == [127, 2, -4, 0, -2, 126]
    tq = tquant.quantize(xt, 0)  # the eager quantizer agrees too
    assert torch.equal(tq.q, q) and torch.equal(tq.scale, scale)


def test_w8a8_gemm_quantizes_through_quantize_rows(monkeypatch):
    """``cgra_gemm_w8a8`` takes its activation's int8 rows from the row
    quantizer, once per call, on the flattened [M, K] activation."""
    from repro_torch.core import gemm as tgemm
    seen = []

    def spy(x):
        seen.append(tuple(x.shape))
        return quantize_rows(x)
    monkeypatch.setattr(tgemm, "quantize_rows", spy)
    rng = np.random.RandomState(21)
    w = tquant.quantize(t(rng.randn(16, 40).astype(np.float32)), 0)  # [N, K], a scale a row
    packed = tquant.QTensor(w.q, w.scale.reshape(1, -1))
    out = cgra_gemm_w8a8(t(rng.randn(2, 3, 40).astype(np.float32)), packed)
    assert seen == [(6, 40)] and out.shape == (2, 3, 16)


def test_int8_splits_and_routes():
    """The int8 kernel's split of K is a plain function of (K, N) within one
    portable cluster (8 blocks) that gives every SM a block at the edge
    path's decode shapes; the route sends decode rows to the 16-row
    mma.sync tiles, the engine's chunks to the 64-row ones and the
    whole-prompt prefill (and any M whose 128 x 128 tiles fill the card) to
    wgmma, which needs K % 16 == 0."""
    assert list(inspect.signature(int8_splits).parameters) == ["K", "N"]
    for K, N in [(2560, 2048), (2560, 1024), (2048, 2560), (2560, 10240), (10240, 2560),
                 (2560, 262144), (2048, 2048), (8192, 2048), (2048, 50432)]:
        s = int8_splits(K, N)
        assert s in (1, 2, 4, 8)
        assert s == 8 or -(-N // 128) * s >= 132, (K, N, s)
        assert s == 1 or K // s >= 256
    assert int8_splits(64, 96) == 1
    assert [int8_route(M, 2560) for M in (1, 2, 16)] == [0, 0, 0]
    assert [int8_route(M, 2560) for M in (17, 64, 72)] == [1, 1, 1]
    assert int8_route(3072, 2048) == 2  # 128 x 128: 3 waves of 384 tiles
    assert [int8_route(3072, n) for n in (1024, 2560, 10240)] == [3, 3, 3]
    assert int8_route(3072, 2560, tma_ok=False) == 1


def test_quantized_matmul_and_w8a8_gemm_match_jax():
    rng = np.random.RandomState(13)
    x = rng.randn(2, 5, 40).astype(np.float32)
    w = rng.randn(40, 24).astype(np.float32)
    x2 = x.reshape(10, 40)  # per-row activation scales, per-column weight scales
    jx, jw = jquant.quantize(jnp.asarray(x2), 0), jquant.quantize(jnp.asarray(w), -1)
    tx, tw = tquant.quantize(t(x2), 0), tquant.quantize(t(w), -1)
    close(tquant.quantized_matmul_ref(tx, tw), jquant.quantized_matmul_ref(jx, jw))
    # cgra_gemm_w8a8: per-row activations against per-column weight scales
    from repro.core.gemm import cgra_gemm_w8a8 as j_w8a8
    jwq = jquant.quantize(jnp.asarray(w), -1)
    packed = tquant.QTensor(t(np.ascontiguousarray(np.asarray(jwq.q).T)),
                            t(np.array(jwq.scale)))
    got = cgra_gemm_w8a8(t(x), packed)
    assert got.shape == (2, 5, 24)
    close(got, j_w8a8(jnp.asarray(x), jwq))


# ---------------------------------------------------------------------------
# dense flash attention
# ---------------------------------------------------------------------------

DENSE_CASES = [  # B, H, K, Sq, Sk, d, causal, window, softcap
    (2, 4, 2, 24, 24, 16, True, 0, 0.0),      # causal prefill, GQA G=2
    (1, 4, 1, 19, 19, 16, True, 0, 0.0),      # MQA, ragged length
    (2, 2, 2, 16, 40, 16, True, 0, 0.0),      # Sq < Sk: suffix over a past
    (1, 4, 2, 37, 37, 32, True, 12, 0.0),     # sliding window
    (1, 4, 2, 20, 20, 16, True, 0, 9.0),      # softcap
    (2, 2, 1, 13, 29, 16, False, 0, 0.0),     # bidirectional, ragged
    (1, 2, 2, 33, 70, 16, False, 10, 5.0),    # bidirectional window + softcap
    (1, 4, 2, 50, 30, 16, True, 0, 0.0),      # Sq > Sk: 20 all-masked rows
    # the card kernel's tile edges (64-row query and key tiles, 32-row key
    # tiles at d > 128): lengths one past a tile, G = H/K in {1, 2, 8}, a
    # window crossing a 64-row tile, and Sq > Sk
    (1, 4, 4, 65, 65, 64, True, 0, 0.0),      # d=64, G=1, one row past a tile
    (1, 4, 2, 129, 129, 128, True, 0, 0.0),   # d=128, G=2, one past two tiles
    (1, 8, 1, 65, 129, 16, True, 0, 0.0),     # G=8, Sq < Sk
    (1, 8, 1, 130, 130, 32, True, 70, 0.0),   # G=8, window 70 across tiles
    (1, 2, 1, 129, 65, 64, True, 0, 0.0),     # Sq > Sk: 64 all-masked rows
    (1, 4, 2, 100, 129, 128, False, 33, 0.0), # bidirectional window across tiles
    # the audio encoder and the VLM's cross-attention: bidirectional at
    # hubert's head dim 80 (no power of two) over a ragged length, and one
    # query row over the image's keys (cross-attention at decode), G = 4
    (2, 4, 4, 37, 37, 80, False, 0, 0.0),     # bidirectional, d=80, G=1
    (2, 8, 2, 1, 24, 16, False, 0, 0.0),      # Sq = 1 vs Sk = 24, G=4
]


@pytest.mark.parametrize("case", DENSE_CASES, ids=[f"c{i}" for i in range(len(DENSE_CASES))])
def test_dense_attention_plain_matches_jax(case):
    """The plain version == the JAX oracle (kv heads broadcast) == the
    interpret-mode Pallas kernel; rows with every key masked are exact 0."""
    B, H, K, Sq, Sk, d, causal, window, softcap = case
    rng = np.random.RandomState(Sq * 7 + Sk)
    q = rng.randn(B, H, Sq, d).astype(np.float32)
    k = rng.randn(B, K, Sk, d).astype(np.float32)
    v = rng.randn(B, K, Sk, d).astype(np.float32)
    got = attention(t(q), t(k), t(v), causal=causal, window=window, softcap=softcap)
    assert got.shape == (B, H, Sq, d)
    G = H // K
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, 1),
                                    jnp.repeat(jnp.asarray(v), G, 1), causal=causal,
                                    window=window, softcap=softcap)
    close(got, want)
    pallas = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, softcap=softcap,
                             bq=16, bk=16, interpret=True)
    close(got, pallas)
    if Sq > Sk and causal:
        assert torch.count_nonzero(got[:, :, : Sq - Sk]) == 0


def test_dense_attention_reads_transposed_views():
    """The layers hand over [B,S,H,d] tensors transposed to [B,H,S,d]
    without a copy; the result is the same as for contiguous inputs."""
    rng = np.random.RandomState(14)
    q = t(rng.randn(2, 12, 4, 16).astype(np.float32))
    k = t(rng.randn(2, 12, 2, 16).astype(np.float32))
    got = t_flash_attention(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2),
                            window=5)
    want = t_flash_attention(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(), window=5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# flash-decode on slot caches: linear and ring layouts
# ---------------------------------------------------------------------------

def _slot(seed, B=5, H=4, K=2, S=24, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, d).astype(np.float32),
            rng.randn(B, S, K, d).astype(np.float32),
            rng.randn(B, S, K, d).astype(np.float32))


@pytest.mark.parametrize("layout", ["linear", "ring"])
@pytest.mark.parametrize("softcap", [0.0, 12.0])
def test_slot_decode_plain_matches_jax(layout, softcap):
    """Both layouts against the JAX oracle and the interpret-mode Pallas
    kernel.  Slots: pos < S, a ring wrapped twice (pos 57 over S 24), pos
    == S (a frozen full slot: rows [0, S-1] live), a windowed start, and
    start > pos (exact zeros)."""
    q, k, v = _slot(15)
    S = k.shape[1]
    pos = np.array([5, 57, S, 30, 3], np.int32)
    start = np.array([0, 0, 0, 20, 4], np.int32)
    got = attend_decode(t(q), t(k), t(v), t(pos), t(start), layout=layout,
                        softcap=softcap)
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), jnp.asarray(start), layout=layout,
                                 softcap=softcap)
    close(got, want)
    pallas = flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pos), jnp.asarray(start), layout=layout,
                          softcap=softcap, bk=8, interpret=True)
    close(got, pallas)
    assert torch.count_nonzero(got[4]) == 0  # start > pos: exact zeros


@pytest.mark.parametrize("layout", ["linear", "ring"])
def test_slot_decode_long_cache_matches_jax(layout):
    """S = 4096 rows (64 of the card kernel's 64-row blocks a slot) and B =
    8 slots: full, frozen, wrapped twice, windowed and drained (start >
    pos, exact zeros) -- the plain version against the JAX oracle."""
    q, k, v = _slot(17, B=8, H=4, K=2, S=4096, d=16)
    pos = np.array([4095, 4096, 100, 3000, 64, 0, 9000, 10], np.int32)
    start = np.array([0, 0, 0, 2900, 65, 0, 8000, 0], np.int32)
    got = attend_decode(t(q), t(k), t(v), t(pos), t(start), layout=layout)
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), jnp.asarray(start), layout=layout)
    close(got, want)
    assert torch.count_nonzero(got[4]) == 0  # start > pos: exact zeros


def test_ring_decode_before_the_ring_fills():
    """pos < S on a ring: entries j > pos hold rows pos - (pos - j) mod S
    < 0 — never written, never live (scalar pos and start=None)."""
    q, k, v = _slot(16, B=2)
    got = t_flash_decode(t(q), t(k), t(v), 6, None, layout="ring")
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 6,
                                 layout="ring")
    close(got, want)
    lin = t_flash_decode(t(q), t(k), t(v), 6, None, layout="linear")
    close(got, lin)  # before wrapping, ring == linear


# ---------------------------------------------------------------------------
# paged chunk-prefill attention
# ---------------------------------------------------------------------------

def _rand_paged(seed, B=2, H=4, K=2, C=16, ps=16, npp=3, d=16,
                q_start=(19, 0), n=(16, 16)):
    rng = np.random.RandomState(seed)
    P = 1 + B * npp
    q = rng.randn(B, H, C, d).astype(np.float32)
    kp = rng.randn(P, ps, K, d).astype(np.float32)
    vp = rng.randn(P, ps, K, d).astype(np.float32)
    pages = np.zeros((B, npp), np.int32)
    for b in range(B):
        pages[b] = 1 + b * npp + rng.permutation(npp)
    qs = np.array(q_start[:B], np.int32)
    return q, kp, vp, pages, qs, qs + np.array(n[:B], np.int32)


# (K, window, softcap) at the default shapes, ids as "K-window-softcap"; then
# the card kernel's edges: page sizes 8 and 128 (key tiles spanning pages,
# or half of one), G = 8, a window crossing pages, d = 256, a chunk that
# starts mid-page
PREFILL_CASES = [dict(K=K, window=w, softcap=c) for K in (2, 4)
                 for w, c in ((0, 0.0), (20, 0.0), (0, 15.0), (12, 9.0))]
PREFILL_IDS = [f"{c['K']}-{c['window']}-{c['softcap']}" for c in PREFILL_CASES]
PREFILL_CASES += [
    dict(ps=8, npp=6, q_start=(19, 5), n=(16, 11)),
    dict(ps=128, npp=2, q_start=(150, 3), n=(16, 16), window=40),
    dict(H=8, K=1, ps=16, npp=4, q_start=(37, 0), n=(16, 9)),
    dict(ps=8, npp=8, q_start=(41, 22), n=(16, 16), window=12, softcap=9.0),
    dict(H=2, K=1, d=256, ps=8, npp=5, q_start=(21, 0), n=(16, 16), window=20),
]
PREFILL_IDS += ["ps8", "ps128-window", "G8", "ps8-window-across-pages", "d256"]


@pytest.mark.parametrize("case", PREFILL_CASES, ids=PREFILL_IDS)
def test_paged_prefill_plain_matches_jax(case):
    """The plain version == the JAX oracle == the interpret-mode Pallas
    kernel, with ``q_start > 0`` on slot 0."""
    case = dict(case)
    window, softcap = case.pop("window", 0), case.pop("softcap", 0.0)
    q, kp, vp, pages, qs, kl = _rand_paged(3, **case)
    got = attention(t(q), t(kp), t(vp), window=window, softcap=softcap,
                    pages=t(pages), q_start=t(qs), k_len=t(kl))
    want = jref.flash_attention_paged_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages),
        jnp.asarray(qs), jnp.asarray(kl), window=window, softcap=softcap)
    close(got, want)
    pallas = flash_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             pages=jnp.asarray(pages), q_start=jnp.asarray(qs),
                             k_len=jnp.asarray(kl), window=window,
                             softcap=softcap, interpret=True)
    close(got, pallas)


def test_paged_prefill_reads_transposed_views():
    """The layers hand q over as a [B,H,C,d] view of their [B,C,H,d]
    tensor; the result has q's shape and equals the contiguous call."""
    q, kp, vp, pages, qs, kl = _rand_paged(21, ps=8, npp=6, q_start=(19, 5), n=(16, 11))
    args = (t(kp), t(vp), t(pages), t(qs), t(kl))
    view = t(q).transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    got = flash_attention_paged(view, *args, window=9)
    assert got.shape == q.shape
    torch.testing.assert_close(got, flash_attention_paged(t(q), *args, window=9),
                               rtol=0, atol=0)


def test_paged_splits_depend_on_the_slot_rows_only():
    """The bf16 chunk kernel splits a slot's keys into 128-row pieces: a
    function of the table's shape alone, never of the batch, the heads or
    the grid, so a slot's sums are the same alone and in a batch.  Both
    paged kernels' scratch is a per-slot share times the slots."""
    assert list(inspect.signature(key_pieces).parameters) == ["npp", "ps"]
    for npp, ps in ((16, 64), (128, 8), (8, 128), (64, 16), (3, 8)):
        assert key_pieces(npp, ps) == -(-npp * ps // 128)
    assert paged_scratch(4, 16, 64, 128, 2, 64) == (0, 0)  # one piece: no split
    for H, C, d, npp, ps in ((16, 64, 128, 16, 64), (8, 100, 256, 32, 64)):
        one = paged_scratch(1, H, C, d, npp, ps)
        assert one == (H * -(-C // 64) * key_pieces(npp, ps) * 64 * (d + 2),
                       H * -(-C // 64))
        for B in (2, 8):
            assert paged_scratch(B, H, C, d, npp, ps) == (B * one[0], B * one[1])
    for H, K, S, dv in ((16, 16, 1024, 128), (64, 8, 1024, 128), (8, 4, 1600, 256)):
        one = decode_scratch(1, H, K, S, dv)
        assert one == (K * -(-S // 64) * (H // K) * (dv + 2), K)
        assert decode_scratch(8, H, K, S, dv) == (8 * one[0], 8 * one[1])


def test_paged_prefill_partial_chunk_and_shared_kv():
    """k is v and the chunk holds fewer valid rows than its buffer: the
    valid rows match; a row with no valid key (k_len = 0) gives zeros."""
    q, kp, _, pages, qs, _ = _rand_paged(4, B=2, K=1, H=2, q_start=(5, 0))
    kl = qs + np.array([11, 0], np.int32)
    kpt = t(kp)
    got = flash_attention_paged(t(q), kpt, kpt, t(pages), t(qs), t(kl))
    jk = jnp.asarray(kp)
    want = jref.flash_attention_paged_ref(jnp.asarray(q), jk, jk,
                                          jnp.asarray(pages), jnp.asarray(qs),
                                          jnp.asarray(kl))
    close(got[0, :, :11], np.asarray(want)[0, :, :11])
    assert torch.count_nonzero(got[1]) == 0  # slot 1: nothing to attend


# ---------------------------------------------------------------------------
# paged flash-decode
# ---------------------------------------------------------------------------

def _rand_decode(seed, B=5, H=4, K=2, ps=8, npp=4, d=16, pos=None, start=None):
    rng = np.random.RandomState(seed)
    P = 1 + B * npp
    q = rng.randn(B, H, d).astype(np.float32)
    kp = rng.randn(P, ps, K, d).astype(np.float32)
    vp = rng.randn(P, ps, K, d).astype(np.float32)
    pages = (1 + rng.permutation(P - 1)[: B * npp]).reshape(B, npp).astype(np.int32)
    # empty slot (start > pos), mid-page, page boundary, pos at capacity
    # (npp * ps: a frozen full slot), and a window-style start
    pos = np.array(pos or [2, 13, 16, npp * ps, 30], np.int32)[:B]
    start = np.array(start or [3, 0, 0, 0, 9], np.int32)[:B]
    return q, kp, vp, pages, pos, start


# (K, softcap) at the default shapes, ids as "K-softcap"; then the card
# kernel's edges: page sizes 16 and 128 (a 64-row block spans 4 pages or
# half of one), G = 8, window-style starts mid-page, and MLA-style dv
# narrowing with one pool as k and v at d = 256; slot 0 is always empty
# (start > pos) and one slot frozen full (pos == npp * ps)
DECODE_CASES = [dict(K=K, softcap=c) for K in (1, 2, 4) for c in (0.0, 20.0)]
DECODE_IDS = [f"{c['K']}-{c['softcap']}" for c in DECODE_CASES]
DECODE_CASES += [
    dict(ps=16, npp=5, pos=[2, 70, 16, 80, 33], start=[3, 0, 16, 0, 9]),
    dict(ps=128, npp=2, pos=[2, 200, 127, 256, 130], start=[3, 0, 0, 0, 100]),
    dict(H=8, K=1, ps=8, npp=6, softcap=20.0),
    dict(ps=8, npp=8, pos=[2, 60, 63, 64, 45], start=[3, 37, 33, 1, 22]),
    dict(H=4, K=1, d=256, ps=8, npp=5, dv=128, shared=True,
         pos=[1, 39, 40, 17, 24], start=[2, 0, 3, 9, 24]),
]
DECODE_IDS += ["ps16", "ps128", "G8", "window-starts-mid-page", "d256-shared-kv-dv128"]


@pytest.mark.parametrize("case", DECODE_CASES, ids=DECODE_IDS)
def test_paged_decode_plain_matches_jax(case):
    case = dict(case)
    softcap, dv, shared = case.pop("softcap", 0.0), case.pop("dv", None), case.pop("shared", False)
    q, kp, vp, pages, pos, start = _rand_decode(5, **case)
    tk, jk = t(kp), jnp.asarray(kp)
    tv, jv = (tk, jk) if shared else (t(vp), jnp.asarray(vp))  # v is k: one pool
    got = attend_decode(t(q), tk, tv, t(pos), t(start), pages=t(pages),
                        softcap=softcap, dv=dv)
    want = jref.flash_decode_ref(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                 jnp.asarray(start), pages=jnp.asarray(pages),
                                 softcap=softcap, dv=dv)
    close(got, want)
    pallas = flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(pos), jnp.asarray(start),
                          pages=jnp.asarray(pages), softcap=softcap, dv=dv,
                          interpret=True)
    close(got, pallas)
    assert torch.count_nonzero(got[0]) == 0  # empty slot: exact zeros


def test_paged_decode_dv_narrowing_shared_kv():
    """MLA-style: one pool as both k and v, values narrowed to dv."""
    q, kp, _, pages, pos, start = _rand_decode(6, K=1)
    kpt, jk = t(kp), jnp.asarray(kp)
    got = flash_decode_paged(t(q), kpt, kpt, t(pos), t(start), t(pages),
                             scale=0.13, dv=8)
    want = jref.flash_decode_ref(jnp.asarray(q), jk, jk, jnp.asarray(pos),
                                 jnp.asarray(start), pages=jnp.asarray(pages),
                                 scale=0.13, dv=8)
    assert got.shape == (5, 4, 8)
    close(got, want)
    pallas = flash_decode(jnp.asarray(q), jk, jk, jnp.asarray(pos),
                          jnp.asarray(start), pages=jnp.asarray(pages),
                          scale=0.13, dv=8, interpret=True)
    close(got, pallas)


def test_linear_decode_plain_matches_jax():
    rng = np.random.RandomState(7)
    q = rng.randn(3, 4, 16).astype(np.float32)
    k = rng.randn(3, 20, 2, 16).astype(np.float32)
    v = rng.randn(3, 20, 2, 16).astype(np.float32)
    pos, start = np.array([5, 19, 0], np.int32), np.array([0, 4, 1], np.int32)
    got = tref.flash_decode_ref(t(q), t(k), t(v), t(pos), t(start))
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), jnp.asarray(start))
    close(got, want)


# ---------------------------------------------------------------------------
# page-table scatters: drop, never clamp
# ---------------------------------------------------------------------------

def _pools(P, ps, K, d):
    """A port pool (with its drop row) and the same zeros for JAX."""
    spec = ParamSpec((1, P, ps, K, d), (None,) * 5, "zeros")
    return _pool(spec, torch.float32, "cpu")[0], jnp.zeros((P, ps, K, d))


def test_page_row_write_matches_jax_drop():
    rng = np.random.RandomState(8)
    P, ps, K, d, npp = 6, 4, 2, 3, 2
    pages = np.array([[1, 2], [3, 4], [0, 0]], np.int32)
    pos = np.array([5, npp * ps, 0], np.int32)  # slot 1 falls off its table
    row = rng.randn(3, K, d).astype(np.float32)
    tp, jp = _pools(P, ps, K, d)
    TL._write_rows(tp, t(row), TL._row_index(P, ps, t(pages), t(pos)[:, None]))
    want = JL._page_row_write(jp, jnp.asarray(row), jnp.asarray(pages),
                              jnp.asarray(pos))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want))


def test_page_rows_write_matches_jax_drop():
    rng = np.random.RandomState(9)
    P, ps, K, d, npp, C = 7, 4, 2, 3, 3, 6
    pages = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pos0 = np.array([3, 9], np.int32)   # slot 1 runs off its table
    n = np.array([4, 6], np.int32)      # slot 0's rows 4, 5 are padding
    rows = rng.randn(2, C, K, d).astype(np.float32)
    tp, jp = _pools(P, ps, K, d)
    positions = t(pos0)[:, None] + torch.arange(C, dtype=torch.int32)[None]
    TL._write_rows(tp, t(rows).reshape(2 * C, K, d),
                   TL._row_index(P, ps, t(pages), positions, t(n)))
    want = JL._page_rows_write(jp, jnp.asarray(rows), jnp.asarray(pages),
                               jnp.asarray(pos0), jnp.asarray(n))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want))


def test_pool_without_drop_row_is_refused():
    pool = torch.zeros(3, 4, 1, 2)
    with pytest.raises(ValueError, match="drop row"):
        TL._write_rows(pool, torch.ones(1, 1, 2), torch.tensor([0]))
