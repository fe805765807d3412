"""The port's plain kernel versions (``repro_torch.kernels.ref``, the CPU
path of every wrapper) against the JAX oracles (``repro.kernels.ref``) and
the JAX Pallas kernels in interpret mode, on the same numpy inputs.

Tolerance: f32, max abs <= 1e-5 — XLA and PyTorch sum in different orders,
so results differ by a few f32 ulps of O(1) values, never more.  The CUDA
kernels themselves run only on the card; ``chip_smoke.py`` holds them
against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode
from repro.kernels.flash_attention import flash_attention
from repro.models import layers as JL
from repro_torch.core.gemm import cgra_gemm
from repro_torch.kernels import ref as tref
from repro_torch.kernels.block_gemm import block_gemm
from repro_torch.kernels.decode_attention import flash_decode_paged
from repro_torch.kernels.flash_attention import flash_attention_paged
from repro_torch.kernels.ops import attend_decode, attention
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


@pytest.mark.parametrize("window,softcap",
                         [(0, 0.0), (20, 0.0), (0, 15.0), (12, 9.0)])
@pytest.mark.parametrize("K", [2, 4])  # GQA (G=2) and MHA
def test_paged_prefill_plain_matches_jax(window, softcap, K):
    """The plain version == the JAX oracle == the interpret-mode Pallas
    kernel, with ``q_start > 0`` on slot 0."""
    q, kp, vp, pages, qs, kl = _rand_paged(3, K=K)
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

def _rand_decode(seed, B=5, H=4, K=2, ps=8, npp=4, d=16):
    rng = np.random.RandomState(seed)
    P = 1 + B * npp
    q = rng.randn(B, H, d).astype(np.float32)
    kp = rng.randn(P, ps, K, d).astype(np.float32)
    vp = rng.randn(P, ps, K, d).astype(np.float32)
    pages = (1 + rng.permutation(P - 1)[: B * npp]).reshape(B, npp).astype(np.int32)
    # empty slot (start > pos), mid-page, page boundary, pos at capacity
    # (npp * ps: a frozen full slot), and a window-style start
    pos = np.array([2, 13, 16, npp * ps, 30], np.int32)[:B]
    start = np.array([3, 0, 0, 0, 9], np.int32)[:B]
    return q, kp, vp, pages, pos, start


@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("K", [1, 2, 4])  # MQA, GQA, MHA
def test_paged_decode_plain_matches_jax(softcap, K):
    q, kp, vp, pages, pos, start = _rand_decode(5, K=K)
    got = attend_decode(t(q), t(kp), t(vp), t(pos), t(start), pages=t(pages),
                        softcap=softcap)
    want = jref.flash_decode_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(pos), jnp.asarray(start),
                                 pages=jnp.asarray(pages), softcap=softcap)
    close(got, want)
    pallas = flash_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(pos), jnp.asarray(start),
                          pages=jnp.asarray(pages), softcap=softcap,
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
