"""The pieces of w8a8 and Mamba-2 SSD on a model axis, without a process
group: the int8 GEMM's int32-partial and epilogue entries, the row max and
the quantize with a given max (their plain versions, which the CUDA entries
are held to on the card), the slicing of packed int8 weights, and the
row-parallel int8 GEMM and the head-parallel gated norm run by two threads
that exchange their partials through :class:`ThreadMesh` (the collectives
of ``launch.mesh.Mesh`` that these paths call).  Shapes: reduced cgra-edge
(4 heads of 16, ffn 128) over a model axis of 2; reduced mamba2-130m's 8
SSD heads of 16 in two halves."""
import threading

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.core.gemm import cgra_gemm_w8a8, cgra_gemm_w8a8_row
from repro_torch.core.quant import quantize_over
from repro_torch.kernels import ref
from repro_torch.kernels.block_gemm import block_gemm_int8_acc, int8_epilogue
from repro_torch.kernels.quantize import quantize_rows, quantize_rows_given, row_amax
from repro_torch.launch.sharding import activation_mesh
from repro_torch.models import model as TM
from repro_torch.models import ssd


def _int8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int32_partials_sum_to_the_fused_product(out_dtype):
    """Two K halves' raw int32 sums, added as int32 and put through the
    epilogue, equal the fused product bit for bit, at K = 4096 with full-
    range operands: the accumulators pass 2^24, where an f32 sum of the
    partials would no longer be exact."""
    rng = np.random.default_rng(0)
    M, K, N = 24, 4096, 48
    assert K > 2 ** 24 / 127 ** 2
    a, b = _int8(rng, M, K), _int8(rng, N, K)
    a[0], b[0] = 127, 127  # one accumulator at K * 127^2
    sa = torch.from_numpy(rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32))
    sb = torch.from_numpy(rng.uniform(1e-3, 1e-2, (1, N)).astype(np.float32))
    h = K // 2
    acc = (block_gemm_int8_acc(a[:, :h].contiguous(), b[:, :h].contiguous())
           + block_gemm_int8_acc(a[:, h:].contiguous(), b[:, h:].contiguous()))
    assert acc.dtype == torch.int32 and int(acc.abs().max()) > 2 ** 24
    assert torch.equal(acc, ref.block_gemm_int8_acc_ref(a, b))
    got = int8_epilogue(acc, sa, sb, out_dtype)
    want = ref.block_gemm_int8_ref(a, b, sa, sb, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_amax_then_given_quantize_equals_quantize_rows(dtype):
    """The row max followed by the quantize with that max is
    ``quantize_rows`` bit for bit, with zero, sub-1e-8 and exact-tie rows;
    and each column half quantized with the whole row's max is that half of
    the whole row's int8 values, with the whole row's scale."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32)).to(dtype)
    x[0] = 0.0
    x[1] = 3e-9
    x[2, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, -1.5, 126.5])
    q, s = quantize_rows_given(x, row_amax(x))
    qr, sr = ref.quantize_rows_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert q[2, :6].tolist() == [127, 2, -4, 0, -2, 126]
    halves = [x[:, :32].contiguous(), x[:, 32:].contiguous()]
    amax = torch.maximum(*(row_amax(h) for h in halves))
    parts = [quantize_rows_given(h, amax) for h in halves]
    assert torch.equal(torch.cat([p[0] for p in parts], 1), quantize_rows(x)[0])
    assert all(torch.equal(p[1], sr) for p in parts)


class _FakeMesh:
    """Rank ``i`` of a 1 x ``tp`` mesh, enough for the sharding rules."""

    def __init__(self, tp: int, i: int):
        self.shape = {"data": 1, "model": tp}
        self.i = i

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.i if axis == "model" else 0


def test_shard_params_slices_int8_leaves_after_quantizing():
    """Reduced cgra-edge at a model axis of 2: each rank's ``wq`` (a column
    split over heads) holds its columns of the whole weight's int8 values
    and their scales; ``wo`` and ``w_down`` (row splits) hold their slice of
    K and the whole scales; the untied head its vocab columns, reduced
    gemma3-4b's tied ``lm_head_q`` its vocab rows.  Quantizing a row
    split's slice alone gives other scales."""
    cfg = TC.reduce_config(TC.get_config("cgra-edge"))
    qp = TM.quantize_params(cfg, TM.init(cfg, seed=0, device="cpu"))
    lay = lambda p: p["stages"][0]["0"]
    whole = lay(qp)
    H, dh, D = cfg.padded_heads, cfg.head_dim, cfg.d_model
    for i in range(2):
        mine = TM.shard_params(cfg, qp, _FakeMesh(2, i))
        wq, wo = lay(mine)["mixer"]["wq"], lay(mine)["mixer"]["wo"]
        cols = slice(i * H * dh // 2, (i + 1) * H * dh // 2)
        assert torch.equal(wq.q, whole["mixer"]["wq"].q[:, cols])
        assert torch.equal(wq.scale, whole["mixer"]["wq"].scale[:, :, cols])
        assert torch.equal(wo.q, whole["mixer"]["wo"].q[:, :, cols])
        assert torch.equal(wo.scale, whole["mixer"]["wo"].scale)
        F = cfg.d_ff
        wd = lay(mine)["ffn"]["w_down"]
        assert torch.equal(wd.q, whole["ffn"]["w_down"].q[:, :, i * F // 2:(i + 1) * F // 2])
        assert torch.equal(wd.scale, whole["ffn"]["w_down"].scale)
        V = cfg.padded_vocab // 2
        assert torch.equal(mine["lm_head"].q, qp["lm_head"].q[i * V:(i + 1) * V])
        assert torch.equal(mine["lm_head"].scale, qp["lm_head"].scale[:, i * V:(i + 1) * V])
    # a tied head (reduced gemma3-4b): lm_head_q [Vp, D] by vocab rows
    gcfg = TC.reduce_config(TC.get_config("gemma3-4b"))
    gq = TM.quantize_params(gcfg, TM.init(gcfg, seed=0, device="cpu"))
    V = gcfg.padded_vocab // 2
    for i in range(2):
        mine = TM.shard_params(gcfg, gq, _FakeMesh(2, i))["lm_head_q"]
        assert torch.equal(mine.q, gq["lm_head_q"].q[i * V:(i + 1) * V])
        assert torch.equal(mine.scale, gq["lm_head_q"].scale[:, i * V:(i + 1) * V])
    # slice-then-quantize: wo's rows of rank 0 quantized alone
    wo_f = TM.init(cfg, seed=0, device="cpu")["stages"][0]["0"]["mixer"]["wo"]  # [R,H,dh,D]
    alone = quantize_over(wo_f[:, : H // 2], (1, 2))
    assert not torch.equal(alone.scale.reshape(-1), whole["mixer"]["wo"].scale.reshape(-1))


class ThreadMesh:
    """One rank of a 1 x n model axis whose ranks are threads of this
    process: each collective posts this rank's tensor, waits for the
    others and combines all of them in rank order -- the sums and maxima
    ``launch.mesh.Mesh`` computes over its model group."""

    def __init__(self, n: int, i: int, board: list, barrier: threading.Barrier):
        self.n, self.i, self.board, self.barrier = n, i, board, barrier
        self.shape = {"data": 1, "model": n}
        self.groups = {"model": None}

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.i if axis == "model" else 0

    def _all(self, x):
        self.board[self.i] = x
        self.barrier.wait()
        vals = list(self.board)
        self.barrier.wait()
        return vals

    def all_max(self, x, axes):
        return torch.stack(self._all(x)).amax(0)

    def all_sum_int(self, x, axis="model"):
        assert x.dtype == torch.int32
        vals = self._all(x)
        out = vals[0].clone()
        for v in vals[1:]:
            out += v
        return out

    def all_reduce(self, x, axis="model"):
        vals = [v.float() for v in self._all(x)]
        out = vals[0].clone()
        for v in vals[1:]:
            out += v
        return out.to(x.dtype)


def _threads(n: int, fn):
    """fn(mesh) on n thread-ranks; their results in rank order."""
    board, barrier = [None] * n, threading.Barrier(n)
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = fn(ThreadMesh(n, i, board, barrier))
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
            barrier.abort()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_row_parallel_w8a8_gemm_equals_the_single_device(out_dtype):
    """``cgra_gemm_w8a8_row`` on two ranks' K slices (the whole row's max,
    an exact int32 sum, the epilogue with the whole row's scale) equals
    ``cgra_gemm_w8a8`` of the whole row bit for bit, on every rank; the
    rows' maxima lie in different halves, so a local scale would differ."""
    rng = np.random.default_rng(2)
    M, K, N = 5, 2048, 40
    x = torch.from_numpy(rng.standard_normal((2, M, K)).astype(np.float32))
    x[0, 0, 3] = 40.0
    x[1, 2, K - 3] = -40.0
    wf = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    w = TM._pack(quantize_over(wf, (0,)), 0, 1)  # q [N, K], scale [1, N]
    want = cgra_gemm_w8a8(x, w, out_dtype)
    h = K // 2

    def rank(mesh):
        lo = mesh.i * h
        mine = type(w)(w.q[:, lo:lo + h].contiguous(), w.scale)
        return cgra_gemm_w8a8_row(x[..., lo:lo + h], mine, mesh, out_dtype=out_dtype)

    for got in _threads(2, rank):
        assert got.dtype == out_dtype and torch.equal(got, want)


def test_head_parallel_gated_norm_matches_the_whole():
    """The SSD layer's gated RMSNorm over (H, P) with the heads in two
    halves (each rank's f32 sum of squares joined over the model axis,
    divided by the whole H * P) equals the whole norm within 1e-6 in f32:
    reduced mamba2-130m's 8 heads of 16."""
    cfg = TC.reduce_config(TC.get_config("mamba2-130m"))
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    rng = np.random.default_rng(3)
    y, z = (torch.from_numpy(rng.standard_normal((2, 7, H, P)).astype(np.float32))
            for _ in range(2))
    norm = torch.from_numpy(rng.uniform(0.5, 1.5, (H, P)).astype(np.float32))
    want = ssd.gated_rms(y, z, norm, H)
    hl = H // 2

    def rank(mesh):
        sl = slice(mesh.i * hl, (mesh.i + 1) * hl)
        with activation_mesh(mesh):
            return ssd.gated_rms(y[:, :, sl], z[:, :, sl], norm[sl], H, mesh)

    got = torch.cat(_threads(2, rank), 2)
    assert float((got - want).abs().max()) <= 1e-6
