// Block GEMM C[M,N] = A[M,K] @ B[K,N] (B may be stored [N,K], A [K,M]) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/block_gemm.py, _gemm_kernel (wrapper
// block_gemm) -- the output-stationary block accumulation every projection
// and the LM head run through, and the two products of its VJP
// (src/repro/kernels/ops.py, _mm_bwd: g @ B^T and A^T @ g).
//
// What bounds it on an H100: reading B.  At the serving shapes (M = 1-8
// decode rows, M <= 72 rows of a mixed tick) the weight matrix B is read once
// per call and dominates the bytes, while 2*M*K*N operations stay far below
// the card's operations-per-byte balance.  So the design is about keeping
// bytes of B in flight on all 132 SMs:
//   - each k-row of a B tile is a 128- or 256-byte piece of a B row (for B
//     stored [N, K], 64 k-values = 128 bytes of each row), copied as
//     16-byte cp.async chunks under an L2 evict-first policy (B is read once
//     a call; the policy keeps it from pushing reusable lines out of L2);
//   - a 64-deep k-tile moves through a ring: M <= 16 takes 16 x 128 tiles
//     with 4 stages (16 KB of B a stage) where K is split, 16 x 64 with 5
//     where it is not; M > 16 takes 64 x 64 tiles (four 32 x 32 warp tiles)
//     with 4 stages;
//   - where the column tiles alone cannot give every SM a block (N = 2048
//     gives 32), K is split S ways and the S blocks of one output tile form
//     a thread block cluster: each sums its K range, leaves the partial tile
//     in its shared memory, and after a cluster barrier every block adds a
//     slice of the tile from all S partials over distributed shared memory
//     and stores it.  One launch, no atomics, no scratch in device memory.
//   What holds it back: per-SM request depth and pipeline fill.  At the
// 2048 x 2048 projections (8 MB of B) launch and ramp take most of the
// ~13 us; at M = 64 each block also streams as many bytes of A (from L2) as
// of B.  Registers (ptxas -v, sm_90a): 48 (16 x 64), 72-122 (16 x 128),
// 126-128 (64 x 64), no spills; dynamic shared memory 57,600 / 78,848 /
// 73,728 bytes a block.
// S is chosen by the wrapper (block_gemm.gemm_splits) from (K, N) alone.
// The tensor cores run mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// ldmatrix fragments (.trans for B stored [K, N], and for A stored [K, M]).
// f32 inputs take a CUDA-core FMA kernel (full f32, never TF32); they are off
// the serving path.
//
// Training (the VJP, ops.cgra_matmul): the weight gradient A^T @ g reads the
// activation stored [T, K] as a transposed A (trans_a), so no transposed copy
// is made; its k-tile is kept m-contiguous, [BK][BM + 8], and the A fragment
// comes from ldmatrix .trans, as B's [K, N] tile does.  The fragments, and so
// the k16 steps and every result, are those of the same product with A stored
// [M, K].  At the training shapes (M = 2048-8192 rows of a weight over K =
// 4096 tokens) the product is bound by operations, and the 64 x 64 mma.sync
// tiles run far below the wgmma rate: 75-150 TFLOP/s of the H100's 989 in
// chip_smoke.py's training rows (ROADMAP Queue 2 items 9 and 14).
//
// Reduction order, bf16: split s covers k in [s*kc, min(K, (s+1)*kc)) with
// kc = ceil(K / S) rounded up to the 64-deep k-tile; inside a split each
// output is one f32 accumulator chain of k16 tensor-core steps in k order;
// the output is ((p_0 + p_1) + p_2) + ... + p_{S-1}, in split order.  S and
// kc depend on (K, N) only and never on M or the tiling, so every output row
// is the same f32 sum, bit for bit, for every M (a prompt served alone gives
// the same greedy tokens as in a batch).  f32: one fmaf chain over k.
// Ragged M/K/N edges are zero-filled on load (zeros leave the chain
// unchanged) and masked on store -- no padded copies.  The f32 sum is cast
// once in the epilogue (f32 straight out for the LM head).
#include <cooperative_groups.h>

#include "common.cuh"
#include "index.cuh"  // addresses and block decisions, as the bounds proofs read them

namespace repro {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int GEMM_BK = ix::BF16_BK;  // k-tile depth; kc is a multiple of it

// bf16 tensor-core kernel.  Block tile BM x BN, warp tile WM x WN (WM/16 x
// WN/8 mma tiles per warp), STAGES-deep cp.async ring in dynamic shared
// memory.  Grid: x = column tile * S + split, y = row tile; with S > 1 the S
// splits of a column tile are one cluster.  vecA/vecB: the operand's rows
// are 16-byte aligned (K resp. the row length of B a multiple of 8 and an
// aligned base), so tiles move as 16-byte cp.async chunks; otherwise element
// by element with the same zero fill.  BT: B is stored [N, K] (the tied LM
// head reads the [V, D] embedding table in place); its tile is kept
// k-contiguous.  AT: A is stored [K, M]; its tile is kept m-contiguous.  The
// k16 steps, and so every result, are the same.
template <int BM, int BN, int WM, int WN, int STAGES, bool AT, bool BT, typename TO>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, TO* __restrict__ C,
                 int M, int N, int K, int vecA, int vecB, int splits, int kc) {
  constexpr int BK = GEMM_BK;
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16, NTL = WN / 8;
  // padded rows: 16-byte aligned, the 8 rows of an ldmatrix in distinct banks;
  // A is [BM][AS] or, AT, [BK][AS]; B is [BK][BS] or, BT, [BN][BS]
  constexpr int AS = AT ? BM + 8 : BK + 8, BS = BT ? BK + 8 : BN + 8;
  constexpr int A_ELEMS = (AT ? BK : BM) * AS, B_ELEMS = (BT ? BN : BK) * BS;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);  // [STAGES][A_ELEMS]
  bf16* Bs = As + STAGES * A_ELEMS;                // [STAGES][B_ELEMS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int split =
      ix::gemm_clustered(splits) ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  int m0, n0, kbeg, kend;
  ix::gemm_tile(blockIdx.x, blockIdx.y, BM, BN, splits, m0, n0);
  ix::split_range(split, kc, K, kbeg, kend);
  const bf16 zero = __float2bfloat16(0.f);
  const uint64_t pol = l2_evict_first();  // B is read once per call

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  auto load = [&](int kt, int s) {
    const int k0 = kbeg + kt * BK;
    bf16* as = As + s * A_ELEMS;
    bf16* bs = Bs + s * B_ELEMS;
    if (AT && vecA) {
      for (int e = tid; e < BK * BM / 8; e += NT) {
        const int r = e / (BM / 8), c = (e % (BM / 8)) * 8;
        const int gk = k0 + r, gm = m0 + c;
        const bool ok = ix::in_edge(gk, kend, gm, M);
        cp_async16(as + r * AS + c, ok ? A + (size_t)gk * M + gm : A, ok);
      }
    } else if (AT) {
      for (int e = tid; e < BK * BM; e += NT) {
        const int r = e / BM, c = e % BM;
        const int gk = k0 + r, gm = m0 + c;
        as[r * AS + c] = ix::in_edge(gk, kend, gm, M) ? A[(size_t)gk * M + gm] : zero;
      }
    } else if (vecA) {
      for (int e = tid; e < BM * BK / 8; e += NT) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = ix::in_edge(gm, M, gk, kend);
        cp_async16(as + r * AS + c, ok ? A + (size_t)gm * K + gk : A, ok);
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        const int gm = m0 + r, gk = k0 + c;
        as[r * AS + c] = (ix::inside(gm, M) && ix::inside(gk, kend)) ? A[(size_t)gm * K + gk]
                                                                   : zero;
      }
    }
    if (BT && vecB) {
      for (int e = tid; e < BN * BK / 8; e += NT) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        const bool ok = ix::in_edge(gn, N, gk, kend);
        cp_async16(bs + r * BS + c, ok ? B + (size_t)gn * K + gk : B, ok, pol);
      }
    } else if (BT) {
      for (int e = tid; e < BN * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        const int gn = n0 + r, gk = k0 + c;
        bs[r * BS + c] = ix::in_edge(gn, N, gk, kend) ? B[(size_t)gn * K + gk] : zero;
      }
    } else if (vecB) {
      for (int e = tid; e < BK * BN / 8; e += NT) {
        const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        const bool ok = ix::in_edge(gk, kend, gn, N);
        cp_async16(bs + r * BS + c, ok ? B + (size_t)gk * N + gn : B, ok, pol);
      }
    } else {
      for (int e = tid; e < BK * BN; e += NT) {
        const int r = e / BN, c = e % BN;
        const int gk = k0 + r, gn = n0 + c;
        bs[r * BS + c] = (ix::inside(gk, kend) && ix::inside(gn, N)) ? B[(size_t)gk * N + gn]
                                                                   : zero;
      }
    }
  };

  const int KT = ix::split_k_tiles(kbeg, kend, BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; stage (kt-1) is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk, nk % STAGES);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * A_ELEMS;
    const bf16* bs = Bs + (kt % STAGES) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NTL][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (AT)  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
          ldmatrix_x4_trans(af[mi], as + (kk + (lane & 7) + (lane >> 4) * 8) * AS + wm * WM +
                                        mi * 16 + ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4(af[mi], as + (wm * WM + mi * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NTL / 2; ++np) {  // two n8 tiles per ldmatrix
        uint32_t r4[4];
        if (BT)
          ldmatrix_x4(r4, bs + (wn * WN + np * 16 + (lane & 7) + (lane >> 4) * 8) * BS + kk +
                              ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(r4, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * BS +
                                    wn * WN + np * 16 + (lane >> 4) * 8);
        bfr[2 * np][0] = r4[0];
        bfr[2 * np][1] = r4[1];
        bfr[2 * np + 1][0] = r4[2];
        bfr[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NTL; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

  if (ix::gemm_stores_direct(splits)) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gm = m0 + wm * WM + mi * 16 + g + (r >= 2 ? 8 : 0);
          const int gn = n0 + wn * WN + ni * 8 + c2 + (r & 1);
          if (ix::in_edge(gm, M, gn, N)) C[(size_t)gm * N + gn] = from_f<TO>(acc[mi][ni][r]);
        }
    return;
  }

  // split K: the partial tile goes to this block's shared memory (the ring
  // is free), then each block of the cluster sums a slice of the tile over
  // all partials in split order and stores it
  constexpr int RS = BN + 4;  // f32 row stride of the partial tile
  __syncthreads();
  float* red = reinterpret_cast<float*>(gemm_smem);  // [BM][RS]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wm * WM + mi * 16 + g + (r >= 2 ? 8 : 0);
        red[row * RS + wn * WN + ni * 8 + c2 + (r & 1)] = acc[mi][ni][r];
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  int e0, e1;
  ix::reduce_slice(split, splits, BM, BN, M, m0, e0, e1);
  for (int e = e0 + tid; e < e1; e += NT) {
    const int row = e / (BN / 4), col = (e % (BN / 4)) * 4;
    float4 sum = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, 0) +
                                                  row * RS + col);
    for (int s = 1; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, s) +
                                                        row * RS + col);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
    TO* out = C + (size_t)(m0 + row) * N + n0 + col;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ix::inside(n0 + col + u, N)) out[u] = from_f<TO>(vals[u]);
  }
  cluster.sync();  // no block leaves while the others read its partial
}

// f32 CUDA-core kernel (f32 inputs; off the serving path).  Each thread
// owns TM x TN outputs, each a sequential fmaf chain over k.  BT: B is
// stored [N, K]; AT: A is stored [K, M] (read along m by neighbouring
// threads).
template <int BM, int BN, int BK, int TM, int TN, bool AT, bool BT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int CG = BN / TN;  // thread tx owns columns tx + j*CG
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % CG, ty = tid / CG;
  int m0, n0;
  ix::gemm_tile(blockIdx.x, blockIdx.y, BM, BN, 1, m0, n0);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = AT ? e % BM : e / BK, c = AT ? e / BM : e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[AT ? (size_t)gk * M + gm : (size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e / BN, c = e % BN, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[BT ? (size_t)gn * K + gk : (size_t)gk * N + gn]
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * CG];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * CG;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}


template <int BM, int BN, int WM, int WN, int STAGES, bool AT, bool BT, typename TO>
int launch_tile(const bf16* A, const bf16* B, TO* C, int M, int N, int K, int vecA, int vecB,
                int splits, cudaStream_t stream) {
  constexpr int BK = GEMM_BK;
  const size_t smem = sizeof(bf16) * STAGES *
                      ((size_t)(AT ? BK : BM) * ((AT ? BM : BK) + 8) +
                       (size_t)(BT ? BN : BK) * ((BT ? BK : BN) + 8));
  auto kern = gemm_bf16_kernel<BM, BN, WM, WN, STAGES, AT, BT, TO>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // kc: ceil(K / splits) rounded up to the k-tile -- a function of (K, splits)
  const int kc = ix::split_chunk(K, splits, BK);
  cudaLaunchConfig_t cfg = {};
  int gx, gy;
  ix::gemm_grid(M, N, BM, BN, splits, gx, gy);
  cfg.gridDim = dim3(gx, gy);
  cfg.blockDim = dim3((BM / WM) * (BN / WN) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ix::gemm_clustered(splits) ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, A, B, C, M, N, K, vecA, vecB, splits, kc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool AT, bool BT, typename TO>
int launch_bf16(const bf16* A, const bf16* B, TO* C, int M, int N, int K, int splits,
                cudaStream_t stream) {
  if (splits < 1 || splits > 8) return static_cast<int>(cudaErrorInvalidValue);
  const int vecA = ((AT ? M : K) % 8 == 0) && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
  const int vecB = ((BT ? K : N) % 8 == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  // decode rows: one m16 tile; 128 columns (4 stages) where K is split, so
  // that a block keeps 16 KB of B per stage in flight, else 64 (5 stages),
  // which fills the SMs better at the LM head's 50k-262k columns
  int bm, bn;
  ix::bf16_tile(M, splits, bm, bn);
  if (bm == 16 && bn == 128)
    return launch_tile<16, 128, 16, 32, 4, AT, BT, TO>(A, B, C, M, N, K, vecA, vecB, splits,
                                                   stream);
  if (bm == 16)
    return launch_tile<16, 64, 16, 16, 5, AT, BT, TO>(A, B, C, M, N, K, vecA, vecB, splits,
                                                  stream);
  // mixed-tick and prefill rows: 64 x 64 tiles, four 32 x 32 warp tiles, 4 stages
  return launch_tile<64, 64, 32, 32, 4, AT, BT, TO>(A, B, C, M, N, K, vecA, vecB, splits, stream);
}

}  // namespace repro

// in_bf16: A and B are bf16 (else f32).  out_bf16: C is bf16 (else f32).
// trans_a: A is [K, M]; trans_b: B is [N, K] (not both).  splits: the bf16
// kernel's split of K (1..8, from block_gemm.gemm_splits); the f32 kernel
// does not split.  Returns the launch's error, else cudaGetLastError() after
// it.
extern "C" int repro_block_gemm(const void* a, const void* b, void* c, int M, int N,
                                int K, int in_bf16, int out_bf16, int trans_a, int trans_b,
                                int splits, void* stream) {
  using repro::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_a && trans_b) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* A16 = static_cast<const bf16*>(a);
  const bf16* B16 = static_cast<const bf16*>(b);
  if (in_bf16) {
    if (out_bf16) {
      bf16* C = static_cast<bf16*>(c);
      if (trans_a) return repro::launch_bf16<true, false>(A16, B16, C, M, N, K, splits, s);
      if (trans_b) return repro::launch_bf16<false, true>(A16, B16, C, M, N, K, splits, s);
      return repro::launch_bf16<false, false>(A16, B16, C, M, N, K, splits, s);
    }
    float* C = static_cast<float*>(c);
    if (trans_a) return repro::launch_bf16<true, false>(A16, B16, C, M, N, K, splits, s);
    if (trans_b) return repro::launch_bf16<false, true>(A16, B16, C, M, N, K, splits, s);
    return repro::launch_bf16<false, false>(A16, B16, C, M, N, K, splits, s);
  }
  if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* A32 = static_cast<const float*>(a);
  const float* B32 = static_cast<const float*>(b);
  float* C32 = static_cast<float*>(c);
  if (trans_a)
    repro::gemm_f32_kernel<BM, BN, BK, TM, TN, true, false>
        <<<grid, (BM / TM) * (BN / TN), 0, s>>>(A32, B32, C32, M, N, K);
  else if (trans_b)
    repro::gemm_f32_kernel<BM, BN, BK, TM, TN, false, true>
        <<<grid, (BM / TM) * (BN / TN), 0, s>>>(A32, B32, C32, M, N, K);
  else
    repro::gemm_f32_kernel<BM, BN, BK, TM, TN, false, false>
        <<<grid, (BM / TM) * (BN / TN), 0, s>>>(A32, B32, C32, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
