// Block GEMM C[M,N] = A[M,K] @ B[K,N] (or B stored [N,K]) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/block_gemm.py, _gemm_kernel (wrapper
// block_gemm) -- the output-stationary block accumulation every projection
// and the LM head run through.
//
// What bounds it on an H100: at the serving shapes (M = 8 decode rows, M =
// chunk_tokens prefill rows) the weight matrix B is read once per call and
// dominates the bytes, while 2*M*K*N operations stay far below the card's
// operations-per-byte balance -- the kernel is bound by reading B.  The
// design keeps many bytes of B in flight: cp.async copies 16-byte chunks of
// the next tiles into a 3-4 stage shared-memory ring while the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) work on the current one, and
// a 16 x 32 output tile for small M spreads even a 2048-wide projection
// over 64 blocks.  f32 inputs take a CUDA-core FMA kernel (full f32, never
// TF32); they are off the serving path.
//
// Reduction order: each output is one f32 accumulator chain over k = 0..K-1
// in fixed steps (k16 tensor-core steps for bf16, single fmaf steps for
// f32) -- the same for every M, tile choice and batch, with no split over
// K and no atomics.  Ragged M/K/N edges are zero-filled on load (zeros
// leave the chain unchanged) and masked on store -- no padded copies.  The
// f32 accumulator is cast once in the epilogue (f32 straight out for the
// LM head).
#include "common.cuh"

namespace repro {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 tensor-core kernel.  Block tile BM x BN, k-tile BK, warp tile WM x WN
// (WM/16 x WN/8 mma tiles per warp), STAGES-deep cp.async ring.  vecA/vecB:
// the operand's rows are 16-byte aligned (K resp. the row length of B a
// multiple of 8 and an aligned base), so tiles move as 16-byte cp.async
// chunks; otherwise they move element by element with the same zero fill.
// BT: B is stored [N, K] (the tied LM head reads the [V, D] embedding table
// in place); its tile is kept k-contiguous, so each mma B fragment is one
// 32-bit shared load.  The k16 steps, and so every result, are the same.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool BT, typename TO>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, TO* __restrict__ C,
                 int M, int N, int K, int vecA, int vecB) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16, NTL = WN / 8;
  // padded rows: 16-byte aligned, fewer conflicts; B is [BK][BS] or, BT, [BN][BS]
  constexpr int AS = BK + 8, BS = BT ? BK + 8 : BN + 8;
  __shared__ __align__(16) bf16 As[STAGES][BM * AS];
  __shared__ __align__(16) bf16 Bs[STAGES][(BT ? BN : BK) * BS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16 zero = __float2bfloat16(0.f);

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
    bf16* as = As[s];
    bf16* bs = Bs[s];
    if (vecA) {
      for (int e = tid; e < BM * BK / 8; e += NT) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = gm < M && gk < K;
        cp_async16(as + r * AS + c, ok ? A + (size_t)gm * K + gk : A, ok);
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        const int gm = m0 + r, gk = k0 + c;
        as[r * AS + c] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : zero;
      }
    }
    if (BT && vecB) {
      for (int e = tid; e < BN * BK / 8; e += NT) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        const bool ok = gn < N && gk < K;
        cp_async16(bs + r * BS + c, ok ? B + (size_t)gn * K + gk : B, ok);
      }
    } else if (BT) {
      for (int e = tid; e < BN * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        const int gn = n0 + r, gk = k0 + c;
        bs[r * BS + c] = (gn < N && gk < K) ? B[(size_t)gn * K + gk] : zero;
      }
    } else if (vecB) {
      for (int e = tid; e < BK * BN / 8; e += NT) {
        const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        const bool ok = gk < K && gn < N;
        cp_async16(bs + r * BS + c, ok ? B + (size_t)gk * N + gn : B, ok);
      }
    } else {
      for (int e = tid; e < BK * BN; e += NT) {
        const int r = e / BN, c = e % BN;
        const int gk = k0 + r, gn = n0 + c;
        bs[r * BS + c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : zero;
      }
    }
  };

  const int KT = (K + BK - 1) / BK;
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
    const bf16* as = As[kt % STAGES];
    const bf16* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NTL][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const bf16* p = as + (wm * WM + mi * 16 + g) * AS + kk + c2;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * AS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * AS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NTL; ++ni) {
        if (BT) {
          const bf16* q = bs + (wn * WN + ni * 8 + g) * BS + kk + c2;
          bfr[ni][0] = *reinterpret_cast<const uint32_t*>(q);
          bfr[ni][1] = *reinterpret_cast<const uint32_t*>(q + 8);
        } else {
          const bf16* q = bs + (kk + c2) * BS + wn * WN + ni * 8 + g;
          bfr[ni][0] = pack_bf16(q[0], q[BS]);
          bfr[ni][1] = pack_bf16(q[8 * BS], q[9 * BS]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NTL; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm * WM + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int gn = n0 + wn * WN + ni * 8 + c2 + (r & 1);
        if (gm < M && gn < N) C[(size_t)gm * N + gn] = from_f<TO>(acc[mi][ni][r]);
      }
}

// f32 CUDA-core kernel (f32 inputs; off the serving path).  Each thread
// owns TM x TN outputs, each a sequential fmaf chain over k.  BT: B is
// stored [N, K].
template <int BM, int BN, int BK, int TM, int TN, bool BT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int CG = BN / TN;  // thread tx owns columns tx + j*CG
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % CG, ty = tid / CG;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
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

template <bool BT, typename TO>
void launch_bf16(const bf16* A, const bf16* B, TO* C, int M, int N, int K,
                 cudaStream_t stream) {
  const int vecA = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
  const int vecB = ((BT ? K : N) % 8 == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  if (M <= 16) {  // decode rows: one m16 tile, 32 columns per block
    constexpr int BM = 16, BN = 32, BK = 64, WM = 16, WN = 8, ST = 4;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_bf16_kernel<BM, BN, BK, WM, WN, ST, BT, TO>
        <<<grid, (BM / WM) * (BN / WN) * 32, 0, stream>>>(A, B, C, M, N, K, vecA, vecB);
  } else {        // prefill chunks: 64 x 64 tiles, four 32 x 32 warp tiles
    constexpr int BM = 64, BN = 64, BK = 32, WM = 32, WN = 32, ST = 3;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_bf16_kernel<BM, BN, BK, WM, WN, ST, BT, TO>
        <<<grid, (BM / WM) * (BN / WN) * 32, 0, stream>>>(A, B, C, M, N, K, vecA, vecB);
  }
}

}  // namespace repro

// in_bf16: A and B are bf16 (else f32).  out_bf16: C is bf16 (else f32).
// trans_b: B is [N, K].  Returns cudaGetLastError() after the launch.
extern "C" int repro_block_gemm(const void* a, const void* b, void* c, int M, int N,
                                int K, int in_bf16, int out_bf16, int trans_b,
                                void* stream) {
  using repro::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A16 = static_cast<const bf16*>(a);
  const bf16* B16 = static_cast<const bf16*>(b);
  if (in_bf16 && out_bf16 && trans_b) {
    repro::launch_bf16<true, bf16>(A16, B16, static_cast<bf16*>(c), M, N, K, s);
  } else if (in_bf16 && trans_b) {
    repro::launch_bf16<true, float>(A16, B16, static_cast<float*>(c), M, N, K, s);
  } else if (in_bf16 && out_bf16) {
    repro::launch_bf16<false, bf16>(A16, B16, static_cast<bf16*>(c), M, N, K, s);
  } else if (in_bf16) {
    repro::launch_bf16<false, float>(A16, B16, static_cast<float*>(c), M, N, K, s);
  } else if (!out_bf16) {
    constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const float* A32 = static_cast<const float*>(a);
    const float* B32 = static_cast<const float*>(b);
    float* C32 = static_cast<float*>(c);
    if (trans_b)
      repro::gemm_f32_kernel<BM, BN, BK, TM, TN, true>
          <<<grid, (BM / TM) * (BN / TN), 0, s>>>(A32, B32, C32, M, N, K);
    else
      repro::gemm_f32_kernel<BM, BN, BK, TM, TN, false>
          <<<grid, (BM / TM) * (BN / TN), 0, s>>>(A32, B32, C32, M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
