// Packed int8 block GEMM for Hopper (sm_90a):
//   C[m,n] = (float(sum_k A_q[m,k] * B_q[n,k]) * a_scale[m]) * b_scale[n]
//
// Replaces: src/repro/kernels/block_gemm.py, _gemm_int8_kernel (wrapper
// block_gemm_int8) -- the paper's packed-data GEMM with its fused dequant
// epilogue, which every projection and the LM head run through under w8a8.
//
// Layout: B is stored [N, K], K contiguous -- the transpose of the JAX
// operand.  The s8 tensor-core product (mma.sync m16n8k32) wants four
// consecutive K bytes of B in each register, and ldmatrix.trans does not
// transpose 8-bit elements, so the port's quantizer (models/model.py,
// quantize_params) stores each weight so once at load.  Both tiles are then
// k-contiguous in shared memory and every fragment is one 32-bit load.
//
// What bounds it on an H100: at decode (M = batch rows) the int8 weight,
// K*N bytes, is read once and the operations are far below the card's
// balance -- bytes.  At whole-prompt prefill (M = thousands of rows) the
// 2*M*N*K operations bound it (1979 TOP/s int8 peak).  The design keeps
// tiles of both operands in flight through a 3-4 stage cp.async ring while
// the tensor cores work on the current tile; a 16 x 32 block tile for small
// M gives even a 2048-wide projection 64 blocks, 64 x 64 tiles serve prefill.
//
// Exactness: each output is one int32 accumulator over k (exact while
// K * 127 * 127 < 2^31), converted to f32 with round-to-nearest and scaled
// in the JAX kernel's order, (acc * a_scale) * b_scale, then cast once (f32
// or bf16).  Ragged M/N/K edges are zero-filled on load by cp.async
// (src-size 0) or element by element, never by padded copies, and masked on
// store.
#include "common.cuh"

namespace repro {

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Block tile BM x BN, k-tile BK bytes, warp tile WM x WN (WM/16 x WN/8 mma
// tiles per warp), STAGES-deep ring.  vec: K is a multiple of 16 and both
// bases are 16-byte aligned, so tiles move as 16-byte cp.async chunks.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, typename TO>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gemm_int8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 TO* __restrict__ C, int M, int N, int K, int vec) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16, NTL = WN / 8;
  constexpr int RS = BK + 16;  // padded rows: 16-byte aligned, conflict-free fragments
  __shared__ __align__(16) int8_t As[STAGES][BM * RS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * RS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = (lane & 3) * 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // rows x BK bytes of a k-contiguous operand (A: rows m, B: rows n)
  auto load_tile = [&](const int8_t* src, int8_t* dst, int rows, int r0, int rmax, int k0) {
    if (vec) {
      for (int e = tid; e < rows * (BK / 16); e += NT) {
        const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
        const int gr = r0 + r, gk = k0 + c;
        const bool ok = gr < rmax && gk < K;
        cp_async16(dst + r * RS + c, ok ? src + (size_t)gr * K + gk : src, ok);
      }
    } else {
      for (int e = tid; e < rows * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        const int gr = r0 + r, gk = k0 + c;
        dst[r * RS + c] = (gr < rmax && gk < K) ? src[(size_t)gr * K + gk] : int8_t(0);
      }
    }
  };
  auto load = [&](int kt, int s) {
    load_tile(A, As[s], BM, m0, M, kt * BK);
    load_tile(B, Bs[s], BN, n0, N, kt * BK);
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
    const int8_t* as = As[kt % STAGES];
    const int8_t* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bfr[NTL][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int8_t* p = as + (wm * WM + mi * 16 + g) * RS + kk + c4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * RS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * RS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NTL; ++ni) {
        const int8_t* q = bs + (wn * WN + ni * 8 + g) * RS + kk + c4;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(q);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NTL; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm * WM + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int gn = n0 + wn * WN + ni * 8 + c2 + (r & 1);
        if (gm < M && gn < N) {
          const float x = __int2float_rn(acc[mi][ni][r]) * sa[gm];
          C[(size_t)gm * N + gn] = from_f<TO>(x * sb[gn]);
        }
      }
}

template <typename TO>
void launch_int8(const int8_t* A, const int8_t* B, const float* sa, const float* sb, TO* C,
                 int M, int N, int K, cudaStream_t stream) {
  const int vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(A) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  if (M <= 16) {  // decode rows: one m16 tile, 32 columns per block
    constexpr int BM = 16, BN = 32, BK = 128, WM = 16, WN = 8, ST = 4;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_int8_kernel<BM, BN, BK, WM, WN, ST, TO>
        <<<grid, (BM / WM) * (BN / WN) * 32, 0, stream>>>(A, B, sa, sb, C, M, N, K, vec);
  } else {        // prefill rows: 64 x 64 tiles, four 32 x 32 warp tiles
    constexpr int BM = 64, BN = 64, BK = 64, WM = 32, WN = 32, ST = 3;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_int8_kernel<BM, BN, BK, WM, WN, ST, TO>
        <<<grid, (BM / WM) * (BN / WN) * 32, 0, stream>>>(A, B, sa, sb, C, M, N, K, vec);
  }
}

}  // namespace repro

// a [M,K] int8; b [N,K] int8; a_scale [M] f32; b_scale [N] f32; c [M,N] f32
// or, out_bf16, bf16.  Returns cudaGetLastError() after the launch.
extern "C" int repro_block_gemm_int8(const void* a, const void* b, const void* a_scale,
                                     const void* b_scale, void* c, int M, int N, int K,
                                     int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  if (out_bf16)
    repro::launch_int8<__nv_bfloat16>(A, B, sa, sb, static_cast<__nv_bfloat16*>(c), M, N, K,
                                      s);
  else
    repro::launch_int8<float>(A, B, sa, sb, static_cast<float*>(c), M, N, K, s);
  return static_cast<int>(cudaGetLastError());
}
