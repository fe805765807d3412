// Packed int8 block GEMM for Hopper (sm_90a):
//   C[m,n] = (float(sum_k A_q[m,k] * B_q[n,k]) * a_scale[m]) * b_scale[n]
//
// Replaces: src/repro/kernels/block_gemm.py, _gemm_int8_kernel (wrapper
// block_gemm_int8) -- the paper's packed-data GEMM with its fused dequant
// epilogue, which every projection and the LM head run through under w8a8.
//
// Layout: A [M, K] and B [N, K], both K contiguous -- B is the transpose of
// the JAX operand, stored so once at load by the port's quantizer
// (models/model.py, quantize_params).  That is the only layout either s8
// tensor-core product takes: wgmma reads 8-bit operands K-major only, and
// mma.sync m16n8k32 wants four consecutive K bytes of B in a register.  No
// transpose happens anywhere, in device memory or in shared memory.
//
// Two designs, chosen by the wrapper (block_gemm.int8_route):
//
// 1. Whole-prompt prefill (M > 64 and enough 128 x 128 tiles to give every
//    SM one): operations bound it (2MNK at the 1979 TOP/s int8 peak).  A
//    persistent, warp-specialised kernel on wgmma.mma_async m64nNk32 s8:
//    one producer thread issues TMA loads of 128 x 128-byte tiles of A and
//    BN x 128-byte tiles of B (128-byte swizzle; out-of-bounds rows and
//    columns zero-filled by the TMA unit) into a STAGES-deep ring of
//    mbarrier-guarded stages in dynamic shared memory; two consumer
//    warpgroups each take 64 rows of the 128 x BN output tile, issue four
//    k32 wgmmas a stage straight from the swizzled tiles, keep one stage's
//    wgmmas in flight and release the stage before it.  Blocks walk the
//    tiles m-first (the tiles in flight share B columns and A stays in L2),
//    and the producer runs on into the next tile while the consumers store
//    this one.  The store is the tensor cores' idle time, so it is kept
//    short: the tile's column scales wait in shared memory (loaded at the
//    tile's start), and a quad of threads swaps its outputs so that each
//    thread writes 16 whole bytes of a row (store_tile).  setmaxnreg gives
//    the consumers 232 registers and the producer 40.  The tensor maps come
//    from the CUDA driver's cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPoint, so the ctypes-loaded library needs no
//    -lcuda.  BN is 256 (4 stages), or 128
//    (6 stages) where 256-wide tiles would spread over the SMs much more
//    unevenly (3072 x 2048).  A barrier wait of more than 10 s traps.
// 2. Decode rows (M <= 16), the engine's w8a8 chunks and any M the wgmma
//    kernel cannot fill the card with: the int8 weight, K*N bytes read
//    once, bounds it.  mma.sync m16n8k32 on 16 x 128 (M <= 16) or 64 x 128
//    block tiles; 128-byte k-tiles of B move as 16-byte cp.async chunks
//    under an L2 evict-first policy through a 4-stage (3-stage) ring, 16 KB
//    of B a stage.  (The hinted copies sit in a loop kept rolled: unrolled,
//    ptxas of CUDA 12.8 emitted LDGSTS instructions with an odd-numbered
//    uniform descriptor register, and every launch faulted with an illegal
//    instruction.)  Where the column tiles cannot give every SM a block, K
//    is split S ways (block_gemm.int8_splits(K, N)) and the S blocks of a
//    column tile form a thread block cluster: each leaves its int32 partial
//    tile in shared memory, and after a cluster barrier each block sums a
//    slice of the tile over all partials, in split order, over distributed
//    shared memory, and applies the epilogue.  One launch, no atomics, no
//    scratch.  Where no split is needed at M <= 16 (the LM head's 262,144
//    columns), 16 x 32 tiles without the hint: 8,192 small blocks keep more
//    loads in flight.
//
// Exactness: every output is an exact int32 sum over k (exact while
// K * 127 * 127 < 2^31), whatever the tiling, the split or the order --
// so every row is the same for every M and both designs give the same
// bits.  The epilogue converts it to f32 with round-to-nearest and scales
// it in the JAX kernel's order, (acc * a_scale) * b_scale, then casts once
// (f32 or bf16).  Ragged M/N/K edges are zero-filled on load (TMA
// out-of-bounds fill; cp.async src-size 0 or element by element), never by
// padded copies, and masked on store.
//
// Two more entries serve a row-parallel product, whose K is split over the
// ranks of a mesh (core/gemm.py, cgra_gemm_w8a8_row):
//
// - repro_block_gemm_int8_acc: the same kernels, every route and split,
//   with TO = int: the raw int32 accumulator [M, N] is stored and no
//   epilogue runs (the scales are never read).  Bounded like the fused
//   product, plus 4*M*N bytes of int32 out.  The ranks' partials are summed
//   exactly as int32 (launch/mesh.py, Mesh.all_sum_int).
// - repro_int8_epilogue: C = (float(acc) * a_scale[m]) * b_scale[n], one
//   cast -- the fused store's arithmetic, in its order, so the epilogue of
//   a whole-K accumulator equals the fused kernel's output bit for bit.  An
//   elementwise pass bounded by bytes: 4*M*N in, 4*(M + N) of scales, M*N*
//   (4 or 2) out.  One thread four consecutive columns of a row (one
//   16-byte load of acc where N % 4 == 0), grid-stride.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and the driver's enums (types only: no -lcuda)

#include "common.cuh"
#include "index.cuh"  // addresses and block decisions, as the bounds proofs read them

namespace repro {

namespace cg = cooperative_groups;

constexpr int I8_BK = ix::INT8_BK;  // k-tile depth in bytes (= int8 values)

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// TO = int: the raw accumulator, no epilogue (the scale pointers are null)
template <typename TO> struct RawOut { static constexpr bool value = false; };
template <> struct RawOut<int> { static constexpr bool value = true; };

__device__ __forceinline__ float dequant_f(int acc, float sa, float sb) {
  return (__int2float_rn(acc) * sa) * sb;
}

// output (m, n) of accumulator acc: the epilogue, or acc itself
template <typename TO>
__device__ __forceinline__ TO out_val(int acc, const float* __restrict__ sa,
                                      const float* __restrict__ sb, int m, int n) {
  if constexpr (RawOut<TO>::value) {
    return acc;
  } else {
    return from_f<TO>(dequant_f(acc, sa[m], sb[n]));
  }
}

// an output from its bits: an f32 word, or a bf16 in the low 16 bits
template <typename TO> __device__ __forceinline__ TO to_out(uint32_t bits);
template <> __device__ __forceinline__ float to_out<float>(uint32_t bits) {
  return __uint_as_float(bits);
}
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(uint32_t bits) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(bits));
}
template <> __device__ __forceinline__ int to_out<int>(uint32_t bits) {
  return static_cast<int>(bits);
}

// ---------------------------------------------------------------------------
// 1. mma.sync kernel for short M, K split over a cluster
// ---------------------------------------------------------------------------

// Block tile BM x BN, warp tile WM x WN (WM/16 x WN/8 mma tiles a warp),
// STAGES-deep cp.async ring in dynamic shared memory.  Grid: x = column tile
// * S + split, y = row tile; with S > 1 the S splits of a column tile are one
// cluster and split s sums k in [s*kc, min(K, (s+1)*kc)).  vec: K is a
// multiple of 16 and both bases are 16-byte aligned, so tiles move as
// 16-byte chunks (kc is a multiple of 32, so no chunk straddles a split).
template <int BM, int BN, int WM, int WN, int STAGES, bool HINT, typename TO>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gemm_int8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 TO* __restrict__ C, int M, int N, int K, int vec, int splits, int kc) {
  constexpr int BK = I8_BK;
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16, NTL = WN / 8;
  constexpr int RS = BK + 16;  // padded rows: 16-byte aligned, conflict-free fragments
  extern __shared__ __align__(16) unsigned char i8_smem[];
  int8_t* As = reinterpret_cast<int8_t*>(i8_smem);  // [STAGES][BM * RS]
  int8_t* Bs = As + STAGES * BM * RS;                // [STAGES][BN * RS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = (lane & 3) * 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int split =
      ix::gemm_clustered(splits) ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  int m0, n0, kbeg, kend;
  ix::gemm_tile(blockIdx.x, blockIdx.y, BM, BN, splits, m0, n0);
  ix::split_range(split, kc, K, kbeg, kend);

  int acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // BK bytes of BM rows of A and BN rows of B (both k-contiguous)
  auto load = [&](int kt, int s) {
    const int k0 = kbeg + kt * BK;
    int8_t* as = As + s * BM * RS;
    int8_t* bs = Bs + s * BN * RS;
    if (vec) {
      for (int e = tid; e < BM * (BK / 16); e += NT) {
        const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
        const int gm = m0 + r, gk = k0 + c;
        const bool ok = ix::in_edge(gm, M, gk, kend);
        cp_async16(as + r * RS + c, ok ? A + (size_t)gm * K + gk : A, ok);
      }
      if (HINT) {
        const uint64_t pol = l2_evict_first();  // B is read once per call
#pragma unroll 1  // unrolled, this loop's hinted copies fault (see the note above)
        for (int e = tid; e < BN * (BK / 16); e += NT) {
          const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
          const int gn = n0 + r, gk = k0 + c;
          const bool ok = ix::in_edge(gn, N, gk, kend);
          cp_async16(bs + r * RS + c, ok ? B + (size_t)gn * K + gk : B, ok, pol);
        }
      } else {
        for (int e = tid; e < BN * (BK / 16); e += NT) {
          const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
          const int gn = n0 + r, gk = k0 + c;
          const bool ok = ix::in_edge(gn, N, gk, kend);
          cp_async16(bs + r * RS + c, ok ? B + (size_t)gn * K + gk : B, ok);
        }
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        const int gm = m0 + r, gk = k0 + c;
        as[r * RS + c] = ix::in_edge(gm, M, gk, kend) ? A[(size_t)gm * K + gk] : int8_t(0);
      }
      for (int e = tid; e < BN * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        const int gn = n0 + r, gk = k0 + c;
        bs[r * RS + c] = ix::in_edge(gn, N, gk, kend) ? B[(size_t)gn * K + gk] : int8_t(0);
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
    const int8_t* as = As + (kt % STAGES) * BM * RS;
    const int8_t* bs = Bs + (kt % STAGES) * BN * RS;
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
  if (ix::gemm_stores_direct(splits)) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gm = m0 + wm * WM + mi * 16 + g + (r >= 2 ? 8 : 0);
          const int gn = n0 + wn * WN + ni * 8 + c2 + (r & 1);
          if (ix::in_edge(gm, M, gn, N))
            C[(size_t)gm * N + gn] = out_val<TO>(acc[mi][ni][r], sa, sb, gm, gn);
        }
    return;
  }

  // split K: the int32 partial tile goes to this block's shared memory (the
  // ring is free), then each block of the cluster sums a slice of the tile
  // over all partials in split order and applies the epilogue
  constexpr int PS = BN + 4;  // int32 row stride of the partial tile
  __syncthreads();
  int* red = reinterpret_cast<int*>(i8_smem);  // [BM][PS]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wm * WM + mi * 16 + g + (r >= 2 ? 8 : 0);
        red[row * PS + wn * WN + ni * 8 + c2 + (r & 1)] = acc[mi][ni][r];
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  int e0, e1;
  ix::reduce_slice(split, splits, BM, BN, M, m0, e0, e1);
  for (int e = e0 + tid; e < e1; e += NT) {
    const int row = e / (BN / 4), col = (e % (BN / 4)) * 4;
    int4 sum = *reinterpret_cast<const int4*>(cluster.map_shared_rank(red, 0) + row * PS + col);
    for (int s = 1; s < splits; ++s) {
      const int4 p =
          *reinterpret_cast<const int4*>(cluster.map_shared_rank(red, s) + row * PS + col);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const int vals[4] = {sum.x, sum.y, sum.z, sum.w};
    const int gm = m0 + row;
    TO* out = C + (size_t)gm * N + n0 + col;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ix::inside(n0 + col + u, N)) out[u] = out_val<TO>(vals[u], sa, sb, gm, n0 + col + u);
  }
  cluster.sync();  // no block leaves while the others read its partial
}

// ---------------------------------------------------------------------------
// 2. wgmma kernel for whole-prompt prefill: TMA ring, warp-specialised,
//    persistent
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;          // two consumer warpgroups of 64 rows
constexpr int WG_THREADS = 384;     // consumers: warpgroups 0, 1; producer: 2

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// spins until the phase of parity `parity` has completed; a wait of more
// than 10 s (a lost TMA load or arrival) traps, so the fault surfaces as a
// launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0, spins = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 4095) == 0) {
      const uint64_t t = global_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 10000000000ull) __trap();
    }
  }
}

// TMA: the box at (k0, row0) of a 2-D tensor map into shared memory,
// completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(row0)
      : "memory");
}

// wgmma descriptor of a K-major tile under the 128-byte swizzle: 8-row
// groups of 128-byte rows, 1024 bytes apart (SBO); LBO is unused for this
// layout (1).  The tile base is 1024-byte aligned; a k32 step inside the
// 128-byte row adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// D[64 x N] += A[64 x 32] * B[N x 32]^T, s8 in, s32 accumulate; every thread
// of the warpgroup holds N/2 accumulators
template <int N> __device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65,"
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81,"
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
      "%125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
        "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
        "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
        "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),
        "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),
        "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]),
        "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
        "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// named barrier of one warpgroup's 128 threads (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// One warp's 16 x BN rows of the output tile, from its wgmma accumulators:
// accumulator i holds row (lane / 4) + 8 * ((i / 2) % 2) and column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2.  For each 16 columns, the four
// threads of a quad swap their dequantised pairs in four shuffle rounds
// (round r: thread c reads from thread c ^ r) so that thread c ends up
// with 8 consecutive outputs of one row -- row (lane / 4) + 8 * (c / 2),
// columns 8 * (c % 2) .. + 7 -- and stores them as 16 bytes (bf16) or 2 x
// 16 bytes (f32): every 32-byte sector written whole, instead of 8-byte
// pieces of sixteen rows.  sbs: the tile's column scales.
template <int BN, typename TO>
__device__ __forceinline__ void store_tile(const int* acc, const float* sbs,
                                           const float* __restrict__ sa, TO* __restrict__ C,
                                           int M, int N, int row0, int n0, int lane) {
  constexpr int W = sizeof(TO) == 2 ? 1 : 2;  // 32-bit words per output pair
  constexpr bool RAW = RawOut<TO>::value;
  const int c = lane & 3, rb = row0 + (lane >> 2);
  float am0 = 0.f, am1 = 0.f;
  if constexpr (!RAW) {
    am0 = rb < M ? sa[rb] : 0.f;
    am1 = rb + 8 < M ? sa[rb + 8] : 0.f;
  }
  const int row = rb + 8 * (c >> 1);
  const bool vec = row < M && N % 8 == 0;
  TO* crow = C + (size_t)row * N;
#pragma unroll
  for (int k = 0; k < BN / 16; ++k) {
    uint32_t w[2][2][W];  // [j % 2][h][word]: columns 16k + 8j' + 2c, +1 of row rb + 8h
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (2 * k + jj) + 2 * h, col = 16 * k + 8 * jj + 2 * c;
        if constexpr (RAW) {
          w[jj][h][0] = static_cast<uint32_t>(acc[i]);
          w[jj][h][W - 1] = static_cast<uint32_t>(acc[i + 1]);
        } else {
          const float am = h ? am1 : am0;
          const float x0 = dequant_f(acc[i], am, sbs[col]);
          const float x1 = dequant_f(acc[i + 1], am, sbs[col + 1]);
          if (W == 1) {
            w[jj][h][0] = pack_bf16x2(x0, x1);
          } else {
            w[jj][h][0] = __float_as_uint(x0);
            w[jj][h][W - 1] = __float_as_uint(x1);
          }
        }
      }
    uint32_t o[4][W];  // o[q]: columns 8 * (c % 2) + 2q, +1 of `row`
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = c ^ r;  // send what thread q needs, read thread q's
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const uint32_t send = q == 0   ? w[0][0][e]
                              : q == 1 ? w[1][0][e]
                              : q == 2 ? w[0][1][e]
                                       : w[1][1][e];
        const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | q);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (q == u) o[u][e] = got;
      }
    }
    const int col0 = n0 + 16 * k + 8 * (c & 1);
    if (vec && col0 < N) {
      if (W == 1) {
        *reinterpret_cast<uint4*>(crow + col0) = make_uint4(o[0][0], o[1][0], o[2][0], o[3][0]);
      } else {
        *reinterpret_cast<uint4*>(crow + col0) = make_uint4(o[0][0], o[0][W - 1], o[1][0],
                                                            o[1][W - 1]);
        *reinterpret_cast<uint4*>(crow + col0 + 4) = make_uint4(o[2][0], o[2][W - 1], o[3][0],
                                                                o[3][W - 1]);
      }
    } else if (row < M) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 2 * u + e;
          if (col >= N) continue;
          if (W == 1) {
            const uint32_t bits = e ? (o[u][0] >> 16) : (o[u][0] & 0xffffu);
            crow[col] = to_out<TO>(bits);
          } else {
            crow[col] = to_out<TO>(o[u][e]);
          }
        }
    }
  }
}

// Grid: one block an SM (at most one a tile), each walking the tiles t =
// blockIdx.x, + gridDim.x, ...; tile t covers rows (t % mt) * 128 and
// columns (t / mt) * BN.  Shared memory: STAGES x (A tile 128 x 128 B, B
// tile BN x 128 B), 1024-byte aligned, then the full/empty barriers.
template <int BN, int STAGES, typename TO>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                       const __grid_constant__ CUtensorMap tmB, const float* __restrict__ sa,
                       const float* __restrict__ sb, TO* __restrict__ C, int M, int N, int K) {
  constexpr int A_BYTES = WG_BM * I8_BK, B_BYTES = BN * I8_BK;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* As = reinterpret_cast<int8_t*>(base);  // [STAGES][A_BYTES]
  int8_t* Bs = As + STAGES * A_BYTES;              // [STAGES][B_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;
  float* sb_tile = reinterpret_cast<float*>(empty + STAGES);  // [2][BN] column scales

  const int tid = threadIdx.x, wg = tid / 128;
  int mt, ntiles, grid;
  ix::walk_grid(M, N, WG_BM, BN, gridDim.x, mt, ntiles, grid);
  const int KT = ix::whole_k_tiles(K, I8_BK);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = ix::walk_first(blockIdx.x); t < ntiles; t += ix::walk_stride(gridDim.x)) {
        int m0, n0;
        ix::walk_tile(t, mt, WG_BM, BN, m0, n0);
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);  // a fresh stage passes at once
          mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
          tma_load_2d(As + s * A_BYTES, &tmA, &full[s], kt * I8_BK, m0);
          tma_load_2d(Bs + s * B_BYTES, &tmB, &full[s], kt * I8_BK, n0);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg takes rows wg*64 .. wg*64+63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = tid & 31, wi = (tid & 127) >> 5;
    int s = 0;
    uint32_t ph = 0;
    float* sbs = sb_tile + wg * BN;
    for (int t = ix::walk_first(blockIdx.x); t < ntiles; t += ix::walk_stride(gridDim.x)) {
      int m0, n0;
      ix::walk_tile(t, mt, WG_BM, BN, m0, n0);
      // this tile's column scales, read from shared memory by the epilogue
      // (the barrier: the warpgroup's last epilogue is done with them)
      wg_bar(1 + wg);
      if constexpr (!RawOut<TO>::value)
        for (int i = tid & 127; i < BN; i += 128) sbs[i] = n0 + i < N ? sb[n0 + i] : 0.f;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[s], ph);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
        wgmma_fence();
        const int8_t* as = As + s * A_BYTES + wg * 64 * I8_BK;
        const int8_t* bs = Bs + s * B_BYTES;
#pragma unroll
        for (int kk = 0; kk < I8_BK; kk += 32)
          wgmma_s8<BN>(acc, sw128_desc(as + kk), sw128_desc(bs + kk));
        wgmma_commit();
        // the previous k-tile's products are done: this warp releases its stage
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[s == 0 ? STAGES - 1 : s - 1]);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      if (KT > 0 && lane == 0) mbar_arrive(&empty[s == 0 ? STAGES - 1 : s - 1]);
      wg_bar(1 + wg);  // sbs is written
      store_tile<BN, TO>(acc, sbs, sa, C, M, N, m0 + wg * 64 + wi * 16, n0, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the epilogue alone, on a summed int32 accumulator
// ---------------------------------------------------------------------------

constexpr int EPI_THREADS = 256;

// Thread t of the grid-stride loop takes columns 4j .. 4j+3 of one row
// (vec: N % 4 == 0 and acc 16-byte aligned, so they are one int4 load);
// otherwise one element a step.
template <typename TO>
__global__ void __launch_bounds__(EPI_THREADS)
int8_epilogue_kernel(const int* __restrict__ acc, const float* __restrict__ sa,
                     const float* __restrict__ sb, TO* __restrict__ C, int M, int N, int vec) {
  const size_t stride = (size_t)gridDim.x * EPI_THREADS;
  const size_t t0 = (size_t)blockIdx.x * EPI_THREADS + threadIdx.x;
  if (vec) {
    const size_t n4 = (size_t)M * (N / 4);
    for (size_t t = t0; t < n4; t += stride) {
      const size_t e = t * 4;
      const int m = static_cast<int>(e / N), n = static_cast<int>(e % N);
      const int4 a = *reinterpret_cast<const int4*>(acc + e);
      const float s = sa[m];
      C[e] = from_f<TO>(dequant_f(a.x, s, sb[n]));
      C[e + 1] = from_f<TO>(dequant_f(a.y, s, sb[n + 1]));
      C[e + 2] = from_f<TO>(dequant_f(a.z, s, sb[n + 2]));
      C[e + 3] = from_f<TO>(dequant_f(a.w, s, sb[n + 3]));
    }
  } else {
    const size_t total = (size_t)M * N;
    for (size_t e = t0; e < total; e += stride) {
      const int m = static_cast<int>(e / N), n = static_cast<int>(e % N);
      C[e] = from_f<TO>(dequant_f(acc[e], sa[m], sb[n]));
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, K] int8, K contiguous, in boxes of box_rows x 128 bytes, 128-byte
// swizzle, zeros outside the tensor
bool make_map(CUtensorMap* map, const int8_t* ptr, int rows, int K, int box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(I8_BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int STAGES, typename TO>
int launch_wgmma(const int8_t* A, const int8_t* B, const float* sa, const float* sb, TO* C,
                 int M, int N, int K, int sms, cudaStream_t stream) {
  CUtensorMap ma, mb;
  if (!make_map(&ma, A, M, K, WG_BM) || !make_map(&mb, B, N, K, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      1024 + (size_t)STAGES * (WG_BM + BN) * I8_BK + 2 * STAGES * 8 + 2 * BN * sizeof(float);
  auto kern = gemm_int8_wgmma_kernel<BN, STAGES, TO>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int mt, tiles, grid;
  ix::walk_grid(M, N, WG_BM, BN, sms, mt, tiles, grid);
  kern<<<grid, WG_THREADS, smem, stream>>>(ma, mb, sa, sb, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int WM, int WN, int STAGES, bool HINT, typename TO>
int launch_mma(const int8_t* A, const int8_t* B, const float* sa, const float* sb, TO* C,
               int M, int N, int K, int splits, cudaStream_t stream) {
  const int vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(A) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  const size_t smem = (size_t)STAGES * (BM + BN) * (I8_BK + 16);
  auto kern = gemm_int8_kernel<BM, BN, WM, WN, STAGES, HINT, TO>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // kc: ceil(K / splits) rounded up to 32 -- a function of (K, splits)
  const int kc = ix::split_chunk(K, splits, 32);
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
  err = cudaLaunchKernelEx(&cfg, kern, A, B, sa, sb, C, M, N, K, vec, splits, kc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// route: 0 mma.sync, 16-row tiles (16 x 32 unsplit); 1 mma.sync, 64-row tiles;
// 2 wgmma, BN 128; 3 wgmma, BN 256 (block_gemm.int8_route)
template <typename TO>
int launch_int8(const int8_t* A, const int8_t* B, const float* sa, const float* sb, TO* C,
                int M, int N, int K, int route, int splits, int sms, cudaStream_t stream) {
  if (splits < 1 || splits > 8 || route < 0 || route > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  int bm, bn;  // the route's tile, from index.cuh (the bounds proofs read the same)
  ix::int8_tile(route, splits, bm, bn);
  if (bm == 16 && bn == 32)
    return launch_mma<16, 32, 16, 8, 4, false, TO>(A, B, sa, sb, C, M, N, K, 1, stream);
  if (bm == 16)
    return launch_mma<16, 128, 16, 32, 4, true, TO>(A, B, sa, sb, C, M, N, K, splits, stream);
  if (bm == 64)
    return launch_mma<64, 128, 32, 32, 3, true, TO>(A, B, sa, sb, C, M, N, K, splits, stream);
  if (bn == 128) return launch_wgmma<128, 6, TO>(A, B, sa, sb, C, M, N, K, sms, stream);
  return launch_wgmma<256, 4, TO>(A, B, sa, sb, C, M, N, K, sms, stream);
}

}  // namespace repro

// a [M,K] int8; b [N,K] int8; a_scale [M] f32; b_scale [N] f32; c [M,N] f32
// or, out_bf16, bf16.  route and splits as block_gemm.int8_route /
// int8_splits give them (the wgmma routes need K % 16 == 0 and 16-byte
// aligned bases; splits only for routes 0 and 1); sms: the SM count, the
// persistent kernel's grid.  Returns the launch's error, else
// cudaGetLastError() after it.
extern "C" int repro_block_gemm_int8(const void* a, const void* b, const void* a_scale,
                                     const void* b_scale, void* c, int M, int N, int K,
                                     int out_bf16, int route, int splits, int sms,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  if (out_bf16)
    return repro::launch_int8<__nv_bfloat16>(A, B, sa, sb, static_cast<__nv_bfloat16*>(c), M,
                                             N, K, route, splits, sms, s);
  return repro::launch_int8<float>(A, B, sa, sb, static_cast<float*>(c), M, N, K, route,
                                   splits, sms, s);
}

// a [M,K] int8; b [N,K] int8; acc [M,N] int32: the raw sums over k, no
// epilogue.  route, splits and sms as repro_block_gemm_int8's.
extern "C" int repro_block_gemm_int8_acc(const void* a, const void* b, void* acc, int M, int N,
                                         int K, int route, int splits, int sms, void* stream) {
  return repro::launch_int8<int>(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                                 nullptr, nullptr, static_cast<int*>(acc), M, N, K, route,
                                 splits, sms, static_cast<cudaStream_t>(stream));
}

// acc [M,N] int32; a_scale [M] f32; b_scale [N] f32; c [M,N] f32 or, out_bf16,
// bf16: c = (float(acc) * a_scale[m]) * b_scale[n], cast once.  sms sizes the
// grid (8 blocks an SM at most).
extern "C" int repro_int8_epilogue(const void* acc, const void* a_scale, const void* b_scale,
                                   void* c, int M, int N, int out_bf16, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* A = static_cast<const int*>(acc);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  const size_t work = vec ? (size_t)M * (N / 4) : (size_t)M * N;
  size_t blocks = (work + repro::EPI_THREADS - 1) / repro::EPI_THREADS;
  if (blocks > (size_t)sms * 8) blocks = (size_t)sms * 8;
  if (blocks == 0) return 0;
  if (out_bf16)
    repro::int8_epilogue_kernel<__nv_bfloat16><<<(unsigned)blocks, repro::EPI_THREADS, 0, s>>>(
        A, sa, sb, static_cast<__nv_bfloat16*>(c), M, N, vec);
  else
    repro::int8_epilogue_kernel<float><<<(unsigned)blocks, repro::EPI_THREADS, 0, s>>>(
        A, sa, sb, static_cast<float*>(c), M, N, vec);
  return static_cast<int>(cudaGetLastError());
}
