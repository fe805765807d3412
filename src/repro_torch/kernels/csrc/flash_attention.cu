// Flash attention for Hopper (sm_90a), in two kernels: paged chunk
// prefill (a query chunk at absolute positions q_start + i attending
// causally over logical rows [0, k_len) of page pools) and dense attention
// (whole-prompt prefill and the training forward; see the second part of
// this file).
//
// Replaces: src/repro/kernels/flash_attention.py, _fa_kernel_paged (wrapper
// _flash_attention_paged), and _fa_kernel (wrapper flash_attention).
//
// What bounds it on an H100: at the serving shapes (a 64-row chunk over a
// past of a few hundred rows, d = 128) the 4*C*k_len*d operations per head
// and the bytes of the live KV rows are both small; the kernel is bound by
// latency and by reading K and V once per 8-row query tile.  The design
// reads only the pages that are live under _paged_block_live
// (flash_attention.py:28): page ik is visited iff ik*ps < k_len and
// ik*ps <= q_start + last row of the tile, so pages past the valid rows or
// past the tile's causal horizon cost neither bytes nor operations.  Each
// page is staged through shared memory in 32-row sub-tiles (rows padded by
// one float so the column reads are conflict-free), and the tile's Q rows
// stay in shared memory for the whole walk.
//
// Grid: one block per (q-tile, head, slot); the block loops over its live
// pages in order with an f32 online softmax.  Masks: absolute-position
// causal (kpos <= qpos), sliding window (kpos > qpos - window) and
// kpos < k_len; softcap.  A row with every key masked writes 0.  Query rows
// at i >= chunk length are the caller's padding: computed, never used.
// GQA maps head h to kv-head h / (H/K) -- no KV broadcast in memory.
#include "common.cuh"

namespace repro {

constexpr int FA_BQ = 8;    // query rows per block (small: more blocks in flight)
constexpr int FA_KT = 32;   // key rows per shared-memory sub-tile (one per lane)
constexpr int FA_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const int* __restrict__ pages,
                             const int* __restrict__ q_start, const int* __restrict__ k_len,
                             T* __restrict__ out, int H, int Kh, int C, int d, int ps,
                             int npp, int window, float scale, float softcap) {
  extern __shared__ float smem[];
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh, kh = h / G;
  const int dp = d + 1;
  float* q_s = smem;                 // [BQ][d]
  float* k_s = q_s + FA_BQ * d;      // [KT][d+1]
  float* v_s = k_s + FA_KT * dp;     // [KT][d+1]
  float* s_s = v_s + FA_KT * dp;     // [BQ][KT] scores, then P
  float* acc = s_s + FA_BQ * FA_KT;  // [BQ][d]
  float* m_s = acc + FA_BQ * d;      // [BQ]
  float* l_s = m_s + FA_BQ;          // [BQ]
  float* a_s = l_s + FA_BQ;          // [BQ]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = FA_THREADS / 32;
  const int i0 = iq * FA_BQ;
  const int qs = q_start[b], kl = k_len[b];

  const T* qb = q + (((size_t)b * H + h) * C + i0) * d;
  for (int e = tid; e < FA_BQ * d; e += FA_THREADS) {
    q_s[e] = (i0 + e / d < C) ? to_f(qb[e]) : 0.f;
    acc[e] = 0.f;
  }
  for (int i = tid; i < FA_BQ; i += FA_THREADS) {
    m_s[i] = NEG;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int horizon = qs + i0 + FA_BQ - 1;  // last query position of the tile
  const int hi = (kl <= 0) ? -1 : min(min((kl - 1) / ps, horizon / ps), npp - 1);
  for (int ik = 0; ik <= hi; ++ik) {
    const size_t row0 = (size_t)pages[(size_t)b * npp + ik] * ps;
    for (int j0 = 0; j0 < ps; j0 += FA_KT) {
      const int jn = min(FA_KT, ps - j0);
#pragma unroll 8  // keep several row loads in flight per thread
      for (int e = tid; e < FA_KT * d; e += FA_THREADS) {
        const int j = e / d, c = e % d;
        float kv = 0.f, vv = 0.f;
        if (j < jn) {
          const size_t off = ((row0 + j0 + j) * Kh + kh) * (size_t)d + c;
          kv = to_f(k[off]);
          vv = to_f(v[off]);
        }
        k_s[j * dp + c] = kv;
        v_s[j * dp + c] = vv;
      }
      __syncthreads();
      for (int e = tid; e < FA_BQ * FA_KT; e += FA_THREADS) {
        const int i = e / FA_KT, j = e % FA_KT;
        const int qpos = qs + i0 + i, kpos = ik * ps + j0 + j;
        bool valid = (j < jn) && (kpos < kl) && (kpos <= qpos);
        if (window > 0) valid = valid && (kpos > qpos - window);
        float s = NEG;
        if (valid) {
          float dot = 0.f;
          for (int c = 0; c < d; ++c) dot = fmaf(q_s[i * d + c], k_s[j * dp + c], dot);
          s = dot * scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        }
        s_s[e] = s;
      }
      __syncthreads();
      for (int i = warp; i < FA_BQ; i += NW) {
        const float x = (lane < FA_KT) ? s_s[i * FA_KT + lane] : NEG;
        const float m_prev = m_s[i];
        const float m_new = fmaxf(m_prev, warp_max(x));
        const bool live = m_new > NEG * 0.5f;  // no valid key yet: P stays 0
        const float p = (lane < FA_KT && live) ? expf(x - m_new) : 0.f;
        const float sum = warp_sum(p);
        if (lane < FA_KT) s_s[i * FA_KT + lane] = round_to<T>(p);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[i] = alpha;
          l_s[i] = l_s[i] * alpha + sum;
          m_s[i] = m_new;
        }
      }
      __syncthreads();
      for (int e = tid; e < FA_BQ * d; e += FA_THREADS) {
        const int i = e / d, c = e % d;
        float a = acc[e] * a_s[i];
#pragma unroll 4
        for (int j = 0; j < jn; ++j) a = fmaf(s_s[i * FA_KT + j], v_s[j * dp + c], a);
        acc[e] = a;
      }
      __syncthreads();
    }
  }

  T* ob = out + (((size_t)b * H + h) * C + i0) * d;
  for (int e = tid; e < FA_BQ * d; e += FA_THREADS) {
    const int i = e / d;
    if (i0 + i < C) ob[e] = from_f<T>(acc[e] / fmaxf(l_s[i], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pages, const int* q_start,
           const int* k_len, void* out, int B, int H, int Kh, int C, int d, int ps, int npp,
           int window, float scale, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * FA_BQ * d + 2 * FA_KT * (d + 1) + FA_BQ * FA_KT + 3 * FA_BQ);
  auto kern = flash_attention_paged_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((C + FA_BQ - 1) / FA_BQ, H, B);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pages,
      q_start, k_len, static_cast<T*>(out), H, Kh, C, d, ps, npp, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// q [B,H,C,d]; k/v pools [P,ps,Kh,d]; pages [B,npp]; q_start, k_len [B];
// out [B,H,C,d].  window <= 0 and softcap <= 0 are off.
extern "C" int repro_flash_attention_paged(const void* q, const void* k, const void* v,
                                           const void* pages, const void* q_start,
                                           const void* k_len, void* out, int B, int H,
                                           int Kh, int C, int d, int ps, int npp,
                                           int window, float scale, float softcap,
                                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pg = static_cast<const int*>(pages);
  const int* qs = static_cast<const int*>(q_start);
  const int* kl = static_cast<const int*>(k_len);
  if (is_bf16)
    return repro::launch<__nv_bfloat16>(q, k, v, pg, qs, kl, out, B, H, Kh, C, d, ps, npp,
                                        window, scale, softcap, s);
  return repro::launch<float>(q, k, v, pg, qs, kl, out, B, H, Kh, C, d, ps, npp, window,
                              scale, softcap, s);
}

// ---------------------------------------------------------------------------
// Dense flash attention: q [B,H,Sq,d] against k/v [B,K,Sk,d], any strides
// with unit stride along d.
//
// Replaces: src/repro/kernels/flash_attention.py, _fa_kernel (wrapper
// flash_attention).  Masks as there: query row i sits at position
// qpos = i + (Sk - Sq) (the last query aligned with the last key; Sq < Sk
// continues a cached prefix), key kpos is valid iff kpos < Sk, and
// kpos <= qpos when causal, and kpos > qpos - window when windowed; softcap
// before the mask.  A row with every key masked writes exact 0.  GQA maps
// head h to kv-head h / (H/K): no KV broadcast in memory.  Strides are read,
// not assumed, so the layers hand over transposed views of their
// [B, S, H, d] tensors with no copy, and the output is written into a
// [B, Sq, H, d] buffer.
//
// What bounds it on an H100: operations.  At prefill (Sq = Sk = thousands,
// d = 256) each (q-tile, head) does 4*BQ*keys*d operations on BQ*d + 2*keys*d
// inputs, far above the card's operations-per-byte balance.  Two kernels,
// by dtype:
//
// bf16 (the serving and edge path): tensor cores.  A block owns 64 query
// rows of one head, four warps of 16 rows each.  Q stays bf16 in shared
// memory; K/V tiles of KT rows (64, or 32 at d > 128) come through a 2-stage
// cp.async ring, so tile t+1 loads while tile t computes, with one barrier
// per tile.  Each warp runs QK^T and PV as mma.sync m16n8k16 (bf16 in, f32
// accumulate), Q and K fragments by ldmatrix, V by ldmatrix.trans; S, the
// running max and the running sum stay in registers (max over the quad of
// lanes that share a row), and the S accumulator is repacked in registers
// as the A fragment of PV.  The softmax runs in base 2 (scores times log2 e,
// ex2.approx), P is rounded to bf16 before PV while the sum takes the
// unrounded P (as _fa_kernel's p.astype(v.dtype)), the rescale of O is
// skipped once the running max stops moving, and the output is
// O / max(l, 1e-30).  Only key tiles live under the causal and window masks
// are loaded; a warp skips a tile where all its 16 rows are masked, and
// masks per element only on tiles that cross the diagonal, the window edge
// or Sk.  Blocks are numbered heaviest causal query tile first, with the
// heads of one kv-head adjacent so their K/V reads meet in L2.  d is padded
// to D in {16, ..., 256} with zero columns; shared rows are padded by 16
// bytes, so the 8 rows of every ldmatrix fall in distinct banks.
//   What holds it back: at d = 256 the O accumulator alone is 128 registers
// a thread, so a warp runs at ~245 registers and two blocks (8 warps) fit
// an SM; with two warps per scheduler, the softmax between the two products
// and the ldmatrix -> mma chains are not hidden.  Measured alternatives
// that were slower on an H100 at d = 256: 16-row key tiles (3 or 4
// stages), 64-row tiles (one block an SM), a 3-stage ring, single-buffered
// K and V with split waits, pairs of warps splitting each row group's
// keys and columns (16 warps an SM, 128 registers, spills), and two blocks
// of a cluster splitting a query tile's keys with a merge over distributed
// shared memory (the causal tail is not what holds it back).  Registers,
// spills and shared memory per block: DENSE_TC_RESOURCES below.
//
// f32 (reduced configs, parity checks): CUDA cores, full f32, never TF32.  A
// block owns 64 query rows, keeps them in shared memory for its walk over
// 32-row K/V tiles, and computes each thread's 2 x 4 scores and
// 4 x ceil(d/16) outputs from registers, over the same live tiles.
// ---------------------------------------------------------------------------
namespace repro {

constexpr int FAD_BQ = 64;       // query rows per block
constexpr int FAD_KT = 32;       // key rows per tile (one per lane in the softmax)
constexpr int FAD_THREADS = 256;

struct Strides3 {
  long long b, h, s;  // elements; the d stride is 1
};

template <typename T, int CH>  // CH = ceil(d / 16): output columns per thread
__global__ void __launch_bounds__(FAD_THREADS)
flash_attention_dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, Strides3 qs,
                             Strides3 ks, Strides3 vs, Strides3 os, int H, int Kh, int Sq,
                             int Sk, int d, int causal, int window, float scale,
                             float softcap) {
  extern __shared__ float smem[];
  constexpr int BQ = FAD_BQ, KT = FAD_KT, NW = FAD_THREADS / 32, SP = KT + 1;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int dp = d + 1;
  float* q_s = smem;           // [BQ][d+1]
  float* k_s = q_s + BQ * dp;  // [KT][d+1]
  float* v_s = k_s + KT * dp;  // [KT][d]
  float* s_s = v_s + KT * d;   // [BQ][KT+1] scores, then P
  float* m_s = s_s + BQ * SP;  // [BQ] running max
  float* l_s = m_s + BQ;       // [BQ] running denominator
  float* a_s = l_s + BQ;       // [BQ] this tile's rescale factor
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = iq * BQ, off = Sk - Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int e = tid; e < BQ * d; e += FAD_THREADS) {
    const int i = e / d, c = e % d;
    q_s[i * dp + c] = (q0 + i < Sq) ? to_f(qb[(q0 + i) * qs.s + c]) : 0.f;
  }
  for (int i = tid; i < BQ; i += FAD_THREADS) {
    m_s[i] = NEG;
    l_s[i] = 0.f;
  }
  // scores: rows sr + 32 r (r < 2), keys sk + 8 u (u < 4)
  const int sk = tid % 8, sr = tid / 8;
  // P.V: rows pr * 4 + r (r < 4), columns pc + 16 t (t < CH)
  const int pc = tid % 16, pr = tid / 16;
  float acc[4][CH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int t = 0; t < CH; ++t) acc[r][t] = 0.f;

  // live keys of the tile: [key_lo, key_hi]; none live -> the rows stay 0
  const int qlo = q0 + off, qhi = min(q0 + BQ, Sq) - 1 + off;
  const int key_hi = causal ? min(Sk - 1, qhi) : Sk - 1;
  const int key_lo = window > 0 ? max(0, qlo - window + 1) : 0;
  __syncthreads();
  for (int t0 = key_hi >= key_lo ? (key_lo / KT) * KT : Sk; t0 <= key_hi; t0 += KT) {
    for (int e = tid; e < KT * d; e += FAD_THREADS) {
      const int j = e / d, c = e % d;
      const bool ok = t0 + j < Sk;
      k_s[j * dp + c] = ok ? to_f(kb[(t0 + j) * ks.s + c]) : 0.f;
      v_s[j * d + c] = ok ? to_f(vb[(t0 + j) * vs.s + c]) : 0.f;
    }
    __syncthreads();
    float sc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[r][u] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[2], kk[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) qa[r] = q_s[(sr + 32 * r) * dp + c];
#pragma unroll
      for (int u = 0; u < 4; ++u) kk[u] = k_s[(sk + 8 * u) * dp + c];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[r][u] = fmaf(qa[r], kk[u], sc[r][u]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = sr + 32 * r, j = sk + 8 * u;
        const int qpos = q0 + i + off, kpos = t0 + j;
        bool valid = kpos < Sk;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        float x = sc[r][u] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s_s[i * SP + j] = valid ? x : NEG;
      }
    __syncthreads();
    for (int i = warp; i < BQ; i += NW) {
      const float x = s_s[i * SP + lane];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const bool live = m_new > NEG * 0.5f;  // no valid key yet: P stays 0
      const float p = live ? expf(x - m_new) : 0.f;
      const float sum = warp_sum(p);
      s_s[i * SP + lane] = round_to<T>(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float al = a_s[pr * 4 + r];
#pragma unroll
      for (int t = 0; t < CH; ++t) acc[r][t] *= al;
    }
    for (int j = 0; j < KT; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = s_s[(pr * 4 + r) * SP + j];
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int c = pc + 16 * t;
        const float vv = (c < d) ? v_s[j * d + c] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][t] = fmaf(p[r], vv, acc[r][t]);
      }
    }
    __syncthreads();
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = pr * 4 + r;
    if (q0 + i >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l_s[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      const int c = pc + 16 * t;
      if (c < d) ob[(q0 + i) * os.s + c] = from_f<T>(acc[r][t] * inv_l);
    }
  }
}

template <typename T, int CH>
int launch_dense(const void* q, const void* k, const void* v, void* out, Strides3 qs,
                 Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq, int Sk,
                 int d, int causal, int window, float scale, float softcap,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(FAD_BQ + FAD_KT) * (d + 1) +
                                       (size_t)FAD_KT * d + FAD_BQ * (FAD_KT + 1) +
                                       3 * FAD_BQ);
  auto kern = flash_attention_dense_kernel<T, CH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + FAD_BQ - 1) / FAD_BQ, H, B);
  kern<<<grid, FAD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), qs, ks, vs, os, H, Kh, Sq, Sk, d, causal, window, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dense(const void* q, const void* k, const void* v, void* out, Strides3 qs,
                   Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                   int Sk, int d, int causal, int window, float scale, float softcap,
                   cudaStream_t s) {
#define REPRO_FAD(CH)                                                                   \
  return launch_dense<T, CH>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d, causal, \
                             window, scale, softcap, s)
  if (d <= 16) REPRO_FAD(1);
  if (d <= 32) REPRO_FAD(2);
  if (d <= 64) REPRO_FAD(4);
  if (d <= 128) REPRO_FAD(8);
  if (d <= 256) REPRO_FAD(16);
#undef REPRO_FAD
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- bf16 on tensor cores ----------------------------------------------------
// DENSE_TC_RESOURCES (nvcc -Xptxas -v, sm_90a; registers a thread / spill
// bytes / dynamic shared memory a block, fat_smem): D = 256 (KT 32): 246 /
// 0 / 101,376; D = 128 (KT 64): 180 / 0 / 87,040; D = 64: 137 / 0 / 46,080;
// D = 32: 127 / 0 / 25,600; D = 16: 115 / 0 / 15,360.
constexpr int FAT_BQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int FAT_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit, subnormal results flushed to 0: P and
// the rescale factors lie in [0, 1], where a flushed 2^-126 is below any
// bf16 rounding of the row
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int FAT_ST = 2;  // stages of the K/V ring

__host__ __device__ constexpr int fat_kt(int D) { return D > 128 ? 32 : 64; }  // K/V tile rows

// shared memory of a block in bytes: Q and the ring of K and V tiles, bf16,
// rows of D + 8
__host__ __device__ constexpr int fat_smem(int D) {
  return 2 * (FAT_BQ + 2 * FAT_ST * fat_kt(D)) * (D + 8);
}

template <int D>  // d padded to D (a power of two, 16..256)
__global__ void __launch_bounds__(FAT_THREADS)
flash_attention_dense_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ out, Strides3 qs, Strides3 ks,
                                Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                                int Sk, int d, int causal, int window, float scale,
                                float softcap, int vec) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = FAT_BQ, KT = fat_kt(D), ST = FAT_ST, RS = D + 8;  // RS: shared row stride
  extern __shared__ __align__(16) unsigned char fat_smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(fat_smem_raw);  // [BQ][RS]
  bf16* kv_s = q_s + BQ * RS;                         // [ST stages][K, V][KT][RS]

  // heaviest causal query tile first; the heads of one kv-head side by side
  const int nq = (Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int bh = blockIdx.x % (B * H), h = bh % H, b = bh / H;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int q0 = iq * BQ, off = Sk - Sq;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;

  // rows [row0, row0 + rows) of a [n, d] matrix with row stride rs into a
  // [rows][RS] shared tile; rows >= n and columns >= d are zero
  auto copy_tile = [&](bf16* dst, const bf16* src, long long rs, int row0, int n, int rows) {
    if (vec) {
      constexpr int CH = D / 8;
      for (int e = tid; e < rows * CH; e += FAT_THREADS) {
        const int r = e / CH, col = (e % CH) * 8;
        const bool ok = row0 + r < n && col < d;
        cp_async16(dst + r * RS + col, ok ? src + (row0 + r) * rs + col : src, ok);
      }
    } else {
      for (int e = tid; e < rows * D; e += FAT_THREADS) {
        const int r = e / D, col = e % D;
        const bool ok = row0 + r < n && col < d;
        dst[r * RS + col] = ok ? src[(row0 + r) * rs + col] : __float2bfloat16(0.f);
      }
    }
  };

  // key tiles live for some row of the block: [t_first, t_first + ntiles)
  const int qlo = q0 + off, qhi = min(q0 + BQ, Sq) - 1 + off;
  const int key_hi = causal ? min(Sk - 1, qhi) : Sk - 1;
  const int key_lo = window > 0 ? max(0, qlo - window + 1) : 0;
  const int t_first = key_lo / KT;
  const int ntiles = key_hi >= key_lo ? key_hi / KT - t_first + 1 : 0;
  auto load_kv = [&](int t) {  // tile t into stage t % ST
    bf16* ks_ = kv_s + (t % ST) * 2 * KT * RS;
    copy_tile(ks_, kb, ks.s, (t_first + t) * KT, Sk, KT);
    copy_tile(ks_ + KT * RS, vb, vs.s, (t_first + t) * KT, Sk, KT);
  };
  // groups: {Q, tile 0}, {tile 1}, ..., {tile ST-2}, then one per iteration
  copy_tile(q_s, qb, qs.s, q0, Sq, BQ);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m[2] = {NEG, NEG};  // running max of rows g, g + 8 (base-2 units)
  float l[2] = {0.f, 0.f};  // this thread's share of the running sums
  const int wlo = q0 + warp * 16 + off, whi = wlo + 15;  // the warp's positions
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<ST - 2>();  // tile t (and Q) landed
    __syncthreads();          // ... for every warp; stage (t-1) % ST is free
    if (t + ST - 1 < ntiles) load_kv(t + ST - 1);
    cp_async_commit();
    const bf16* k_s = kv_s + (t % ST) * 2 * KT * RS;
    const bf16* v_s = k_s + KT * RS;
    const int t0 = (t_first + t) * KT;
    const bool dead = (causal && t0 > whi) || (window > 0 && t0 + KT - 1 <= wlo - window);
    if (dead) continue;  // warp-uniform
    const bool edge = t0 + KT > Sk || (causal && t0 + KT - 1 > wlo) ||
                      (window > 0 && t0 <= whi - window);
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < KT / 16; ++nj) {
        uint32_t bb[4];
        ldmatrix_x4(bb, k_s + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nj], a, bb);
        mma_bf16(s[2 * nj + 1], a, bb + 2);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = softcap > 0.f ? tanhf(s[j][r] * scale / softcap) * softcap * LOG2E
                                : s[j][r] * sl2;
        if (edge) {
          const int qp = wlo + g + (r >= 2 ? 8 : 0), kp = t0 + 8 * j + 2 * c + (r & 1);
          bool ok = kp < Sk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) x = NEG;
        }
        s[j][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    float alpha[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2_ftz(m[i] - mx[i]);
      live[i] = mx[i] > NEG * 0.5f;  // no valid key yet: P stays 0
      m[i] = mx[i];
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = live[r >> 1] ? exp2_ftz(s[j][r] - mx[r >> 1]) : 0.f;
        s[j][r] = p;
        rsum[r >> 1] += p;
      }
    l[0] = l[0] * alpha[0] + rsum[0];
    l[1] = l[1] * alpha[1] + rsum[1];
    // once the running max settles every alpha is 1: skip the rescale
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // the S accumulators of key tiles 2kk, 2kk+1 are the A fragment of PV
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                  dn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dn], pa, bb);
        mma_bf16(o[2 * dn + 1], pa, bb + 2);
      }
    }
  }
  cp_async_wait<0>();

  bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Sq) continue;
    const float inv_l = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < d) ob[row * os.s + col] = __float2bfloat16(o[j][2 * i] * inv_l);
      if (col + 1 < d) ob[row * os.s + col + 1] = __float2bfloat16(o[j][2 * i + 1] * inv_l);
    }
  }
}

template <int D>
int launch_dense_tc(const void* q, const void* k, const void* v, void* out, Strides3 qs,
                    Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                    int Sk, int d, int causal, int window, float scale, float softcap,
                    cudaStream_t stream) {
  // 16-byte cp.async needs 16-byte aligned rows: d, every stride and every
  // base a multiple of 8 elements
  auto rows16 = [](const void* p, const Strides3& st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 && st.h % 8 == 0 &&
           st.s % 8 == 0;
  };
  const bool vec = d % 8 == 0 && rows16(q, qs) && rows16(k, ks) && rows16(v, vs);
  constexpr int smem = fat_smem(D);
  auto kern = flash_attention_dense_tc_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)((Sq + FAT_BQ - 1) / FAT_BQ) * B * H;
  kern<<<blocks, FAT_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), qs, ks, vs,
      os, B, H, Kh, Sq, Sk, d, causal, window, scale, softcap, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dense_tc(const void* q, const void* k, const void* v, void* out, Strides3 qs,
                      Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                      int Sk, int d, int causal, int window, float scale, float softcap,
                      cudaStream_t s) {
#define REPRO_FAT(D)                                                                    \
  return launch_dense_tc<D>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d, causal, \
                            window, scale, softcap, s)
  if (d <= 16) REPRO_FAT(16);
  if (d <= 32) REPRO_FAT(32);
  if (d <= 64) REPRO_FAT(64);
  if (d <= 128) REPRO_FAT(128);
  if (d <= 256) REPRO_FAT(256);
#undef REPRO_FAT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro

// q [B,H,Sq,d], k/v [B,Kh,Sk,d], out [B,H,Sq,d], each given by base pointer
// and (batch, head, row) strides in elements with unit stride along d.
// window <= 0 and softcap <= 0 are off.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     const long long* strides, int B, int H, int Kh, int Sq,
                                     int Sk, int d, int causal, int window, float scale,
                                     float softcap, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Strides3 qs{strides[0], strides[1], strides[2]};
  const repro::Strides3 ks{strides[3], strides[4], strides[5]};
  const repro::Strides3 vs{strides[6], strides[7], strides[8]};
  const repro::Strides3 os{strides[9], strides[10], strides[11]};
  if (is_bf16)
    return repro::dispatch_dense_tc(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d,
                                    causal, window, scale, softcap, s);
  return repro::dispatch_dense<float>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d,
                                      causal, window, scale, softcap, s);
}
