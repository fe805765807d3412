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
// head h to kv-head h / (H/K): no KV broadcast in memory.
//
// What bounds it on an H100: operations.  At prefill (Sq = Sk = thousands,
// d = 256) each (q-tile, head) does 4*BQ*keys*d operations on BQ*d + 2*keys*d
// inputs, far above the card's operations-per-byte balance.  This first
// design runs on the CUDA cores in f32 (the tensor-core version is later
// work): a block owns 64 query rows of one head, keeps them in shared
// memory for its whole walk over 32-row K/V tiles, computes each thread's
// 2 x 4 scores and 4 x ceil(d/16) outputs from registers, and visits only
// the key tiles that the causal and window masks leave live (the dead tiles
// of the TPU grid are never loaded).  Strides are read, not assumed, so
// the layers hand over transposed views of their [B, S, H, d] tensors with
// no copy, and the output is written into a [B, Sq, H, d] buffer.
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
    return repro::dispatch_dense<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq,
                                                Sk, d, causal, window, scale, softcap, s);
  return repro::dispatch_dense<float>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d,
                                      causal, window, scale, softcap, s);
}
