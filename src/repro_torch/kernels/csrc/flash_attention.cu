// Paged chunk-prefill attention for Hopper (sm_90a): a query chunk at
// absolute positions q_start + i attending causally over logical rows
// [0, k_len) of page pools.
//
// Replaces: src/repro/kernels/flash_attention.py, _fa_kernel_paged (wrapper
// _flash_attention_paged).
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
