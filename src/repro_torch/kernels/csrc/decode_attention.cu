// Flash-decode for Hopper (sm_90a): one query token per slot, over page
// pools (first part of this file) or over a slot cache [B, S, K, d] in its
// linear or ring layout (second part).
//
// Replaces: src/repro/kernels/decode_attention.py, _fd_kernel_paged
// (wrapper _flash_decode_paged) and _fd_kernel (wrapper flash_decode).
//
// What bounds it on an H100: bytes.  Each (slot, kv-head) reads its live KV
// rows once and does 4*G*d operations per row (G query heads share a row),
// orders of magnitude below the card's operations-per-byte balance.  The
// design reads only the pages that overlap the live rows [start, pos] -- the
// page index clipped to npp-1 as the Pallas index map clips it, so a frozen
// full slot (pos == npp*ps) never reads past its table -- each K row is read
// by one warp as a contiguous d-vector, eight rows' loads in flight before
// any sum, and the block's eight warps walk different pages at once.
//
// Grid: one block per (kv-head, slot).  Warp w takes pages lo+w, lo+w+8, ...
// with its own f32 online softmax (the running max / denominator / PV
// accumulator that the TPU kept in VMEM scratch across grid steps live in
// shared memory here); the eight partials are merged in warp order at the
// end.  All G = H/K query heads of the kv-head are handled by the block, so
// GQA reads each KV row once; the TPU's pad of G to 8 sublanes is dropped.
// A slot with start > pos (an empty or drained slot) writes exact zeros.
// Softcap and dv narrowing (v may alias k, MLA-style) are supported.  The
// split of pages over warps and every sum's order depend on nothing but the
// slot's own rows: no atomics, nothing chosen by the batch.
#include "common.cuh"

namespace repro {

constexpr int FD_THREADS = 256;
constexpr int FD_WARPS = FD_THREADS / 32;
constexpr int FD_ROWS = 8;  // K rows a warp loads before reducing

// CH = ceil(max(dq, dv) / 32) rounded up to a power of two: the q/k/v
// columns each lane holds (c = lane + 32 * t).
template <typename T, int CH>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ pages,
                          const int* __restrict__ pos, const int* __restrict__ start,
                          T* __restrict__ out, int H, int Kh, int dq, int dv, int v_row,
                          int ps, int npp, float scale, float softcap) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / Kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wsz = G * (ps + dv + 2);  // one warp's partial: P, acc, m, l
  float* q_s = smem;                  // [G][dq]
  auto part = [&](int w) { return q_s + G * dq + w * wsz; };
  float* s_w = part(warp);            // [G][ps] scores, then P
  float* acc = s_w + G * ps;          // [G][dv] (lane-private columns)
  float* m_w = acc + G * dv;          // [G] running max
  float* l_w = m_w + G;               // [G] running denominator

  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * dq;
  for (int e = tid; e < G * dq; e += FD_THREADS) q_s[e] = to_f(qb[e]);
  for (int e = lane; e < G * dv; e += 32) acc[e] = 0.f;
  for (int g = lane; g < G; g += 32) {
    m_w[g] = NEG;
    l_w[g] = 0.f;
  }
  __syncthreads();

  const int p_b = pos[b], s_b = start[b];
  const int lo = s_b / ps;
  const int hi = (s_b > p_b) ? lo - 1 : min(p_b / ps, npp - 1);
  const size_t vstride = (size_t)Kh * v_row;
  // warp w walks pages lo + w, lo + w + FD_WARPS, ... with its own online
  // softmax; the partials are merged in warp order at the end
  for (int ik = lo + warp; ik <= hi; ik += FD_WARPS) {
    const size_t row0 = (size_t)pages[(size_t)b * npp + ik] * ps;
    for (int jb = 0; jb < ps; jb += FD_ROWS) {
      float kr[FD_ROWS][CH];  // all loads of FD_ROWS rows issued before any sum
#pragma unroll
      for (int u = 0; u < FD_ROWS; ++u) {
        const int j = jb + u;
        const T* kp = k + ((row0 + (j < ps ? j : 0)) * Kh + kh) * (size_t)dq;
#pragma unroll
        for (int t = 0; t < CH; ++t) {
          const int c = lane + 32 * t;
          kr[u][t] = (j < ps && c < dq) ? to_f(kp[c]) : 0.f;
        }
      }
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int u = 0; u < FD_ROWS; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int t = 0; t < CH; ++t) {
            const int c = lane + 32 * t;
            if (c < dq) dot = fmaf(q_s[g * dq + c], kr[u][t], dot);
          }
          dot = warp_sum(dot);
          const int j = jb + u, r = ik * ps + j;
          if (lane == 0 && j < ps) {
            float sc = dot * scale;
            if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
            s_w[g * ps + j] = (r >= s_b && r <= p_b) ? sc : NEG;
          }
        }
      }
    }
    __syncwarp();
    for (int g = 0; g < G; ++g) {
      float mx = NEG;
      for (int j = lane; j < ps; j += 32) mx = fmaxf(mx, s_w[g * ps + j]);
      const float m_prev = m_w[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      const bool live = m_new > NEG * 0.5f;  // no valid key yet: P stays 0
      float sum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const float p = live ? expf(s_w[g * ps + j] - m_new) : 0.f;
        sum += p;
        s_w[g * ps + j] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_prev - m_new);
      for (int c = lane; c < dv; c += 32) acc[g * dv + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_w[g] = m_new;
        l_w[g] = l_w[g] * alpha + sum;
      }
    }
    __syncwarp();
    for (int g = 0; g < G; ++g) {
      // one pass over the page's V rows: each lane's CH columns of a row are
      // loaded together, eight rows ahead
      float a[CH];
#pragma unroll
      for (int t = 0; t < CH; ++t) a[t] = (lane + 32 * t < dv) ? acc[g * dv + lane + 32 * t] : 0.f;
      const T* vr = v + (row0 * Kh + kh) * (size_t)v_row;
#pragma unroll 8
      for (int j = 0; j < ps; ++j) {
        const float p = s_w[g * ps + j];
#pragma unroll
        for (int t = 0; t < CH; ++t) {
          const int c = lane + 32 * t;
          if (c < dv) a[t] = fmaf(p, to_f(vr[j * vstride + c]), a[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < CH; ++t)
        if (lane + 32 * t < dv) acc[g * dv + lane + 32 * t] = a[t];
    }
    __syncwarp();
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kh * G) * dv;
  for (int e = tid; e < G * dv; e += FD_THREADS) {
    const int g = e / dv;
    float m = NEG;
    for (int w = 0; w < FD_WARPS; ++w) m = fmaxf(m, part(w)[G * (ps + dv) + g]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < FD_WARPS; ++w) {
      const float* pw = part(w);
      const float f = expf(pw[G * (ps + dv) + g] - m);
      l = fmaf(pw[G * (ps + dv) + G + g], f, l);
      a = fmaf(pw[G * ps + e], f, a);
    }
    ob[e] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int CH>
int launch(const void* q, const void* k, const void* v, const int* pages, const int* pos,
           const int* start, void* out, int B, int H, int Kh, int dq, int dv, int v_row,
           int ps, int npp, float scale, float softcap, cudaStream_t stream) {
  const int G = H / Kh;
  const size_t smem = sizeof(float) * ((size_t)G * dq + (size_t)FD_WARPS * G * (ps + dv + 2));
  auto kern = flash_decode_paged_kernel<T, CH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Kh, B);
  kern<<<grid, FD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pages,
      pos, start, static_cast<T*>(out), H, Kh, dq, dv, v_row, ps, npp, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* pages, const int* pos,
             const int* start, void* out, int B, int H, int Kh, int dq, int dv, int v_row,
             int ps, int npp, float scale, float softcap, cudaStream_t s) {
  const int dmax = dq > dv ? dq : dv;
  if (dmax <= 32)
    return launch<T, 1>(q, k, v, pages, pos, start, out, B, H, Kh, dq, dv, v_row, ps, npp,
                        scale, softcap, s);
  if (dmax <= 64)
    return launch<T, 2>(q, k, v, pages, pos, start, out, B, H, Kh, dq, dv, v_row, ps, npp,
                        scale, softcap, s);
  if (dmax <= 128)
    return launch<T, 4>(q, k, v, pages, pos, start, out, B, H, Kh, dq, dv, v_row, ps, npp,
                        scale, softcap, s);
  if (dmax <= 256)
    return launch<T, 8>(q, k, v, pages, pos, start, out, B, H, Kh, dq, dv, v_row, ps, npp,
                        scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro

// q [B,H,dq]; k pool [P,ps,Kh,dq]; v pool [P,ps,Kh,v_row] (first dv columns
// read); pages [B,npp]; pos, start [B]; out [B,H,dv].  softcap <= 0 is off.
extern "C" int repro_flash_decode_paged(const void* q, const void* k, const void* v,
                                        const void* pages, const void* pos,
                                        const void* start, void* out, int B, int H,
                                        int Kh, int dq, int dv, int v_row, int ps,
                                        int npp, float scale, float softcap, int is_bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pg = static_cast<const int*>(pages);
  const int* p = static_cast<const int*>(pos);
  const int* st = static_cast<const int*>(start);
  if (is_bf16)
    return repro::dispatch<__nv_bfloat16>(q, k, v, pg, p, st, out, B, H, Kh, dq, dv, v_row,
                                          ps, npp, scale, softcap, s);
  return repro::dispatch<float>(q, k, v, pg, p, st, out, B, H, Kh, dq, dv, v_row, ps, npp,
                                scale, softcap, s);
}

// ---------------------------------------------------------------------------
// Slot-cache flash-decode: k [B, S, K, dq], v [B, S, K, v_row].
//
// Replaces: src/repro/kernels/decode_attention.py, _fd_kernel (wrapper
// flash_decode), linear and ring layouts.  Validity of cache row r: linear,
// start <= r <= pos (a frozen full slot, pos == S, reads rows
// [start, S - 1]); ring, entry r holds absolute row
// a = pos - ((pos - r) mod S) with a floored mod -- C++ % truncates toward
// zero, so ((pos - r) % S + S) % S -- and is live iff a >= 0 and
// a >= start.  A slot with start > pos writes exact zeros.
//
// What bounds it on an H100: bytes, as for the paged kernel.  At the edge
// path's batch (B = 2 slots, K = 4 kv-heads) one block per (slot, kv-head)
// would leave 124 of 132 SMs idle, so the rows are split (flash-decoding):
// one block per 64-row block of the cache, and one launch in all.
//   - Loads: warp w owns rows 8w..8w+7 of the block.  Each lane holds 16
//     bytes of a row (8 bf16 or 4 f32 columns; at d = 256 bf16 one warp
//     instruction reads a whole 512-byte row).  All eight K rows of the warp
//     are loaded into registers and all eight V rows are copied into shared
//     memory by cp.async before any sum, so the V bytes arrive while the
//     scores are computed and hold no registers meanwhile (each lane later
//     reads back the 16-byte pieces it copied).
//   - Scores: per row a lane's products and a warp sum, for all G query
//     heads of the kv-head (each K row read once); one warp per head takes
//     the block's softmax; P is rounded to the value type before PV.
//   - PV: each warp sums P x V over its own eight rows, a lane its 16 bytes
//     of columns, and the eight warp sums are added in warp order in shared
//     memory: the block's partial (max, sum, unnormalised P.V).
//   - Merge, in the same launch: each block writes its partial, fences, and
//     takes a ticket from the (slot, kv-head)'s int32 counter; the block
//     that draws the last one merges every partial in block order -- a
//     fixed order, whatever order the blocks finished in -- and resets the
//     counter to 0 for the next call.  The wrapper allocates the counters
//     (zeroed once) and the partials' scratch, and keeps both per device.
// Linear blocks outside [start, pos] and every block of a drained slot load
// nothing (they only take their ticket); every block of a live ring is
// visited, as in the Pallas kernel.  Two blocks fit an SM: 103 registers a
// thread at bf16 (ptxas -v, sm_90a), no spills, 52 KB of shared memory at
// G = 2, d = 256.
// ---------------------------------------------------------------------------
namespace repro {

constexpr int SD_ROWS = 64;  // cache rows per block: 8 warps x 8 rows
constexpr int SD_THREADS = 256;
constexpr int SD_WARPS = SD_THREADS / 32;

// Dynamic shared memory of a block, in floats, each part 16-byte aligned:
// q [G][dq], scores [G][SD_ROWS] and max/sum [G][2] (slot_head), the warp
// sums [SD_WARPS][G][dv] or, when merging, two [nblk][G] arrays
// (slot_tail), then the V rows (slot_smem).
__host__ __device__ inline int slot_head(int G, int dq) {
  return (G * dq + G * SD_ROWS + 2 * G + 3) / 4 * 4;
}
__host__ __device__ inline int slot_tail(int G, int dv, int nblk) {
  const int t = SD_WARPS * G * dv > 2 * nblk * G ? SD_WARPS * G * dv : 2 * nblk * G;
  return (t + 3) / 4 * 4;
}

// 16 / sizeof(T) columns c0.. of a row as raw bytes, zero past d; vec: rows
// are 16-byte aligned and the columns lie within d
template <typename T>
__device__ __forceinline__ uint4 load16(const T* row, int c0, int d, bool vec) {
  constexpr int V = 16 / sizeof(T);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (vec && c0 + V <= d) return *reinterpret_cast<const uint4*>(row + c0);
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c0 + i < d) e[i] = row[c0 + i];
  return r;
}

// element i (a compile-time constant after unrolling) of 16 raw bytes
__device__ __forceinline__ uint32_t word(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}
template <typename T> __device__ __forceinline__ float elem(const uint4& r, int i);
template <> __device__ __forceinline__ float elem<float>(const uint4& r, int i) {
  return __uint_as_float(word(r, i));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int i) {
  const uint32_t w = word(r, i >> 1);  // element 2w in the low half
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// CH: 16-byte chunks of a row a lane holds (column c0 = V * (lane + 32 t))
template <typename T, int CH>
__global__ void __launch_bounds__(SD_THREADS, 2)
flash_decode_slot_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ pos,
                         const int* __restrict__ start, float* __restrict__ part,
                         int* __restrict__ counter, T* __restrict__ out, int H, int Kh, int S,
                         int dq, int dv, int v_row, int ring, float scale, float softcap,
                         int veck, int vecv) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) float sd_smem[];
  __shared__ int last;
  const int blk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, nblk = gridDim.x;
  const int G = H / Kh, W = dv + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* q_s = sd_smem;                   // [G][dq]
  float* p_s = q_s + G * dq;              // [G][SD_ROWS] scores, then P
  float* ml = p_s + G * SD_ROWS;          // [G][2] block max and sum
  float* red = sd_smem + slot_head(G, dq);  // [SD_WARPS][G][dv] warp sums; then the merge's
  const int dvs = (dv + V - 1) / V * V;   // a row of v_s, in elements
  T* v_s = reinterpret_cast<T*>(red + slot_tail(G, dv, nblk));  // [SD_ROWS][dvs]
  // partials of this (slot, kv-head): per block, per head [m, l, acc[dv]]
  float* pbase = part + ((size_t)b * Kh + kh) * nblk * (size_t)G * W;
  float* mine = pbase + (size_t)blk * G * W;

  const int p_b = pos[b], s_b = start[b];
  const int r0 = blk * SD_ROWS, jn = min(SD_ROWS, S - r0);
  const bool live = s_b <= p_b && (ring || (r0 <= p_b && r0 + jn > s_b));
  if (live) {
    const size_t kstride = (size_t)Kh * dq, vstride = (size_t)Kh * v_row;
    const T* kb = k + ((size_t)b * S + r0) * kstride + (size_t)kh * dq;
    const T* vb = v + ((size_t)b * S + r0) * vstride + (size_t)kh * v_row;
    uint4 kr[8][CH];  // the warp's 8 K rows; its 8 V rows go to v_s meanwhile
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = warp * 8 + u;
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int c0 = V * (lane + 32 * t);
        kr[u][t] = j < jn ? load16(kb + j * kstride, c0, dq, veck) : make_uint4(0u, 0u, 0u, 0u);
        if (c0 < dv) {
          T* dst = v_s + j * dvs + c0;
          const T* src = vb + j * vstride + c0;
          if (vecv) {  // zeros past dv and past the cache's last row
            const int n = j < jn ? min(V, dv - c0) * static_cast<int>(sizeof(T)) : 0;
            cp_async16_n(dst, n ? src : vb, n);
          } else {
            *reinterpret_cast<uint4*>(dst) =
                j < jn ? load16(src, 0, dv - c0, false) : make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    }
    cp_async_commit();
    const T* qb = q + ((size_t)b * H + (size_t)kh * G) * dq;
    for (int e = tid; e < G * dq; e += SD_THREADS) q_s[e] = to_f(qb[e]);
    __syncthreads();

    for (int g = 0; g < G; ++g) {
      float qv[CH][V];
#pragma unroll
      for (int t = 0; t < CH; ++t)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int c = V * (lane + 32 * t) + i;
          qv[t][i] = c < dq ? q_s[g * dq + c] : 0.f;
        }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < CH; ++t)
#pragma unroll
          for (int i = 0; i < V; ++i) dot = fmaf(qv[t][i], elem<T>(kr[u][t], i), dot);
        dot = warp_sum(dot);
        if (lane == 0) {
          const int j = warp * 8 + u, r = r0 + j;
          bool valid;
          if (ring) {
            const int a = p_b - (((p_b - r) % S + S) % S);
            valid = a >= 0 && a >= s_b;
          } else {
            valid = r >= s_b && r <= p_b;
          }
          float sc = dot * scale;
          if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
          p_s[g * SD_ROWS + j] = (j < jn && valid) ? sc : NEG;
        }
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += SD_WARPS) {
      const float x0 = p_s[g * SD_ROWS + lane], x1 = p_s[g * SD_ROWS + lane + 32];
      const float m = warp_max(fmaxf(x0, x1));
      const bool any = m > NEG * 0.5f;  // no valid row: P stays 0, the sum 0
      const float e0 = any ? expf(x0 - m) : 0.f, e1 = any ? expf(x1 - m) : 0.f;
      const float l = warp_sum(e0 + e1);
      p_s[g * SD_ROWS + lane] = round_to<T>(e0);
      p_s[g * SD_ROWS + lane + 32] = round_to<T>(e1);
      if (lane == 0) {
        ml[2 * g] = m;
        ml[2 * g + 1] = l;
      }
    }
    cp_async_wait<0>();  // this lane's pieces of the warp's V rows have landed
    __syncthreads();
    for (int g = 0; g < G; ++g) {  // this warp's rows, in row order
      float a[CH][V];
#pragma unroll
      for (int t = 0; t < CH; ++t)
#pragma unroll
        for (int i = 0; i < V; ++i) a[t][i] = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = warp * 8 + u;
        const float p = p_s[g * SD_ROWS + j];
#pragma unroll
        for (int t = 0; t < CH; ++t) {
          const int c0 = V * (lane + 32 * t);
          if (c0 >= dv) continue;
          const uint4 vv = *reinterpret_cast<const uint4*>(v_s + j * dvs + c0);
#pragma unroll
          for (int i = 0; i < V; ++i) a[t][i] = fmaf(p, elem<T>(vv, i), a[t][i]);
        }
      }
      float* rw = red + ((size_t)warp * G + g) * dv;
#pragma unroll
      for (int t = 0; t < CH; ++t)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int c = V * (lane + 32 * t) + i;
          if (c < dv) rw[c] = a[t][i];
        }
    }
    __syncthreads();
    for (int e = tid; e < G * dv; e += SD_THREADS) {  // the warps' sums in warp order
      const int g = e / dv, c = e % dv;
      float a = red[(size_t)g * dv + c];
#pragma unroll
      for (int w = 1; w < SD_WARPS; ++w) a += red[((size_t)w * G + g) * dv + c];
      mine[g * W + 2 + c] = a;
    }
    for (int g = tid; g < G; g += SD_THREADS) {
      mine[g * W] = ml[2 * g];
      mine[g * W + 1] = ml[2 * g + 1];
    }
  } else {  // the merge skips a partial whose sum is 0
    for (int g = tid; g < G; g += SD_THREADS) mine[g * W + 1] = 0.f;
  }

  // the block that takes the last ticket of its (slot, kv-head) merges
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counter[b * Kh + kh], 1) == nblk - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* mf = red;             // [nblk][G]: block maxima, then merge factors
  float* lf = red + nblk * G;  // [nblk][G]: block sums
  for (int e = tid; e < nblk * G; e += SD_THREADS) {
    const float* pi = pbase + (size_t)e * W;  // block e / G, head e % G
    mf[e] = __ldcg(pi);
    lf[e] = __ldcg(pi + 1);
  }
  __syncthreads();
  for (int g = warp; g < G; g += SD_WARPS) {
    float m = NEG;
    for (int i = lane; i < nblk; i += 32)
      if (lf[i * G + g] > 0.f) m = fmaxf(m, mf[i * G + g]);
    m = warp_max(m);
    __syncwarp();
    for (int i = lane; i < nblk; i += 32)
      mf[i * G + g] = lf[i * G + g] > 0.f ? expf(mf[i * G + g] - m) : 0.f;
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)kh * G) * dv;
  for (int e = tid; e < G * dv; e += SD_THREADS) {
    const int g = e / dv, c = e % dv;
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int i = 0; i < nblk; ++i) {  // block order
      const float x = __ldcg(pbase + ((size_t)i * G + g) * W + 2 + c);
      const float f = mf[i * G + g], li = lf[i * G + g];
      if (li > 0.f) {
        l = fmaf(li, f, l);
        a = fmaf(x, f, a);
      }
    }
    ob[e] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
  if (tid == 0) counter[b * Kh + kh] = 0;  // every block has drawn its ticket
}

template <typename T>
size_t slot_smem(int G, int dq, int dv, int nblk) {
  constexpr int V = 16 / sizeof(T);
  return sizeof(float) * ((size_t)slot_head(G, dq) + slot_tail(G, dv, nblk)) +
         sizeof(T) * SD_ROWS * (size_t)((dv + V - 1) / V * V);
}

template <typename T, int CH>
int launch_slot(const void* q, const void* k, const void* v, const int* pos, const int* start,
                float* part, int* counter, void* out, int B, int H, int Kh, int S, int dq,
                int dv, int v_row, int ring, float scale, float softcap, cudaStream_t stream) {
  const int G = H / Kh, nblk = (S + SD_ROWS - 1) / SD_ROWS;
  const size_t smem = slot_smem<T>(G, dq, dv, nblk);
  auto kern = flash_decode_slot_kernel<T, CH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte row loads need 16-byte aligned rows
  const int veck = (reinterpret_cast<uintptr_t>(k) % 16 == 0) && (dq * sizeof(T)) % 16 == 0;
  const int vecv = (reinterpret_cast<uintptr_t>(v) % 16 == 0) && (v_row * sizeof(T)) % 16 == 0;
  kern<<<dim3(nblk, Kh, B), SD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      start, part, counter, static_cast<T*>(out), H, Kh, S, dq, dv, v_row, ring, scale,
      softcap, veck, vecv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_slot(const void* q, const void* k, const void* v, const int* pos,
                  const int* start, float* part, int* counter, void* out, int B, int H, int Kh,
                  int S, int dq, int dv, int v_row, int ring, float scale, float softcap,
                  cudaStream_t s) {
  const int dmax = dq > dv ? dq : dv;
  const int per = 32 * (16 / static_cast<int>(sizeof(T)));  // columns a warp's chunk holds
#define REPRO_SLOT(CH)                                                                  \
  return launch_slot<T, CH>(q, k, v, pos, start, part, counter, out, B, H, Kh, S, dq, \
                            dv, v_row, ring, scale, softcap, s)
  if (dmax <= per) REPRO_SLOT(1);
  if constexpr (sizeof(T) == 4) {  // f32 rows up to 256 wide take two chunks a lane
    if (dmax <= 2 * per) REPRO_SLOT(2);
  }
#undef REPRO_SLOT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro

// q [B,H,dq]; k [B,S,Kh,dq]; v [B,S,Kh,v_row] (first dv columns read); pos,
// start [B]; part: B*Kh*ceil(S/64)*(H/Kh)*(dv+2) f32 scratch; counter:
// B*Kh int32, all 0 (every launch leaves them 0 again); out [B,H,dv].
// ring: 0 linear, 1 ring.  softcap <= 0 is off.  One launch.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* pos, const void* start, void* part,
                                  void* counter, void* out, int B, int H, int Kh, int S,
                                  int dq, int dv, int v_row, int ring, float scale,
                                  float softcap, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* st = static_cast<const int*>(start);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counter);
  if (is_bf16)
    return repro::dispatch_slot<__nv_bfloat16>(q, k, v, p, st, pt, ct, out, B, H, Kh, S, dq,
                                               dv, v_row, ring, scale, softcap, s);
  return repro::dispatch_slot<float>(q, k, v, p, st, pt, ct, out, B, H, Kh, S, dq, dv, v_row,
                                     ring, scale, softcap, s);
}
