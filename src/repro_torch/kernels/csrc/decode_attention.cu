// Flash-decode for Hopper (sm_90a): one query token per slot, over a slot
// cache [B, S, K, d] in its linear or ring layout, or over page pools
// [P, ps, K, d] read through a page table.  The three layouts share one
// kernel body; the row address is a template parameter (SlotRows,
// PageRows).
//
// Replaces: src/repro/kernels/decode_attention.py, _fd_kernel (wrapper
// flash_decode) and _fd_kernel_paged (wrapper _flash_decode_paged).
// Validity of logical row r: linear (and paged), start <= r <= pos (a
// frozen full slot, pos == S, reads rows [start, S - 1]); ring, entry r
// holds absolute row a = pos - ((pos - r) mod S) with a floored mod -- C++
// % truncates toward zero, so ((pos - r) % S + S) % S -- and is live iff
// a >= 0 and a >= start.  A slot with start > pos writes exact zeros.
// Paged: logical row r of slot b lives at pool row
// pages[b, min(r / ps, npp - 1)] * ps + r % ps, the page index clipped to
// npp - 1 as the Pallas index map clips it, over S = npp * ps logical rows;
// only live rows are read, so the pools' drop row and the trash pages of a
// table are never touched.
//
// What bounds it on an H100: bytes.  Each (slot, kv-head) reads its live KV
// rows once and does 4*G*d operations per row (G query heads share a row),
// orders of magnitude below the card's operations-per-byte balance.  One
// block per (slot, kv-head) would leave most SMs idle at small batches and
// let the longest slot set the time, so the rows are split
// (flash-decoding): one block per 64-row block of a slot's logical rows,
// per kv-head, per slot, and one launch in all.
//   - Loads: warp w owns rows 8w..8w+7 of the block.  Each lane holds 16
//     bytes of a row (8 bf16 or 4 f32 columns; at d = 256 bf16 one warp
//     instruction reads a whole 512-byte row).  All eight K rows of the warp
//     are loaded into registers and all eight V rows are copied into shared
//     memory by cp.async before any sum, so the V bytes arrive while the
//     scores are computed and hold no registers meanwhile (each lane later
//     reads back the 16-byte pieces it copied).  A row's storage index is
//     computed once (one page-table read for a pool) for its K and its V.
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
//     (zeroed once) and the partials' scratch, and keeps both per device
//     and stream.
// Slot caches: linear blocks outside [start, pos] and every block of a
// drained slot load nothing and only take their ticket; every block of a
// live ring is visited, as in the Pallas kernel.  Pools: a slot's rows are
// the table's width (the engine's max_len), mostly past pos, so which
// blocks are live is computed from pos and start by every block; the
// others exit at once (block 0 of a slot with none writes its zeros), the
// tickets count live blocks only, and a slot with one live block writes
// its output directly, which is the merge of one partial.  Both steps are
// compiled for pools only: on slot caches, where nearly every block is
// live, they measured slower.  Only rows in
// [start, pos] of a linear or paged block are read.  The split of a slot's
// rows and every sum's order depend on nothing but the slot's own rows: no
// atomics on values, nothing chosen by the batch.  Softcap and dv
// narrowing (v may alias k, MLA-style: v's rows are v_row wide) are
// supported, G = H / K from 1 up, dq and dv <= 288.  Slot caches: two blocks an
// SM, 103 registers a thread at bf16 (ptxas -v, sm_90a), no spills, 52 KB
// of shared memory at G = 2, d = 256.  Pools: compiled for three blocks an
// SM (80 registers at bf16, 32 bytes spilled), which hid more of the
// load latency than two at the engine's decode shape (B = 8, H = K = 16,
// d = 128) and than four; slot caches measured no gain from a third block.
// chip_smoke.py prints every instantiation's ptxas line.
//
// MLA's latent call (minicpm3-4b: H = 40 query heads over one latent
// kv-head, dq = kv_lora_rank + qk_rope = 288, dv = 256, v aliasing k)
// would need ~417 KB of shared memory a block with all G = 40 heads in one
// block, the warp sums [8][G][dv] most of it.  So a kv-head's G query heads
// are split into `ng` head groups of at most 8 heads, one block each: the
// grid is (row blocks, Kh * ng, B), and each (slot, kv-head, head group)
// has its own ticket and partials, merged in block order as above.  Every
// group re-reads the same K/V rows (576 B a latent row), mostly from L2;
// the groups add the parallelism one latent head lacks.  Head groups exist
// only in the instantiations for rows wider than 256 columns (CH = 2
// chunks a lane in bf16, 3 in f32, up to SD_MAX_D columns); every narrower
// one has ng = 1 folded in at compile time, its code unchanged.  ng depends
// on G and the row width alone (the wrapper's head_groups), so a CUDA
// graph's grid stays fixed.  The wide instantiations are compiled for one
// block an SM: eight K rows of CH 16-byte chunks take 16 CH registers a
// lane, and a group's ~110 KB (bf16) / ~140 KB (f32) of shared memory
// leaves room for no more.
// Bound: at G = 40 each latent row meets 40 heads, ~80 operations a byte,
// still under the card's bf16 balance in the operations the CUDA cores do.
#include "common.cuh"
#include "index.cuh"  // addresses and block decisions, as the bounds proofs read them

namespace repro {

constexpr int SD_ROWS = ix::SD_ROWS;  // cache rows per block: 8 warps x 8 rows
constexpr int SD_THREADS = 256;
constexpr int SD_WARPS = SD_THREADS / 32;
constexpr int SD_MAX_D = 288;  // widest q or v row: MLA's kv_lora_rank + qk_rope

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

// Storage row of logical row r of slot b, counted in rows of [Kh][width]:
// a slot cache's own rows (b * S + r: contiguous, so a block steps a
// pointer), or a pool's rows through the page table (the page index
// clipped to npp - 1); the arithmetic is index.cuh's.  min_blocks: blocks
// an SM the kernel is compiled for (registers a thread <= 65536 / (256 *
// min_blocks)).  paged: a slot's
// rows are a table's width, mostly past pos, so blocks outside the live
// range exit at once (see the kernel).
struct SlotRows {
  static constexpr int min_blocks = 2;
  static constexpr bool paged = false;
  int S;
  __device__ __forceinline__ size_t operator()(int b, int r) const { return ix::slot_row(S, b, r); }
};
struct PageRows {
  static constexpr int min_blocks = 3;  // a third block an SM hides more load latency
  static constexpr bool paged = true;
  const int* pages;  // [B, npp]
  int ps, npp;
  __device__ __forceinline__ size_t operator()(int b, int r) const {
    return ix::page_row(pages, ps, npp, b, r);
  }
};

// CH: 16-byte chunks of a row a lane holds (column c0 = V * (lane + 32 t));
// S: logical rows of a slot (npp * ps for pools).  Grid (row blocks,
// Kh * head groups, B): G below counts the query heads of this block's
// group, h0 its first head.  Compiled for the row functor's blocks an SM
// up to 256-column rows, for one past them (see the head note).
template <typename T, int CH, typename Rows>
__global__ void __launch_bounds__(SD_THREADS,
                                  (CH * 32 * (16 / sizeof(T)) > 256 ? 1 : Rows::min_blocks))
flash_decode_slot_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ pos,
                         const int* __restrict__ start, float* __restrict__ part,
                         int* __restrict__ counter, T* __restrict__ out, int H, int Kh, int S,
                         int dq, int dv, int v_row, int ring, float scale, float softcap,
                         int veck, int vecv, Rows rows) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) float sd_smem[];
  __shared__ int last;
  constexpr bool wide = CH * 32 * V > 256;  // rows past 256 columns: head groups
  const int blk = blockIdx.x, b = blockIdx.z, nblk = gridDim.x;
  // ng head groups a kv-head
  const int ng = wide ? gridDim.y / Kh : 1, kh = ix::group_kv_head(blockIdx.y, ng);
  const int G = ix::group_heads(H, Kh, ng), W = dv + 2;
  const int h0 = ix::group_first_head(blockIdx.y, kh, H, Kh, ng, G);
  const int grp = ix::group_index(blockIdx.y, b, Kh, ng);  // this (slot, kv-head, head group)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* q_s = sd_smem;                   // [G][dq]
  float* p_s = q_s + G * dq;              // [G][SD_ROWS] scores, then P
  float* ml = p_s + G * SD_ROWS;          // [G][2] block max and sum
  float* red = sd_smem + slot_head(G, dq);  // [SD_WARPS][G][dv] warp sums; then the merge's
  const int dvs = (dv + V - 1) / V * V;   // a row of v_s, in elements
  T* v_s = reinterpret_cast<T*>(red + slot_tail(G, dv, nblk));  // [SD_ROWS][dvs]
  // partials of this (slot, kv-head, head group): per block, per head
  // [m, l, acc[dv]]
  float* pbase = part + (size_t)grp * nblk * (size_t)G * W;
  float* mine = pbase + (size_t)blk * G * W;

  const int p_b = pos[b], s_b = start[b];
  const int r0 = ix::block_first_row(blk), jn = ix::block_rows(r0, S);
  // the blocks that take part, [blo, bhi].  Slot caches: all of them (a
  // block with no live row writes a partial with sum 0).  Pools: those
  // overlapping [start, pos], none when drained -- a function of the slot's
  // own rows, known to every block: the others exit at once, and block 0
  // of a slot with none writes its zeros.  Every decision is index.cuh's.
  int blo = 0, bhi = ix::decode_last_block(Rows::paged, nblk);
  if (ix::decode_cut_to_live(Rows::paged, p_b, s_b, S)) {
    blo = ix::first_live_block(s_b);
    bhi = ix::last_live_block(p_b, S);
  }
  const int nlive = ix::decode_live_blocks(blo, bhi);
  if (ix::decode_block_exits(Rows::paged, blk, blo, bhi)) {
    if (ix::decode_zero_writer(blk, nlive)) {
      T* ob = out + ((size_t)b * H + h0) * dv;
      for (int e = tid; e < G * dv; e += SD_THREADS) ob[e] = from_f<T>(0.f);
    }
    return;
  }
  const bool live = ix::decode_block_live(r0, jn, p_b, s_b, ring);
  if (live) {
    // rows read: all of a ring block's, those in [start, pos] of a linear or
    // paged one (the rest stay zero and are masked)
    const int j_lo = ring ? ix::ring_first_row() : ix::rows_from(s_b, r0);
    const int j_hi = ring ? ix::ring_last_row(jn) : ix::rows_to(p_b, r0, jn);
    const size_t kstride = (size_t)Kh * dq, vstride = (size_t)Kh * v_row;
    size_t sr0 = 0;  // slot caches: the block's first row; its rows follow
    if constexpr (!Rows::paged) sr0 = rows(b, r0);
    const T* kb = k + sr0 * kstride + (size_t)kh * dq;
    const T* vb = v + sr0 * vstride + (size_t)kh * v_row;
    uint4 kr[8][CH];  // the warp's 8 K rows; its 8 V rows go to v_s meanwhile
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = warp * 8 + u;
      const bool rd = ix::decode_reads_row(j, j_lo, j_hi);
      const T* krow = kb + j * kstride;
      const T* vrow = vb + j * vstride;
      if constexpr (Rows::paged) {  // one table read for K and V
        const size_t sr = rd ? rows(b, r0 + j) : 0;
        krow = kb + sr * kstride;
        vrow = vb + sr * vstride;
      }
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int c0 = V * (lane + 32 * t);
        kr[u][t] = rd ? load16(krow, c0, dq, veck) : make_uint4(0u, 0u, 0u, 0u);
        if (c0 < dv) {
          T* dst = v_s + j * dvs + c0;
          if (vecv) {  // zeros past dv and on rows not read
            const int n = rd ? min(V, dv - c0) * static_cast<int>(sizeof(T)) : 0;
            cp_async16_n(dst, n ? vrow + c0 : v, n);
          } else {
            *reinterpret_cast<uint4*>(dst) =
                rd ? load16(vrow + c0, 0, dv - c0, false) : make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    }
    cp_async_commit();
    const T* qb = q + ((size_t)b * H + h0) * dq;
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
          const bool valid = ix::decode_row_valid(r, p_b, s_b, S, ring);
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
    if (ix::decode_writes_direct(Rows::paged, nlive)) {  // the merge of its lone partial
      T* ob = out + ((size_t)b * H + h0) * dv;
      for (int e = tid; e < G * dv; e += SD_THREADS) {  // the warps' sums in warp order
        const int g = e / dv, c = e % dv;
        float a = red[(size_t)g * dv + c];
#pragma unroll
        for (int w = 1; w < SD_WARPS; ++w) a += red[((size_t)w * G + g) * dv + c];
        ob[e] = from_f<T>(a / fmaxf(ml[2 * g + 1], 1e-30f));
      }
      return;
    }
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

  // the block that takes the last ticket of its (slot, kv-head, head
  // group) merges
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counter[grp], 1) == ix::decode_tickets(Rows::paged, nlive) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* mf = red;              // [nlive][G]: block maxima, then merge factors
  float* lf = red + nlive * G;  // [nlive][G]: block sums
  const float* plive = pbase + (size_t)blo * G * W;  // the live blocks' partials
  for (int e = tid; e < nlive * G; e += SD_THREADS) {
    const float* pi = plive + (size_t)e * W;  // live block e / G, head e % G
    mf[e] = __ldcg(pi);
    lf[e] = __ldcg(pi + 1);
  }
  __syncthreads();
  for (int g = warp; g < G; g += SD_WARPS) {
    float m = NEG;
    for (int i = lane; i < nlive; i += 32)
      if (lf[i * G + g] > 0.f) m = fmaxf(m, mf[i * G + g]);
    m = warp_max(m);
    __syncwarp();
    for (int i = lane; i < nlive; i += 32)
      mf[i * G + g] = lf[i * G + g] > 0.f ? expf(mf[i * G + g] - m) : 0.f;
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + h0) * dv;
  for (int e = tid; e < G * dv; e += SD_THREADS) {
    const int g = e / dv, c = e % dv;
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int i = 0; i < nlive; ++i) {  // block order
      const float x = __ldcg(plive + ((size_t)i * G + g) * W + 2 + c);
      const float f = mf[i * G + g], li = lf[i * G + g];
      if (li > 0.f) {
        l = fmaf(li, f, l);
        a = fmaf(x, f, a);
      }
    }
    ob[e] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
  if (tid == 0) counter[grp] = 0;  // every block has drawn its ticket
}

template <typename T>
size_t slot_smem(int G, int dq, int dv, int nblk) {
  constexpr int V = 16 / sizeof(T);
  return sizeof(float) * ((size_t)slot_head(G, dq) + slot_tail(G, dv, nblk)) +
         sizeof(T) * SD_ROWS * (size_t)((dv + V - 1) / V * V);
}

template <typename T, int CH, typename Rows>
int launch_slot(const void* q, const void* k, const void* v, const int* pos, const int* start,
                float* part, int* counter, void* out, int B, int H, int Kh, int ng, int S,
                int dq, int dv, int v_row, int ring, float scale, float softcap, Rows rows,
                cudaStream_t stream) {
  const int G = H / Kh / ng, nblk = ix::decode_blocks(S);  // G: heads a block
  const size_t smem = slot_smem<T>(G, dq, dv, nblk);
  auto kern = flash_decode_slot_kernel<T, CH, Rows>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte row loads need 16-byte aligned rows
  const int veck = (reinterpret_cast<uintptr_t>(k) % 16 == 0) && (dq * sizeof(T)) % 16 == 0;
  const int vecv = (reinterpret_cast<uintptr_t>(v) % 16 == 0) && (v_row * sizeof(T)) % 16 == 0;
  kern<<<dim3(nblk, Kh * ng, B), SD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      start, part, counter, static_cast<T*>(out), H, Kh, S, dq, dv, v_row, ring, scale,
      softcap, veck, vecv, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Rows>
int dispatch_slot(const void* q, const void* k, const void* v, const int* pos,
                  const int* start, float* part, int* counter, void* out, int B, int H, int Kh,
                  int ng, int S, int dq, int dv, int v_row, int ring, float scale,
                  float softcap, Rows rows, cudaStream_t s) {
  const int dmax = dq > dv ? dq : dv;
  constexpr int per = 32 * (16 / static_cast<int>(sizeof(T)));  // columns a warp's chunk holds
  constexpr int wide = (SD_MAX_D + per - 1) / per;  // chunks a lane for SD_MAX_D: 2 bf16, 3 f32
  if (ng <= 0 || (H / Kh) % ng || (dmax <= 256 && ng != 1))  // groups on wide rows only
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SLOT(CH)                                                                     \
  return launch_slot<T, CH, Rows>(q, k, v, pos, start, part, counter, out, B, H, Kh, ng, \
                                  S, dq, dv, v_row, ring, scale, softcap, rows, s)
  if (dmax <= per) REPRO_SLOT(1);
  if constexpr (sizeof(T) == 4) {  // f32 rows up to 256 wide take two chunks a lane
    if (dmax <= 2 * per) REPRO_SLOT(2);
  }
  if (dmax <= SD_MAX_D) REPRO_SLOT(wide);
#undef REPRO_SLOT
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Rows>
int dispatch_type(const void* q, const void* k, const void* v, const int* pos,
                  const int* start, float* part, int* counter, void* out, int B, int H, int Kh,
                  int ng, int S, int dq, int dv, int v_row, int ring, float scale,
                  float softcap, int is_bf16, Rows rows, cudaStream_t s) {
  if (is_bf16)
    return dispatch_slot<__nv_bfloat16>(q, k, v, pos, start, part, counter, out, B, H, Kh,
                                        ng, S, dq, dv, v_row, ring, scale, softcap, rows, s);
  return dispatch_slot<float>(q, k, v, pos, start, part, counter, out, B, H, Kh, ng, S, dq,
                              dv, v_row, ring, scale, softcap, rows, s);
}

}  // namespace repro

// q [B,H,dq]; k [B,S,Kh,dq] and v [B,S,Kh,v_row] slot caches, or, with
// pages [B,npp] not null, pools k [P,ps,Kh,dq] and v [P,ps,Kh,v_row] over
// S = npp*ps logical rows (linear validity); the first dv columns of v are
// read; dq, dv <= 288.  ng: head groups a kv-head (dividing H/Kh; 1 when
// dq, dv <= 256).  pos,
// start [B]; part: B*Kh*ceil(S/64)*(H/Kh)*(dv+2) f32 scratch; counter:
// B*Kh*ng int32, all 0 (every launch leaves them 0 again); out [B,H,dv].
// ring: 0 linear, 1 ring (slot caches only).  softcap <= 0 is off.  One
// launch.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* pages, const void* pos, const void* start,
                                  void* part, void* counter, void* out, int B, int H, int Kh,
                                  int ng, int S, int dq, int dv, int v_row, int ring, int ps,
                                  int npp, float scale, float softcap, int is_bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* st = static_cast<const int*>(start);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counter);
  if (pages) {
    if (ring || ps <= 0 || npp <= 0 || S != npp * ps)
      return static_cast<int>(cudaErrorInvalidValue);
    const repro::PageRows rows{static_cast<const int*>(pages), ps, npp};
    return repro::dispatch_type(q, k, v, p, st, pt, ct, out, B, H, Kh, ng, S, dq, dv, v_row,
                                0, scale, softcap, is_bf16, rows, s);
  }
  return repro::dispatch_type(q, k, v, p, st, pt, ct, out, B, H, Kh, ng, S, dq, dv, v_row,
                              ring, scale, softcap, is_bf16, repro::SlotRows{S}, s);
}
