// Flash attention for Hopper (sm_90a): dense attention (whole-prompt
// prefill and the training forward) and paged chunk prefill (a query chunk
// at absolute positions q_start + i attending causally over logical rows
// [0, k_len) of page pools).  Both run on one tile loop per dtype: the
// paged form is the dense kernel with its K/V rows looked up through the
// page table and its keys split over blocks.
//
// Replaces: src/repro/kernels/flash_attention.py, _fa_kernel (wrapper
// flash_attention) and _fa_kernel_paged (wrapper _flash_attention_paged).
//
// Masks, as the Pallas kernels: query row i sits at position qpos = i + off
// (dense: off = Sk - Sq, the last query aligned with the last key, so
// Sq < Sk continues a cached prefix; paged: off = q_start[b]); key kpos is
// valid iff kpos < kn (dense: Sk; paged: min(k_len[b], npp * ps)), and
// kpos <= qpos when causal (paged: always), and kpos > qpos - window when
// windowed; softcap before the mask.  A row with every key masked writes
// exact 0.  GQA maps head h to kv-head h / (H/K): no KV broadcast in
// memory.  Strides are read, not assumed, so the layers hand over
// transposed views of their [B, S, H, d] tensors with no copy, and the
// output is written into a [B, Sq, H, d] buffer.
//
// Paged addressing: key row r of slot b lives at pool row
// pages[b, r / ps] * ps + r % ps, kv-head kh, in pools [P, ps, K, d]; ps is
// any positive multiple of 8, so a key tile may span several pages or half
// of one.  Only rows r < kn are ever read (the cp.async of a row past kn is
// a zero fill), so the pools' spare drop row and the trash entries of a
// table past the slot's rows are never touched.  Key tiles are loaded only
// where _paged_block_live (flash_attention.py:28) holds -- the tile has
// rows below kn and not past the query tile's causal horizon -- and not
// where they lie wholly below every query row's window.
//
// What bounds it on an H100: dense prefill (Sq = Sk = thousands, d = 256)
// is bound by operations, 4*BQ*keys*d a (q-tile, head) on BQ*d + 2*keys*d
// inputs.  A serving chunk (C = 64 rows over a past of a few hundred, one
// slot) is bound by neither: its bytes (the live K/V rows once) and its
// operations are both a few microseconds of the card, and what it pays is
// latency -- a few blocks each walking their tiles one after another.  The
// paged form therefore splits each slot's keys into pieces of FAP_SPLIT
// rows (a constant: never a function of B, H or the grid), one block per
// (query tile, piece, head, slot), so a 64-row chunk over 512 keys at
// H = 16 keeps 64 blocks busy instead of 16.  Each block writes its
// partial (row max, row sum, unnormalised O in f32), fences and takes a
// ticket from its (slot, head, query tile)'s counter; the block that draws
// the last ticket merges the partials in piece order -- a fixed order,
// whatever order the blocks finished in -- and resets the counter.  Which
// pieces are live follows from the slot's q_start, k_len and window, which
// every block reads: a block of a dead piece exits at once (no load, no
// ticket), and a query tile with one live piece is written directly by its
// block, which is the merge of one partial.  The split and every sum's
// order depend on nothing but the slot's own rows, so a slot gives the same
// bits alone or in a batch.
//
// bf16 (the serving and edge paths): tensor cores.  A block owns 64 query
// rows of one head, four warps of 16 rows each.  Q stays bf16 in shared
// memory; K/V tiles of KT rows (64, or 32 at d > 128) come through a 2-stage
// cp.async ring, so tile t+1 loads while tile t computes, with one barrier
// per tile; a paged tile's row offsets are looked up once per row and
// serve both its K and its V copy.  Each warp runs QK^T and PV as mma.sync
// m16n8k16 (bf16 in, f32 accumulate), Q and K fragments by ldmatrix, V by
// ldmatrix.trans; S, the running max and the running sum stay in registers
// (max over the quad of lanes that share a row), and the S accumulator is
// repacked in registers as the A fragment of PV.  The softmax runs in base
// 2 (scores times log2 e, ex2.approx), P is rounded to bf16 before PV while
// the sum takes the unrounded P (as _fa_kernel's p.astype(v.dtype)), the
// rescale of O is skipped once the running max stops moving, and the
// output is O / max(l, 1e-30).  A warp skips a tile where all its 16 rows
// are masked, and masks per element only on tiles that cross the diagonal,
// the window edge or kn.  Dense blocks are numbered heaviest causal query
// tile first, with the heads of one kv-head adjacent so their K/V reads
// meet in L2 (paged blocks too).  d is padded to D in {16, ..., 256} with
// zero columns; shared rows are padded by 16 bytes, so the 8 rows of every
// ldmatrix fall in distinct banks.
//   What holds it back: at d = 256 the O accumulator alone is 128 registers
// a thread, so a warp runs at ~245 registers and two blocks (8 warps) fit
// an SM; with two warps per scheduler, the softmax between the two products
// and the ldmatrix -> mma chains are not hidden.  Measured alternatives
// that were slower on an H100 at d = 256 (dense): 16-row key tiles (3 or 4
// stages), 64-row tiles (one block an SM), a 3-stage ring, single-buffered
// K and V with split waits, pairs of warps splitting each row group's
// keys and columns (16 warps an SM, 128 registers, spills), and two blocks
// of a cluster splitting a query tile's keys with a merge over distributed
// shared memory (the causal tail is not what holds it back).
//   Paged: with a 64-row chunk every piece is one or two key tiles, so a
// block's time is the latency of its first tile's load, and the launch's
// the chain to the last block's merge: it reads the other partials
// (64 x (d + 2) f32 a piece) from L2, first every m and l in one sweep into
// shared memory, then each piece's O with a thread's eight 16-byte loads in
// flight.  Measured slower at the engine's chunk shape (C = 64, 512 keys,
// d = 128): 64- and 256-row pieces, sixteen loads a thread in the merge,
// a merge that read each piece's m and l per row (serial L2 round trips),
// and the default register budget (168 registers with spills; the paged
// entry asks for one block an SM and gets 214, none spilled).  Registers,
// spills and shared memory per block: DENSE_TC_RESOURCES below.
//
// f32 (reduced configs, parity checks): CUDA cores, full f32, never TF32.  A
// block owns 64 query rows, keeps them in shared memory for its walk over
// 32-row K/V tiles, and computes each thread's 2 x 4 scores and
// 4 x ceil(d/16) outputs from registers, over the same live tiles.  The
// paged form reads its rows through the same table and does not split: it
// carries the tests and the card's comparisons, never a serving path.
#include "common.cuh"
#include "index.cuh"  // addresses and block decisions, as the bounds proofs read them

namespace repro {

constexpr int FAD_BQ = 64;       // query rows per block
constexpr int FAD_KT = 32;       // key rows per tile (one per lane in the softmax)
constexpr int FAD_THREADS = 256;
constexpr int FAP_SPLIT = ix::FAP_SPLIT;  // key rows per piece of a paged slot (bf16)

struct Strides3 {
  long long b, h, s;  // elements; the d stride is 1
};

// The paged form's extra operands: page tables [B, npp], q_start and k_len
// [B]; the bf16 split's partials (per (slot, head, query tile, piece):
// O [64][d], then m [64], then l [64], f32) and one ticket counter per
// (slot, head, query tile), all 0 between launches.
struct Paged {
  const int* pages;
  const int* q_start;
  const int* k_len;
  float* part;
  int* counter;
  int npp, ps, nsplit;
};

template <typename T, int CH, bool PAGED>  // CH = ceil(d / 16): output columns per thread
__global__ void __launch_bounds__(FAD_THREADS)
flash_attention_dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, Strides3 qs,
                             Strides3 ks, Strides3 vs, Strides3 os, int H, int Kh, int Sq,
                             int Sk, int d, int causal, int window, float scale,
                             float softcap, Paged pg) {
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
  int off = Sk - Sq, kn = Sk;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + kh * ks.h;
  const T* vb = v + kh * vs.h;
  const int* tbl = nullptr;
  if constexpr (PAGED) {
    off = pg.q_start[b];
    kn = ix::paged_keys(pg.k_len[b], pg.npp, pg.ps);
    tbl = pg.pages + (size_t)b * pg.npp;
  } else {
    kb += b * ks.b;
    vb += b * vs.b;
  }
  const int q0 = iq * BQ;

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
  int key_lo, key_hi;
  ix::tile_keys(q0, BQ, Sq, off, kn, causal, window, key_lo, key_hi);
  __syncthreads();
  for (int t0 = ix::first_key_row(key_lo, key_hi, KT, kn); ix::core_tile_live(t0, key_hi, KT);
       t0 += KT) {
    for (int e = tid; e < KT * d; e += FAD_THREADS) {
      const int j = e / d, c = e % d;
      const int r = t0 + j;
      const bool ok = ix::inside(r, kn);
      long long row = r;  // the key row's index in the K/V operand's rows
      if constexpr (PAGED) row = ok ? ix::pool_row(tbl, pg.ps, r) : 0;
      k_s[j * dp + c] = ok ? to_f(kb[row * ks.s + c]) : 0.f;
      v_s[j * d + c] = ok ? to_f(vb[row * vs.s + c]) : 0.f;
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
        const bool valid = ix::key_valid(t0 + j, q0 + i + off, kn, causal, window);
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

template <typename T, int CH, bool PAGED>
int launch_dense(const void* q, const void* k, const void* v, void* out, Strides3 qs,
                 Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq, int Sk,
                 int d, int causal, int window, float scale, float softcap, Paged pg,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(FAD_BQ + FAD_KT) * (d + 1) +
                                       (size_t)FAD_KT * d + FAD_BQ * (FAD_KT + 1) +
                                       3 * FAD_BQ);
  auto kern = flash_attention_dense_kernel<T, CH, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(ix::query_tiles(Sq, FAD_BQ), H, B);
  kern<<<grid, FAD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), qs, ks, vs, os, H, Kh, Sq, Sk, d, causal, window, scale,
      softcap, pg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int dispatch_dense(const void* q, const void* k, const void* v, void* out, Strides3 qs,
                   Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                   int Sk, int d, int causal, int window, float scale, float softcap,
                   Paged pg, cudaStream_t s) {
#define REPRO_FAD(CH)                                                                  \
  return launch_dense<T, CH, PAGED>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d, \
                                    causal, window, scale, softcap, pg, s)
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
// D = 32: 127 / 0 / 25,600; D = 16: 115 / 0 / 15,360.  Paged (one block
// an SM): D = 256: 247 / 0; D = 128: 214 / 0, plus the merge's
// 4 * (2 * pieces + 1) * 64 bytes where that exceeds the ring.
// chip_smoke.py prints every instantiation's line.
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

using ix::fat_kt;  // K/V tile rows

// shared memory of a block in bytes: Q and the ring of K and V tiles, bf16,
// rows of D + 8
__host__ __device__ constexpr int fat_smem(int D) {
  return 2 * (FAT_BQ + 2 * FAT_ST * fat_kt(D)) * (D + 8);
}

// The tile loop of both forms; the two kernels below are its entries.
template <int D, bool PAGED>  // d padded to D (a power of two, 16..256)
__device__ __forceinline__ void
fat_body(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, Strides3 qs,
         Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq, int Sk, int d,
         int causal, int window, float scale, float softcap, int vec, Paged pg) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = FAT_BQ, KT = fat_kt(D), ST = FAT_ST, RS = D + 8;  // RS: shared row stride
  extern __shared__ __align__(16) unsigned char fat_smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(fat_smem_raw);  // [BQ][RS]
  bf16* kv_s = q_s + BQ * RS;                         // [ST stages][K, V][KT][RS]

  // heaviest causal query tile first; the heads of one kv-head side by
  // side; paged: then the key pieces of a query tile
  const int nq = ix::query_tiles(Sq, BQ);
  const int tile = ix::tc_tile(blockIdx.x, B, H);
  const int piece = ix::tc_piece(tile, PAGED, pg.nsplit);
  const int iq = ix::tc_query_tile(tile, nq, PAGED, pg.nsplit);
  const int bh = ix::tc_slot_head(blockIdx.x, B, H), h = bh % H, b = bh / H;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int q0 = iq * BQ;
  int off = Sk - Sq, kn = Sk;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + kh * ks.h;
  const bf16* vb = v + kh * vs.h;
  const int* tbl = nullptr;
  if constexpr (PAGED) {
    off = pg.q_start[b];
    kn = ix::paged_keys(pg.k_len[b], pg.npp, pg.ps);
    tbl = pg.pages + (size_t)b * pg.npp;
  } else {
    kb += b * ks.b;
    vb += b * vs.b;
  }

  // rows [row0, row0 + rows) of a [n, d] matrix with row stride rs into a
  // [rows][RS] shared tile; rows >= n and columns >= d are zero
  auto copy_tile = [&](bf16* dst, const bf16* src, long long rs, int row0, int n, int rows) {
    if (vec) {
      constexpr int CH = D / 8;
      for (int e = tid; e < rows * CH; e += FAT_THREADS) {
        const int r = e / CH, col = (e % CH) * 8;
        const bool ok = ix::in_edge(row0 + r, n, col, d);
        cp_async16(dst + r * RS + col, ok ? src + (row0 + r) * rs + col : src, ok);
      }
    } else {
      for (int e = tid; e < rows * D; e += FAT_THREADS) {
        const int r = e / D, col = e % D;
        const bool ok = ix::in_edge(row0 + r, n, col, d);
        dst[r * RS + col] = ok ? src[(row0 + r) * rs + col] : __float2bfloat16(0.f);
      }
    }
  };
  // paged: key rows [row0, row0 + KT) into a K and a V tile, each row's
  // pool row looked up once for both; rows >= kn and columns >= d are zero
  auto pool_row = [&](int lr) { return ix::pool_row(tbl, pg.ps, lr); };
  auto copy_paged = [&](bf16* dst_k, bf16* dst_v, int row0) {
    if (vec) {
      constexpr int CH = D / 8;
      for (int e = tid; e < KT * CH; e += FAT_THREADS) {
        const int r = e / CH, col = (e % CH) * 8;
        const bool ok = ix::in_edge(row0 + r, kn, col, d);
        const long long prow = ok ? pool_row(row0 + r) : 0;
        cp_async16(dst_k + r * RS + col, ok ? kb + prow * ks.s + col : kb, ok);
        cp_async16(dst_v + r * RS + col, ok ? vb + prow * vs.s + col : vb, ok);
      }
    } else {
      for (int e = tid; e < KT * D; e += FAT_THREADS) {
        const int r = e / D, col = e % D;
        const bool ok = ix::in_edge(row0 + r, kn, col, d);
        const long long prow = ok ? pool_row(row0 + r) : 0;
        dst_k[r * RS + col] = ok ? kb[prow * ks.s + col] : __float2bfloat16(0.f);
        dst_v[r * RS + col] = ok ? vb[prow * vs.s + col] : __float2bfloat16(0.f);
      }
    }
  };

  // key tiles live for some row of the block: [t_first, t_first + ntiles);
  // paged: within the block's piece of the slot's keys
  int key_lo, key_hi;
  ix::tile_keys(q0, BQ, Sq, off, kn, causal, window, key_lo, key_hi);
  // paged: the query tile's live pieces [plo, phi], a function of the
  // slot's own rows that every block computes; blocks of other pieces exit
  // at once (piece 0 of a tile with no key writes its zeros), and a tile
  // with one live piece writes its output directly (index.cuh's decisions)
  int plo = 0, phi = 0;
  if (ix::tile_has_pieces(PAGED, key_lo, key_hi)) {
    plo = ix::piece_of(key_lo);
    phi = ix::piece_of(key_hi);
  }
  if (ix::piece_exits(PAGED, piece, plo, phi)) return;
  key_lo = ix::piece_key_lo(PAGED, key_lo, piece);
  key_hi = ix::piece_key_hi(PAGED, key_hi, piece);
  const int t_first = ix::first_tile(key_lo, KT);
  const int ntiles = ix::tile_count(key_lo, key_hi, KT, t_first);
  auto load_kv = [&](int t) {  // tile t into stage t % ST
    bf16* ks_ = kv_s + (t % ST) * 2 * KT * RS;
    if constexpr (PAGED) {
      copy_paged(ks_, ks_ + KT * RS, (t_first + t) * KT);
    } else {
      copy_tile(ks_, kb, ks.s, (t_first + t) * KT, kn, KT);
      copy_tile(ks_ + KT * RS, vb, vs.s, (t_first + t) * KT, kn, KT);
    }
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
    const bool edge = t0 + KT > kn || (causal && t0 + KT - 1 > wlo) ||
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
          if (!ix::key_valid(kp, qp, kn, causal, window)) x = NEG;
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
  float lsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] = l[i];
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
  }
  if constexpr (PAGED) {
    if (ix::piece_merges(plo, phi)) {  // partial, ticket, and the last block merges
      __shared__ int last;
      const int pidx = ix::piece_group(b, h, iq, H, nq);
      const size_t pstride = (size_t)BQ * (d + 2);
      const float* base = pg.part + ix::piece_slot(pidx, pg.nsplit, 0) * pstride;
      float* mine = pg.part + ix::piece_slot(pidx, pg.nsplit, piece) * pstride;  // O, m, l
      const bool even = (d & 1) == 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp * 16 + g + 8 * i;
        if (c == 0) {
          mine[BQ * d + row] = m[i];
          mine[BQ * d + BQ + row] = lsum[i];
        }
        if (ntiles == 0) continue;  // the merge skips a partial whose sum is 0
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = 8 * j + 2 * c;
          float* dst = mine + row * d + col;
          if (even && col + 1 < d) {
            *reinterpret_cast<float2*>(dst) = make_float2(o[j][2 * i], o[j][2 * i + 1]);
          } else {
            if (col < d) dst[0] = o[j][2 * i];
            if (col + 1 < d) dst[1] = o[j][2 * i + 1];
          }
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) last = atomicAdd(&pg.counter[pidx], 1) == ix::piece_tickets(plo, phi) - 1;
      __syncthreads();
      if (!last) return;
      __threadfence();
      // merge factors 2^(m_p - M) per (piece, row), then 1 / sum, in shared
      // memory (the ring is free: every warp has passed its last tile); the
      // m and l of every live piece come in one sweep
      const int nlive = ix::piece_tickets(plo, phi);
      base += (size_t)plo * pstride;  // the live pieces' partials
      float* fac = reinterpret_cast<float*>(fat_smem_raw);  // [nlive][BQ] m, then factors
      float* ls_ = fac + nlive * BQ;                         // [nlive][BQ] l
      float* inv = ls_ + nlive * BQ;                         // [BQ]
      for (int e = tid; e < nlive * BQ; e += FAT_THREADS) {
        const float* pp = base + (e / BQ) * pstride + BQ * d + e % BQ;
        fac[e] = __ldcg(pp);
        ls_[e] = __ldcg(pp + BQ);
      }
      __syncthreads();
      for (int row = tid; row < BQ; row += FAT_THREADS) {
        float mm = NEG;
        for (int p = 0; p < nlive; ++p)
          if (ls_[p * BQ + row] > 0.f) mm = fmaxf(mm, fac[p * BQ + row]);
        float ls = 0.f;
        for (int p = 0; p < nlive; ++p) {  // piece order
          const float lp = ls_[p * BQ + row];
          const float f = lp > 0.f ? exp2_ftz(fac[p * BQ + row] - mm) : 0.f;
          fac[p * BQ + row] = f;
          ls = fmaf(lp, f, ls);
        }
        inv[row] = 1.f / fmaxf(ls, 1e-30f);
      }
      __syncthreads();
      // O = sum over pieces of fac * O_p, in piece order; MG 16-byte groups
      // a thread per pass.  A live piece wrote all of its O (0 where a row
      // had no key), so every load is unconditional and a piece's MG loads
      // are in flight at once.
      constexpr int MG = 8;
      const int vw = d % 4 == 0 ? 4 : 1;  // floats a load
      const int n = BQ * d / vw;
      for (int e0 = tid; e0 < n; e0 += MG * FAT_THREADS) {
        float a[MG][4];
        int row[MG];
#pragma unroll
        for (int i = 0; i < MG; ++i) {
          row[i] = min(e0 + i * FAT_THREADS, n - 1) * vw / d;
#pragma unroll
          for (int w = 0; w < 4; ++w) a[i][w] = 0.f;
        }
#pragma unroll 2
        for (int p = 0; p < nlive; ++p) {
          const float* src = base + p * pstride;
#pragma unroll
          for (int i = 0; i < MG; ++i) {
            const int e = min(e0 + i * FAT_THREADS, n - 1);
            const float f = fac[p * BQ + row[i]];
            if (vw == 4) {
              const float4 x = __ldcg(reinterpret_cast<const float4*>(src) + e);
              a[i][0] = fmaf(x.x, f, a[i][0]);
              a[i][1] = fmaf(x.y, f, a[i][1]);
              a[i][2] = fmaf(x.z, f, a[i][2]);
              a[i][3] = fmaf(x.w, f, a[i][3]);
            } else {
              a[i][0] = fmaf(__ldcg(src + e), f, a[i][0]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MG; ++i) {
          const int e = e0 + i * FAT_THREADS;
          if (e >= n || q0 + row[i] >= Sq) continue;
          const int col = e * vw - row[i] * d;
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (w < vw)
              ob[(q0 + row[i]) * os.s + col + w] = __float2bfloat16(a[i][w] * inv[row[i]]);
        }
      }
      if (tid == 0) pg.counter[pidx] = 0;  // every block has drawn its ticket
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Sq) continue;
    const float inv_l = 1.f / fmaxf(lsum[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < d) ob[row * os.s + col] = __float2bfloat16(o[j][2 * i] * inv_l);
      if (col + 1 < d) ob[row * os.s + col + 1] = __float2bfloat16(o[j][2 * i + 1] * inv_l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FAT_THREADS)
flash_attention_dense_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ out, Strides3 qs, Strides3 ks,
                                Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                                int Sk, int d, int causal, int window, float scale,
                                float softcap, int vec, Paged pg) {
  fat_body<D, false>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d, causal, window, scale,
                     softcap, vec, pg);
}

// One block an SM is all a 64-row chunk needs; the minimum lets ptxas keep
// the page lookups and the merge in registers (no spills at D = 128).
template <int D>
__global__ void __launch_bounds__(FAT_THREADS, 1)
flash_attention_paged_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ out, Strides3 qs, Strides3 ks,
                                Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                                int Sk, int d, int causal, int window, float scale,
                                float softcap, int vec, Paged pg) {
  fat_body<D, true>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d, causal, window, scale,
                    softcap, vec, pg);
}

template <int D, bool PAGED>
int launch_dense_tc(const void* q, const void* k, const void* v, void* out, Strides3 qs,
                    Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                    int Sk, int d, int causal, int window, float scale, float softcap,
                    Paged pg, cudaStream_t stream) {
  // 16-byte cp.async needs 16-byte aligned rows: d, every stride and every
  // base a multiple of 8 elements
  auto rows16 = [](const void* p, const Strides3& st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 && st.h % 8 == 0 &&
           st.s % 8 == 0;
  };
  const bool vec = d % 8 == 0 && rows16(q, qs) && rows16(k, ks) && rows16(v, vs);
  // the split's merge keeps m (then the factor) and l per (piece, row) and
  // 1/sum per row
  int smem = fat_smem(D);
  const int merge = static_cast<int>(sizeof(float)) * (2 * pg.nsplit + 1) * FAT_BQ;
  if (PAGED && pg.nsplit > 1 && merge > smem) smem = merge;
  auto kern = PAGED ? flash_attention_paged_tc_kernel<D> : flash_attention_dense_tc_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      (unsigned)ix::query_tiles(Sq, FAT_BQ) * (PAGED ? pg.nsplit : 1) * B * H;
  kern<<<blocks, FAT_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), qs, ks, vs,
      os, B, H, Kh, Sq, Sk, d, causal, window, scale, softcap, vec ? 1 : 0, pg);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch_dense_tc(const void* q, const void* k, const void* v, void* out, Strides3 qs,
                      Strides3 ks, Strides3 vs, Strides3 os, int B, int H, int Kh, int Sq,
                      int Sk, int d, int causal, int window, float scale, float softcap,
                      Paged pg, cudaStream_t s) {
#define REPRO_FAT(D)                                                                   \
  return launch_dense_tc<D, PAGED>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d, \
                                   causal, window, scale, softcap, pg, s)
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
  const repro::Paged none{};
  if (is_bf16)
    return repro::dispatch_dense_tc<false>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk, d,
                                           causal, window, scale, softcap, none, s);
  return repro::dispatch_dense<float, false>(q, k, v, out, qs, ks, vs, os, B, H, Kh, Sq, Sk,
                                             d, causal, window, scale, softcap, none, s);
}

// Paged chunk prefill.  q [B,H,C,d] and out [B,H,C,d], each given by base
// pointer and (batch, head, row) strides (q_strides, o_strides) with unit
// stride along d; k/v pools [P,ps,Kh,d] (contiguous; v may be k); pages
// [B,npp]; q_start, k_len [B].  bf16 with nsplit > 1: part holds
// B*H*ceil(C/64)*nsplit*64*(d+2) f32 and counter B*H*ceil(C/64) int32, all
// 0 (every launch leaves them 0 again); nsplit = ceil(npp*ps / 128).  f32
// reads neither.  window <= 0 and softcap <= 0 are off.  One launch.
extern "C" int repro_flash_attention_paged(const void* q, const void* k, const void* v,
                                           const void* pages, const void* q_start,
                                           const void* k_len, void* part, void* counter,
                                           void* out, const long long* q_strides,
                                           const long long* o_strides, int B, int H,
                                           int Kh, int C, int d, int ps, int npp,
                                           int nsplit, int window, float scale,
                                           float softcap, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long S = (long long)npp * ps;
  if (is_bf16 && ((long long)(nsplit - 1) * repro::FAP_SPLIT >= S ||
                  (long long)nsplit * repro::FAP_SPLIT < S))
    return static_cast<int>(cudaErrorInvalidValue);
  const repro::Strides3 qs{q_strides[0], q_strides[1], q_strides[2]};
  const repro::Strides3 os{o_strides[0], o_strides[1], o_strides[2]};
  // a pool row is [Kh][d]: kv-head kh at kh*d, row stride Kh*d
  const repro::Strides3 kvs{0, d, (long long)Kh * d};
  const repro::Paged pg{static_cast<const int*>(pages), static_cast<const int*>(q_start),
                        static_cast<const int*>(k_len), static_cast<float*>(part),
                        static_cast<int*>(counter), npp, ps, is_bf16 ? nsplit : 1};
  if (is_bf16)
    return repro::dispatch_dense_tc<true>(q, k, v, out, qs, kvs, kvs, os, B, H, Kh, C, 0, d,
                                          1, window, scale, softcap, pg, s);
  return repro::dispatch_dense<float, true>(q, k, v, out, qs, kvs, kvs, os, B, H, Kh, C, 0,
                                            d, 1, window, scale, softcap, pg, s);
}
