// The index arithmetic and the block decisions of the hand-written
// kernels, in one place.
//
// Every line that turns a block's coordinates and the call's scalars
// (pos, start, q_start, k_len, a page table, K and its splits) into the
// rows, pages, tiles, partial slots and tickets a block touches lives
// here, and so does every decision a block takes on them: whether it exits
// at once (and whether it writes a drained slot's zeros), its live block or
// piece range, which rows or key tiles it walks, whether it writes its
// output directly or through a partial and a ticket, how many tickets its
// group's last block waits for, whether a GEMM split reads K and how its
// tile is stored, which tiles a persistent block walks, and the edge masks
// of the flash attention K/V/Q loads and the tensor-core GEMMs' loads and
// stores.  The .cu files include this header for their kernels, and
// csrc/index_host.cpp includes it for the host enumerators that
// repro_torch.analysis.bounds loads with ctypes and walks over every block
// against hostile scalars (rules K001-K003).  So the bounds proofs read the
// very functions the kernels run: no index arithmetic and no block
// decision exists twice.
//
// Under nvcc the functions are __host__ __device__ __forceinline__ and
// compile into the kernels as the expressions they replace did; a host
// compiler sees plain inline functions.  Each returns one value, and where
// a spelling moved ptxas's register allocation the call keeps the kernel's
// old shape: a live range's two ends assigned in one branch whose
// condition is the header's (decode_cut_to_live, tile_has_pieces), a ring
// block's rows chosen by a ternary at the call, the CUDA-core key loop run
// while core_tile_live, two GEMM loads masked by two inside() calls.
// Hand-written in the kernels still: a warp's lanes and a tile's fragments,
// the flash-decode loads' column masks and score mask (decode_attention.cu),
// the flash kernels' query-row and column masks of their Q loads (CUDA-core
// route) and output stores, the f32 GEMM's masks (block_gemm.cu,
// gemm_f32_kernel), and the persistent int8 kernel's stores (block_gemm_int8.cu,
// store_tile; its loads are TMA's, bounded by the tensor maps).
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>  // min / max on the card
#endif

#ifdef __CUDACC__
#define REPRO_HD __host__ __device__ __forceinline__
#define REPRO_HDC __host__ __device__ constexpr
#else
#define REPRO_HD inline
#define REPRO_HDC constexpr
#endif

namespace repro {
namespace ix {

// min / max: CUDA's integer intrinsics on the card (the kernels' own
// spelling before the header, so their code is unchanged), on the host
// plain comparisons.
#ifdef __CUDA_ARCH__
REPRO_HD int imin(int a, int b) { return min(a, b); }
REPRO_HD int imax(int a, int b) { return max(a, b); }
#else
REPRO_HD int imin(int a, int b) { return a < b ? a : b; }
REPRO_HD int imax(int a, int b) { return a > b ? a : b; }
#endif

// The edge masks of the flash attention and GEMM loads and stores: index i
// lies inside an extent n; element (i, j) inside extents (ni, nj).
REPRO_HD bool inside(int i, int n) { return i < n; }
REPRO_HD bool in_edge(int i, int ni, int j, int nj) { return inside(i, ni) && inside(j, nj); }

// ---- flash-decode (decode_attention.cu) ------------------------------------

constexpr int SD_ROWS = 64;  // logical cache rows a block: 8 warps x 8 rows

// Ring layout: entry r of an S-row buffer holds absolute row
// a = pos - ((pos - r) mod S), the mod floored (C++ % truncates toward
// zero); the entry is live iff a >= 0 and a >= start.
REPRO_HD bool ring_live(int r, int p_b, int s_b, int S) {
  const int a = p_b - (((p_b - r) % S + S) % S);
  return a >= 0 && a >= s_b;
}

// Validity of logical row r of a slot: linear and paged, start <= r <= pos;
// ring as above.
REPRO_HD bool decode_row_valid(int r, int p_b, int s_b, int S, int ring) {
  if (ring) return ring_live(r, p_b, s_b, S);
  return r >= s_b && r <= p_b;
}

// Storage row of logical row r of slot b in a slot cache [B, S, ...].
REPRO_HD size_t slot_row(int S, int b, int r) { return (size_t)b * S + r; }

// Page-table entry of logical row r: the page index clipped to npp - 1, as
// the Pallas index map clips it (a frozen slot names row S).
REPRO_HD int page_entry(int r, int ps, int npp) { return imin(r / ps, npp - 1); }

// Pool row of logical row r of slot b: pages[b, page_entry] * ps + r % ps.
// The tables are templates so that the host enumerators can pass a table
// that records every index read; the kernels pass a const int*.
template <typename Tbl>
REPRO_HD size_t page_row(const Tbl& pages, int ps, int npp, int b, int r) {
  return (size_t)pages[(size_t)b * npp + page_entry(r, ps, npp)] * ps + r % ps;
}

// Row blocks of a slot's S logical rows: the grid's x.
REPRO_HD int decode_blocks(int S) { return (S + SD_ROWS - 1) / SD_ROWS; }

// The logical rows of block blk: [r0, r0 + jn).
REPRO_HD int block_first_row(int blk) { return blk * SD_ROWS; }
REPRO_HD int block_rows(int r0, int S) { return imin(SD_ROWS, S - r0); }

// Pools: the blocks that take part are those overlapping [start, pos] --
// [first_live_block, last_live_block] when the slot has rows, none when it
// is drained.  (Slot caches: every block.)
REPRO_HD bool slot_has_rows(int p_b, int s_b, int S) {
  return s_b <= p_b && p_b >= 0 && s_b < S;
}
REPRO_HD int first_live_block(int s_b) { return imax(s_b, 0) / SD_ROWS; }
REPRO_HD int last_live_block(int p_b, int S) { return imin(p_b, S - 1) / SD_ROWS; }

// The blocks [blo, bhi] of a slot that take part (paged: the pool
// instantiation), a function of the slot's own rows that every block
// computes: from block 0 to decode_last_block -- a slot cache's every
// block, a pool's none (a drained slot) -- unless decode_cut_to_live: a
// pool's slot with rows, whose blocks overlapping [start, pos] take part.
// (Both ends are assigned in one branch: two selects moved the registers.)
REPRO_HD int decode_last_block(int paged, int nblk) { return paged ? -1 : nblk - 1; }
REPRO_HD bool decode_cut_to_live(int paged, int p_b, int s_b, int S) {
  return paged && slot_has_rows(p_b, s_b, S);
}
REPRO_HD int decode_live_blocks(int blo, int bhi) { return bhi - blo + 1; }

// A pool's block outside [blo, bhi] exits at once ...
REPRO_HD bool decode_block_exits(int paged, int blk, int blo, int bhi) {
  return paged && (blk < blo || blk > bhi);
}
// ... and block 0 of a slot with no live block writes the slot's zeros.
REPRO_HD bool decode_zero_writer(int blk, int nlive) { return nlive <= 0 && blk == 0; }

// Whether a block reads rows: a slot with start <= pos, and for the
// linear and paged layouts a block overlapping [start, pos].
REPRO_HD bool decode_block_live(int r0, int jn, int p_b, int s_b, int ring) {
  return s_b <= p_b && (ring || (r0 <= p_b && r0 + jn > s_b));
}

// The rows [j_lo, j_hi] of a live block that are read: a ring block's all
// jn rows; a linear or paged block's rows in [start, pos].  (The layout's
// choice between them stays a ternary at the call: folded into one
// function it moved ptxas's register allocation.)
REPRO_HD int ring_first_row() { return 0; }
REPRO_HD int ring_last_row(int jn) { return jn - 1; }
REPRO_HD int rows_from(int s_b, int r0) { return imax(s_b - r0, 0); }
REPRO_HD int rows_to(int p_b, int r0, int jn) { return imin(p_b - r0, jn - 1); }
REPRO_HD bool decode_reads_row(int j, int j_lo, int j_hi) { return j >= j_lo && j <= j_hi; }

// A pool's lone live block writes its output directly: the merge of one
// partial, without a partial or a ticket.
REPRO_HD bool decode_writes_direct(int paged, int nlive) { return paged && nlive == 1; }

// The tickets a (slot, kv-head, head group)'s last block waits for, the
// count its ticket test and the enumerator's TICKET event both take: one
// for each block that takes part, none where a pool's lone live block
// writes directly.
REPRO_HD int decode_tickets(int paged, int nlive) { return paged && nlive == 1 ? 0 : nlive; }

// Grid (row blocks, Kh * ng, B), y = blockIdx.y (unsigned, as the kernels
// divide it): the block's kv-head, the heads of its group, its first query
// head, and the (slot, kv-head, head group) whose ticket and partials it
// uses.
REPRO_HD int group_kv_head(unsigned y, int ng) { return y / ng; }
REPRO_HD int group_heads(int H, int Kh, int ng) { return H / Kh / ng; }
REPRO_HD int group_first_head(unsigned y, int kh, int H, int Kh, int ng, int G) {
  return kh * (H / Kh) + (y % ng) * G;
}
REPRO_HD int group_index(unsigned y, int b, int Kh, int ng) { return b * Kh * ng + y; }

// ---- flash attention (flash_attention.cu) ----------------------------------

constexpr int FAP_SPLIT = 128;  // key rows per piece of a paged slot (bf16)

// Paged: the slot's key rows, k_len clipped to the table's npp * ps rows.
REPRO_HD int paged_keys(int k_len, int npp, int ps) { return imin(k_len, npp * ps); }

// Pool row of key row r of a slot whose table row is tbl.
template <typename Tbl>
REPRO_HD long long pool_row(const Tbl& tbl, int ps, int r) {
  return (long long)tbl[r / ps] * ps + r % ps;
}

// The keys a query tile [q0, q0 + bq) at offset off can see: [key_lo,
// key_hi] (none when key_hi < key_lo).
REPRO_HD void tile_keys(int q0, int bq, int Sq, int off, int kn, int causal, int window,
                        int& key_lo, int& key_hi) {
  const int qlo = q0 + off, qhi = imin(q0 + bq, Sq) - 1 + off;
  key_hi = causal ? imin(kn - 1, qhi) : kn - 1;
  key_lo = window > 0 ? imax(0, qlo - window + 1) : 0;
}

// Whether query position qpos sees key position kpos.
REPRO_HD bool key_valid(int kpos, int qpos, int kn, int causal, int window) {
  bool ok = kpos < kn;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// The tensor-core route's tiles: head dims padded to D, a power of two in
// 16..256; key tiles of 64 rows, 32 past D = 128.
REPRO_HDC int fat_kt(int D) { return D > 128 ? 32 : 64; }

// Query tiles of bq rows over Sq rows.
REPRO_HD int query_tiles(int Sq, int bq) { return (Sq + bq - 1) / bq; }

// The tensor-core route's block x (blockIdx.x) -> (query tile, piece,
// slot, head): heaviest causal query tile first, the heads of one kv-head
// side by side, then (paged) the key pieces of a query tile.
REPRO_HD int tc_tile(unsigned x, int B, int H) { return static_cast<int>(x / (B * H)); }
REPRO_HD int tc_piece(int tile, bool paged, int nsplit) { return paged ? tile % nsplit : 0; }
REPRO_HD int tc_query_tile(int tile, int nq, bool paged, int nsplit) {
  return nq - 1 - (paged ? tile / nsplit : tile);
}
REPRO_HD int tc_slot_head(unsigned x, int B, int H) { return x % (B * H); }  // b * H + h

// Paged: the piece of key row k; a query tile's live pieces are those of
// its first and last key ([plo, phi], a function of the slot's own rows);
// a piece's share of the tile's keys [key_lo, key_hi].
REPRO_HD int piece_of(int k) { return k / FAP_SPLIT; }
REPRO_HD int piece_lo(int key_lo, int piece) { return imax(key_lo, piece * FAP_SPLIT); }
REPRO_HD int piece_hi(int key_hi, int piece) {
  return imin(key_hi, piece * FAP_SPLIT + FAP_SPLIT - 1);
}

// split: the tensor-core route over pools, its keys cut into pieces.  The
// query tile's live pieces [plo, phi]: [0, 0] unsplit or with no key, else
// the pieces of its first and last key (tile_has_pieces; assigned in one
// branch); a block of another piece exits at once (piece 0 of a tile with
// no key writes its zeros); a live piece's clipped keys.
REPRO_HD bool tile_has_pieces(int split, int key_lo, int key_hi) {
  return split && key_hi >= key_lo;
}
REPRO_HD bool piece_exits(int split, int piece, int plo, int phi) {
  return split && (piece < plo || piece > phi);
}
REPRO_HD int piece_key_lo(int split, int key_lo, int piece) {
  return split ? piece_lo(key_lo, piece) : key_lo;
}
REPRO_HD int piece_key_hi(int split, int key_hi, int piece) {
  return split ? piece_hi(key_hi, piece) : key_hi;
}

// A tile with more than one live piece writes each piece's partial and
// takes a ticket; with one it writes its output directly.  The tickets its
// last block waits for, one a live piece, are the partials it merges.
REPRO_HD bool piece_merges(int plo, int phi) { return phi > plo; }
REPRO_HD int piece_tickets(int plo, int phi) { return phi - plo + 1; }

// The CUDA-core route's first key row: the tile of key_lo, or kn (no
// tile) when the block sees no key; and whether the kt-row key tile from
// t0 is walked: those that start at or before key_hi.  (A loop over a
// count of tiles moved ptxas's register allocation.)
REPRO_HD int first_key_row(int key_lo, int key_hi, int kt, int kn) {
  return key_hi >= key_lo ? (key_lo / kt) * kt : kn;
}
REPRO_HD bool core_tile_live(int t0, int key_hi, int kt) { return t0 <= key_hi; }

// The key tiles of kt rows a block walks: [t_first, t_first + ntiles).
REPRO_HD int first_tile(int key_lo, int kt) { return key_lo / kt; }
REPRO_HD int tile_count(int key_lo, int key_hi, int kt, int t_first) {
  return key_hi >= key_lo ? key_hi / kt - t_first + 1 : 0;
}

// The split's ticket counter of (slot, head, query tile), and the partial
// slot of one of its pieces.
REPRO_HD int piece_group(int b, int h, int iq, int H, int nq) { return (b * H + h) * nq + iq; }
REPRO_HD size_t piece_slot(int pidx, int nsplit, int piece) {
  return (size_t)pidx * nsplit + piece;
}

// ---- block GEMMs (block_gemm.cu, block_gemm_int8.cu) -----------------------

// The bf16 GEMM's tile for M rows with K split `splits` ways: decode rows
// take one m16 tile, 128 columns where K is split and 64 where it is not;
// more rows take 64 x 64.
REPRO_HD void bf16_tile(int M, int splits, int& bm, int& bn) {
  bm = M <= 16 ? 16 : 64;
  bn = M <= 16 && splits > 1 ? 128 : 64;
}

// The int8 GEMM's tile on each route of block_gemm.int8_route: 0, 16 rows
// (16 x 32 unsplit, 16 x 128 split); 1, 64 x 128; 2 / 3, the persistent
// kernel's 128 x 128 / 128 x 256.
REPRO_HD void int8_tile(int route, int splits, int& bm, int& bn) {
  bm = route == 0 ? 16 : route == 1 ? 64 : 128;
  bn = route == 0 ? (splits == 1 ? 32 : 128) : route == 3 ? 256 : 128;
}

// The grid of a bm x bn tiling with K split `splits` ways: x = column
// tile * splits + split, y = row tile.
REPRO_HD void gemm_grid(int M, int N, int bm, int bn, int splits, int& gx, int& gy) {
  gx = ((N + bn - 1) / bn) * splits;
  gy = (M + bm - 1) / bm;
}

// Grid x = column tile * splits + split, y = row tile (blockIdx.x, .y):
// the block's output tile origin.
REPRO_HD void gemm_tile(unsigned x, unsigned y, int bm, int bn, int splits, int& m0, int& n0) {
  m0 = y * bm;
  n0 = (x / splits) * bn;
}

// kc: ceil(K / splits) rounded up to `round` -- a function of (K, splits).
REPRO_HD int split_chunk(int K, int splits, int round) {
  return ((K + splits - 1) / splits + round - 1) / round * round;
}

// Split s sums k in [kbeg, kend).
REPRO_HD void split_range(int split, int kc, int K, int& kbeg, int& kend) {
  kbeg = split * kc;
  kend = imin(K, kbeg + kc);
}

// k-tile depths: the bf16 kernel's, the int8 kernels'.
constexpr int BF16_BK = 64;
constexpr int INT8_BK = 128;

// Whether a split has K rows to read (one past K reads nothing and sums
// zeros), and the bk-deep k tiles it walks.
REPRO_HD bool split_reads(int kbeg, int kend) { return kend > kbeg; }
REPRO_HD int split_k_tiles(int kbeg, int kend, int bk) {
  return split_reads(kbeg, kend) ? (kend - kbeg + bk - 1) / bk : 0;
}
// The persistent kernel's k tiles: K whole.
REPRO_HD int whole_k_tiles(int K, int bk) { return (K + bk - 1) / bk; }

// A tile split over K is summed over a cluster of its splits, the block's
// rank there its split (0 when the tile is not split); an unsplit tile is
// stored directly by its one block.
REPRO_HD bool gemm_clustered(int splits) { return splits > 1; }
REPRO_HD bool gemm_stores_direct(int splits) { return splits == 1; }

// The cluster reduce: split s stores the flattened [rows][bn / 4] float4
// groups [e0, e1) of the tile, rows = min(bm, M - m0).
REPRO_HD void reduce_slice(int split, int splits, int bm, int bn, int M, int m0, int& e0,
                           int& e1) {
  const int rows = imin(bm, M - m0);
  const int n4 = rows * (bn / 4), per = (n4 + splits - 1) / splits;
  e0 = split * per;
  e1 = imin(n4, (split + 1) * per);
}

// The persistent int8 kernel: its row tiles mt, its tiles, and its grid
// (one block a tile up to one an SM).
REPRO_HD void walk_grid(int M, int N, int bm, int bn, int sms, int& mt, int& tiles, int& grid) {
  mt = (M + bm - 1) / bm;
  tiles = mt * ((N + bn - 1) / bn);
  grid = tiles < sms ? tiles : sms;
}

// The persistent int8 kernel's walk: block blk takes tiles blk, blk +
// grid, ... (grid: the launch's blocks).
REPRO_HD int walk_first(unsigned blk) { return static_cast<int>(blk); }
REPRO_HD int walk_stride(unsigned grid) { return static_cast<int>(grid); }

// The persistent int8 kernel's tiles, walked m-first: tile t -> origin.
REPRO_HD void walk_tile(int t, int mt, int bm, int bn, int& m0, int& n0) {
  m0 = (t % mt) * bm;
  n0 = (t / mt) * bn;
}

}  // namespace ix
}  // namespace repro
