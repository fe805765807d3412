// Host enumerators of the kernels' address arithmetic, for the bounds
// proofs of repro_torch.analysis.bounds (rules K001-K003).
//
// Built by the host compiler alone (kernels/_build.py, host_library), never
// by nvcc, and loaded with ctypes.  Each enumerator walks every block of a
// kernel's grid and takes from index.cuh, the header the kernels include,
// both every address and every decision the kernel's blocks take: which
// blocks exit at once, which rows or key tiles a block reads, whether it
// writes its output directly or through a partial and a ticket, how many
// tickets its group waits for, which tiles a persistent block walks, and
// the flash and GEMM edge masks its read and write rectangles are cut by
// (mask_end below).  What is left here is the loops that record events: no
// condition on pos, start, k_len, pieces or splits that the header does
// not give.  So a proof covers the arithmetic and the block-level control
// flow the card runs, not a copy of them.  Not covered: the loops inside a
// block (a warp's lanes, a tile's fragments) and the masks index.cuh's
// head comment lists as staying in the kernels.
//
// Output: events of 9 int64 each, [block, kind, op, r0, r1, c0, c1, x0, x1]
// (kinds below; rows [r0, r1) and columns [c0, c1) of operand op, whose
// numbering each enumerator's comment gives).  An enumerator writes at most
// `cap` events and returns how many it produced; the caller grows the
// buffer and calls again when that is more.  Every page-table read the
// header makes is recorded (a TABLE event with the flat index it read), and
// a read outside the table returns 0 instead of touching memory.
#include <stdint.h>

#include "index.cuh"

namespace {

enum Kind : int64_t {
  READ = 0,     // op rows [r0, r1) x cols [c0, c1); x0 logical row, x1 slot (-1: n/a)
  TABLE = 1,    // page-table entry r0 read; x0 logical row, x1 slot
  WRITE = 2,    // op rows x cols stored by the block; x1 the ticket group (-1: direct)
  TICKET = 3,   // a ticket of group x1 (r0 the counter); x0 tickets the group expects;
                // the last holder merges partial slots [c0, c1)
  PARTIAL = 4,  // partial slot r0 written; x1 the group
  NAMED = 5,    // the address function at a row the scalars name: op row r0 for
                // logical row x0 of slot x1 (rule K001's totality check)
};

struct Sink {
  int64_t* ev;
  int64_t cap, n = 0;
  int64_t block = 0;
  void emit(int64_t kind, int64_t op, int64_t r0, int64_t r1, int64_t c0, int64_t c1,
            int64_t x0 = -1, int64_t x1 = -1) {
    if (n < cap) {
      int64_t* e = ev + 9 * n;
      e[0] = block;
      e[1] = kind;
      e[2] = op;
      e[3] = r0;
      e[4] = r1;
      e[5] = c0;
      e[6] = c1;
      e[7] = x0;
      e[8] = x1;
    }
    ++n;
  }
};

// A page table [B, npp] (or one slot's row of it, at `off`) whose every
// read is recorded; a read outside the table yields 0.
struct Table {
  const int* a;
  int64_t size, off;
  Sink* sink;
  int64_t row = -1, slot = -1;  // what the next reads are for
  int64_t table_op;
  int operator[](size_t i) const {
    const int64_t at = off + static_cast<int64_t>(i);
    sink->emit(TABLE, table_op, at, at + 1, 0, 1, row, slot);
    return at >= 0 && at < size ? a[at] : 0;
  }
};

namespace ix = repro::ix;

// The end of the masked run of [lo, lo + n): the first index the kernels'
// edge mask ix::inside(i, end) refuses, lo + n when it refuses none.
int mask_end(int lo, int n, int end) {
  int i = lo;
  while (i < lo + n && ix::inside(i, end)) ++i;
  return i;
}

}  // namespace

// Flash-decode (decode_attention.cu, flash_decode_slot_kernel), grid
// (decode_blocks(S), Kh * ng, B).  Operands: 0 q [B*H, dq], 1 k rows of
// [Kh*dq], 2 v rows of [Kh*v_row] (slot caches B*S rows, pools P*ps), 3 out
// [B*H, dv], 4 partial slots (one per (slot, kv-head, head group), row
// block), 5 tickets, 6 pages [B*npp].  paged: pools through pages (linear
// validity), else slot caches (ring or linear).  Named rows: every logical
// row in [0, S] of every slot (pos and start range over it).
extern "C" int64_t repro_enum_decode(int B, int H, int Kh, int ng, int S, int dq, int dv,
                                     int v_row, int ring, int paged, int ps, int npp,
                                     const int* pos, const int* start, const int* pages,
                                     int64_t* ev, int64_t cap) {
  Sink sink{ev, cap};
  Table tbl{pages, (int64_t)B * npp, 0, &sink, -1, -1, 6};
  const int nblk = ix::decode_blocks(S);
  if (paged) {
    sink.block = -1;
    for (int b = 0; b < B; ++b)
      for (int r = 0; r <= S; ++r) {
        tbl.row = r;
        tbl.slot = b;
        sink.emit(NAMED, 1, (int64_t)ix::page_row(tbl, ps, npp, b, r), 0, 0, 0, r, b);
      }
  }
  int64_t block = 0;
  for (int b = 0; b < B; ++b)
    for (int y = 0; y < Kh * ng; ++y)
      for (int blk = 0; blk < nblk; ++blk, ++block) {
        sink.block = block;
        const unsigned uy = static_cast<unsigned>(y);
        const int kh = ix::group_kv_head(uy, ng), G = ix::group_heads(H, Kh, ng);
        const int h0 = ix::group_first_head(uy, kh, H, Kh, ng, G);
        const int grp = ix::group_index(uy, b, Kh, ng);
        const int p_b = pos[b], s_b = start[b];
        const int r0 = ix::block_first_row(blk), jn = ix::block_rows(r0, S);
        int blo = 0, bhi = ix::decode_last_block(paged, nblk);
        if (ix::decode_cut_to_live(paged, p_b, s_b, S)) {
          blo = ix::first_live_block(s_b);
          bhi = ix::last_live_block(p_b, S);
        }
        const int nlive = ix::decode_live_blocks(blo, bhi);
        const int64_t orow = (int64_t)b * H + h0;
        if (ix::decode_block_exits(paged, blk, blo, bhi)) {
          if (ix::decode_zero_writer(blk, nlive)) sink.emit(WRITE, 3, orow, orow + G, 0, dv);
          continue;
        }
        const int64_t slot0 = (int64_t)grp * nblk;
        if (ix::decode_block_live(r0, jn, p_b, s_b, ring)) {
          const int j_lo = ring ? ix::ring_first_row() : ix::rows_from(s_b, r0);
          const int j_hi = ring ? ix::ring_last_row(jn) : ix::rows_to(p_b, r0, jn);
          size_t sr0 = 0;
          if (!paged) sr0 = ix::slot_row(S, b, r0);
          for (int j = 0; j < ix::SD_ROWS; ++j) {
            if (!ix::decode_reads_row(j, j_lo, j_hi)) continue;
            tbl.row = r0 + j;
            tbl.slot = b;
            const int64_t sr = paged ? (int64_t)ix::page_row(tbl, ps, npp, b, r0 + j)
                                     : (int64_t)(sr0 + j);
            sink.emit(READ, 1, sr, sr + 1, (int64_t)kh * dq, (int64_t)kh * dq + dq, r0 + j, b);
            sink.emit(READ, 2, sr, sr + 1, (int64_t)kh * v_row, (int64_t)kh * v_row + dv,
                      r0 + j, b);
          }
          sink.emit(READ, 0, orow, orow + G, 0, dq);
          if (ix::decode_writes_direct(paged, nlive)) {
            sink.emit(WRITE, 3, orow, orow + G, 0, dv);
            continue;
          }
        }
        const int tickets = ix::decode_tickets(paged, nlive);
        sink.emit(PARTIAL, 4, slot0 + blk, slot0 + blk + 1, 0, 1, -1, grp);
        sink.emit(TICKET, 5, grp, grp + 1, slot0 + blo, slot0 + blo + nlive, tickets, grp);
        sink.emit(WRITE, 3, orow, orow + G, 0, dv, -1, grp);
      }
  return sink.n;
}

// Flash attention (flash_attention.cu).  tc: the tensor-core route (bf16;
// grid query_tiles(Sq, 64) * nsplit * B * H, D the padded head dim), else
// the CUDA-core route (grid (query_tiles(Sq, 64), H, B), 32-row key tiles,
// no split).  paged: k/v are pools through pages, query row i at q_start +
// i over key rows [0, paged_keys(k_len)) (Sk unused); dense: [B, Kh, Sk]
// keys, off = Sk - Sq.  Operands: 0 q rows [B*H*Sq, d], 1 k and 2 v rows
// (dense [B*Kh*Sk, d]; pools [P*ps, Kh*d]), 3 out rows [B*H*Sq, d], 4
// partial slots (per (slot, head, query tile, piece)), 5 tickets, 6 pages.
// Named rows: each slot's key rows [0, kn) for kn over paged_keys' domain.
extern "C" int64_t repro_enum_flash(int B, int H, int Kh, int Sq, int Sk, int d, int causal,
                                    int window, int tc, int D, int paged, int ps, int npp,
                                    int nsplit, const int* q_start, const int* k_len,
                                    const int* pages, int64_t* ev, int64_t cap) {
  Sink sink{ev, cap};
  const int BQ = 64, KT = tc ? ix::fat_kt(D) : 32;
  const int nq = ix::query_tiles(Sq, BQ);
  const int split = tc && paged;  // the tensor-core kernel's PAGED instantiation
  const int nsp = split ? nsplit : 1;
  // the columns a K/V or Q row load takes: the tensor-core route's D padded
  // columns cut by the edge mask at d, the CUDA-core route's d
  const int ncol = tc ? mask_end(0, D, d) : d;
  const int64_t nblocks = (int64_t)nq * nsp * B * H;
  if (paged) {
    sink.block = -1;
    for (int b = 0; b < B; ++b) {
      Table tbl{pages, (int64_t)B * npp, (int64_t)b * npp, &sink, -1, b, 6};
      const int kn = ix::paged_keys(k_len[b], npp, ps);
      for (int r = 0; r < kn; ++r) {
        tbl.row = r;
        sink.emit(NAMED, 1, ix::pool_row(tbl, ps, r), 0, 0, 0, r, b);
      }
    }
  }
  for (int64_t x = 0; x < nblocks; ++x) {
    sink.block = x;
    int iq, piece, b, h;
    if (tc) {
      const unsigned ux = static_cast<unsigned>(x);
      const int tile = ix::tc_tile(ux, B, H), bh = ix::tc_slot_head(ux, B, H);
      piece = ix::tc_piece(tile, paged != 0, nsp);
      iq = ix::tc_query_tile(tile, nq, paged != 0, nsp);
      h = bh % H;
      b = bh / H;
    } else {  // grid (nq, H, B)
      iq = static_cast<int>(x % nq);
      h = static_cast<int>((x / nq) % H);
      b = static_cast<int>(x / ((int64_t)nq * H));
      piece = 0;
    }
    const int kh = h / (H / Kh), q0 = iq * BQ;
    int off = Sk - Sq, kn = Sk;
    Table tbl{pages, (int64_t)B * npp, (int64_t)b * npp, &sink, -1, b, 6};
    if (paged) {
      off = q_start[b];
      kn = ix::paged_keys(k_len[b], npp, ps);
    }
    int key_lo, key_hi;
    ix::tile_keys(q0, BQ, Sq, off, kn, causal, window, key_lo, key_hi);
    int plo = 0, phi = 0;
    if (ix::tile_has_pieces(split, key_lo, key_hi)) {
      plo = ix::piece_of(key_lo);
      phi = ix::piece_of(key_hi);
    }
    if (ix::piece_exits(split, piece, plo, phi)) continue;
    key_lo = ix::piece_key_lo(split, key_lo, piece);
    key_hi = ix::piece_key_hi(split, key_hi, piece);
    // the key tiles [t0, t0 + ntiles * KT): the tensor-core route's
    // tile_count from first_tile, the CUDA-core route's from first_key_row
    // while core_tile_live
    const int t_first = ix::first_tile(key_lo, KT);
    const int t0 = tc ? t_first * KT : ix::first_key_row(key_lo, key_hi, KT, kn);
    int ntiles = 0;
    if (tc)
      ntiles = ix::tile_count(key_lo, key_hi, KT, t_first);
    else
      while (ix::core_tile_live(t0 + ntiles * KT, key_hi, KT)) ++ntiles;
    const int64_t qrow = ((int64_t)b * H + h) * Sq + q0;
    const int qn = mask_end(q0, BQ, Sq) - q0;
    sink.emit(READ, 0, qrow, qrow + qn, 0, ncol);
    for (int t = 0; t < ntiles; ++t) {
      const int row0 = t0 + t * KT;
      for (int r = 0; r < KT; ++r) {
        const int lr = row0 + r;
        if (!ix::inside(lr, kn)) continue;
        int64_t row, c0;
        if (paged) {
          tbl.row = lr;
          row = ix::pool_row(tbl, ps, lr);
          c0 = (int64_t)kh * d;
        } else {
          row = ((int64_t)b * Kh + kh) * Sk + lr;
          c0 = 0;
        }
        sink.emit(READ, 1, row, row + 1, c0, c0 + ncol, lr, b);
        sink.emit(READ, 2, row, row + 1, c0, c0 + ncol, lr, b);
      }
    }
    if (ix::piece_merges(plo, phi)) {
      const int pidx = ix::piece_group(b, h, iq, H, nq);
      const int tickets = ix::piece_tickets(plo, phi);
      const int64_t mine = (int64_t)ix::piece_slot(pidx, nsp, piece);
      const int64_t first = (int64_t)ix::piece_slot(pidx, nsp, plo);
      sink.emit(PARTIAL, 4, mine, mine + 1, 0, 1, -1, pidx);
      sink.emit(TICKET, 5, pidx, pidx + 1, first, first + tickets, tickets, pidx);
      sink.emit(WRITE, 3, qrow, qrow + qn, 0, d, -1, pidx);
    } else {
      sink.emit(WRITE, 3, qrow, qrow + qn, 0, d);
    }
  }
  return sink.n;
}

// The block GEMMs (block_gemm.cu; block_gemm_int8.cu on `route`, as
// block_gemm.int8_route picks it): C[M, N] = A[M, K] B[K, N] on the tile
// bf16_tile / int8_tile give, K split `splits` ways in chunks rounded to the
// kernels' 64 (bf16) or 32 (int8), a cluster of splits reducing each tile
// in slices; int8 routes 2 and 3 are the persistent kernel instead (tiles
// walked over min(tiles, sms) blocks, K whole).  Operands: 0 A [M, K], 1 B
// [K, N] (stored transposed or not, indexed logically), 2 C [M, N].  A
// block's reads are its tile's rows and its split's k tiles, cut at M, N
// and K by the kernels' edge masks (x0, x1: the output tile's origin).
extern "C" int64_t repro_enum_gemm(int M, int N, int K, int int8, int route, int splits,
                                   int sms, int64_t* ev, int64_t cap) {
  int bm, bn;
  if (int8)
    ix::int8_tile(route, splits, bm, bn);
  else
    ix::bf16_tile(M, splits, bm, bn);
  const int walk = int8 && route >= 2, round = int8 ? 32 : 64;
  const int bk = int8 ? ix::INT8_BK : ix::BF16_BK;
  Sink sink{ev, cap};
  if (walk) {  // the tensor maps bound the loads at M, N and K
    int mt, tiles, grid;
    ix::walk_grid(M, N, bm, bn, sms, mt, tiles, grid);
    for (int blk = 0; blk < grid; ++blk) {
      sink.block = blk;
      const unsigned ublk = static_cast<unsigned>(blk), ugrid = static_cast<unsigned>(grid);
      for (int t = ix::walk_first(ublk); t < tiles; t += ix::walk_stride(ugrid)) {
        int m0, n0;
        ix::walk_tile(t, mt, bm, bn, m0, n0);
        const int m1 = ix::imin(m0 + bm, M), n1 = ix::imin(n0 + bn, N);
        const int k1 = ix::imin(ix::whole_k_tiles(K, bk) * bk, K);
        sink.emit(READ, 0, m0, m1, 0, k1, m0, n0);
        sink.emit(READ, 1, 0, k1, n0, n1, m0, n0);
        sink.emit(WRITE, 2, m0, m1, n0, n1);
      }
    }
    return sink.n;
  }
  int gx, gy;
  ix::gemm_grid(M, N, bm, bn, splits, gx, gy);
  const int kc = ix::split_chunk(K, splits, round);
  for (int y = 0; y < gy; ++y)
    for (int x = 0; x < gx; ++x) {
      sink.block = (int64_t)y * gx + x;
      // the block's rank in its cluster
      const int split = ix::gemm_clustered(splits) ? x % splits : 0;
      int m0, n0, kbeg, kend;
      ix::gemm_tile(static_cast<unsigned>(x), static_cast<unsigned>(y), bm, bn, splits, m0, n0);
      ix::split_range(split, kc, K, kbeg, kend);
      const int m1 = mask_end(m0, bm, M), n1 = mask_end(n0, bn, N);
      const int kt = ix::split_k_tiles(kbeg, kend, bk);
      if (kt > 0) {
        const int k1 = mask_end(kbeg, kt * bk, kend);
        sink.emit(READ, 0, m0, m1, kbeg, k1, m0, n0);
        sink.emit(READ, 1, kbeg, k1, n0, n1, m0, n0);
      }
      if (ix::gemm_stores_direct(splits)) {
        sink.emit(WRITE, 2, m0, m1, n0, n1);
        continue;
      }
      int e0, e1;
      ix::reduce_slice(split, splits, bm, bn, M, m0, e0, e1);
      for (int e = e0; e < e1; ++e) {
        const int row = e / (bn / 4), col = (e % (bn / 4)) * 4;
        const int c1 = mask_end(n0 + col, 4, N);  // empty past N: nothing stored
        if (c1 > n0 + col) sink.emit(WRITE, 2, m0 + row, m0 + row + 1, n0 + col, c1);
      }
    }
  return sink.n;
}
