// Host enumerators of the kernels' address arithmetic, for the bounds
// proofs of repro_torch.analysis.bounds (rules K001-K003).
//
// Built by the host compiler alone (kernels/_build.py, host_library), never
// by nvcc, and loaded with ctypes.  Each enumerator walks every block of a
// kernel's grid the way the kernel's control flow does -- which blocks exit
// at once, which take a ticket, which rows a block reads, what it writes --
// and takes every address from index.cuh, the header the kernels include.
// So a proof covers the arithmetic the card runs, not a copy of it.
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

}  // namespace

using namespace repro::ix;

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
  const int nblk = decode_blocks(S);
  if (paged) {
    sink.block = -1;
    for (int b = 0; b < B; ++b)
      for (int r = 0; r <= S; ++r) {
        tbl.row = r;
        tbl.slot = b;
        sink.emit(NAMED, 1, (int64_t)page_row(tbl, ps, npp, b, r), 0, 0, 0, r, b);
      }
  }
  int64_t block = 0;
  for (int b = 0; b < B; ++b)
    for (int y = 0; y < Kh * ng; ++y)
      for (int blk = 0; blk < nblk; ++blk, ++block) {
        sink.block = block;
        const unsigned uy = static_cast<unsigned>(y);
        const int kh = group_kv_head(uy, ng), G = group_heads(H, Kh, ng);
        const int h0 = group_first_head(uy, kh, H, Kh, ng, G), grp = group_index(uy, b, Kh, ng);
        const int p_b = pos[b], s_b = start[b];
        const int r0 = block_first_row(blk), jn = block_rows(r0, S);
        int blo = 0, bhi = nblk - 1;
        if (paged) {
          bhi = -1;
          if (slot_has_rows(p_b, s_b, S)) {
            blo = first_live_block(s_b);
            bhi = last_live_block(p_b, S);
          }
        }
        const int nlive = bhi - blo + 1;
        const int64_t orow = (int64_t)b * H + h0;
        if (paged && (blk < blo || blk > bhi)) {
          if (nlive <= 0 && blk == 0) sink.emit(WRITE, 3, orow, orow + G, 0, dv);
          continue;
        }
        const int64_t slot0 = (int64_t)grp * nblk;
        if (decode_block_live(r0, jn, p_b, s_b, ring)) {
          const int j_lo = ring ? 0 : rows_from(s_b, r0);
          const int j_hi = ring ? jn - 1 : rows_to(p_b, r0, jn);
          size_t sr0 = 0;
          if (!paged) sr0 = slot_row(S, b, r0);
          for (int j = 0; j < SD_ROWS; ++j) {
            if (j < j_lo || j > j_hi) continue;
            tbl.row = r0 + j;
            tbl.slot = b;
            const int64_t sr = paged ? (int64_t)page_row(tbl, ps, npp, b, r0 + j)
                                     : (int64_t)(sr0 + j);
            sink.emit(READ, 1, sr, sr + 1, (int64_t)kh * dq, (int64_t)kh * dq + dq, r0 + j, b);
            sink.emit(READ, 2, sr, sr + 1, (int64_t)kh * v_row, (int64_t)kh * v_row + dv,
                      r0 + j, b);
          }
          sink.emit(READ, 0, orow, orow + G, 0, dq);
          if (paged && nlive == 1) {
            sink.emit(WRITE, 3, orow, orow + G, 0, dv);
            continue;
          }
        }
        sink.emit(PARTIAL, 4, slot0 + blk, slot0 + blk + 1, 0, 1, -1, grp);
        sink.emit(TICKET, 5, grp, grp + 1, slot0 + blo, slot0 + blo + nlive, nlive, grp);
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
  const int BQ = 64, KT = tc ? fat_kt(D) : 32;
  const int nq = query_tiles(Sq, BQ);
  const int nsp = tc && paged ? nsplit : 1;
  const int64_t nblocks = (int64_t)nq * nsp * B * H;
  if (paged) {
    sink.block = -1;
    for (int b = 0; b < B; ++b) {
      Table tbl{pages, (int64_t)B * npp, (int64_t)b * npp, &sink, -1, b, 6};
      const int kn = paged_keys(k_len[b], npp, ps);
      for (int r = 0; r < kn; ++r) {
        tbl.row = r;
        sink.emit(NAMED, 1, pool_row(tbl, ps, r), 0, 0, 0, r, b);
      }
    }
  }
  for (int64_t x = 0; x < nblocks; ++x) {
    sink.block = x;
    int iq, piece, b, h;
    if (tc) {
      const unsigned ux = static_cast<unsigned>(x);
      const int tile = tc_tile(ux, B, H), bh = tc_slot_head(ux, B, H);
      piece = tc_piece(tile, paged != 0, nsp);
      iq = tc_query_tile(tile, nq, paged != 0, nsp);
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
      kn = paged_keys(k_len[b], npp, ps);
    }
    int key_lo, key_hi, plo = 0, phi = 0;
    tile_keys(q0, BQ, Sq, off, kn, causal, window, key_lo, key_hi);
    if (tc && paged) {
      if (key_hi >= key_lo) {
        plo = piece_of(key_lo);
        phi = piece_of(key_hi);
      }
      if (piece < plo || piece > phi) continue;
      key_lo = piece_lo(key_lo, piece);
      key_hi = piece_hi(key_hi, piece);
    }
    // the tensor-core route's tiles; the CUDA-core route's loop from t0 while <= key_hi
    const int t_first = first_tile(key_lo, KT);
    const int t0 = tc ? t_first * KT : first_key_row(key_lo, key_hi, KT, kn);
    const int ntiles = tc ? tile_count(key_lo, key_hi, KT, t_first)
                          : t0 <= key_hi ? (key_hi - t0) / KT + 1 : 0;
    const int64_t qrow = ((int64_t)b * H + h) * Sq + q0;
    const int qn = imin(q0 + BQ, Sq) - q0;
    sink.emit(READ, 0, qrow, qrow + qn, 0, d);
    for (int t = 0; t < ntiles; ++t) {
      const int row0 = t0 + t * KT;
      for (int r = 0; r < KT; ++r) {
        const int lr = row0 + r;
        if (lr >= kn) continue;
        int64_t row, c0;
        if (paged) {
          tbl.row = lr;
          row = pool_row(tbl, ps, lr);
          c0 = (int64_t)kh * d;
        } else {
          row = ((int64_t)b * Kh + kh) * Sk + lr;
          c0 = 0;
        }
        sink.emit(READ, 1, row, row + 1, c0, c0 + d, lr, b);
        sink.emit(READ, 2, row, row + 1, c0, c0 + d, lr, b);
      }
    }
    if (tc && paged && phi > plo) {
      const int pidx = piece_group(b, h, iq, H, nq);
      const int64_t mine = (int64_t)piece_slot(pidx, nsp, piece);
      const int64_t first = (int64_t)piece_slot(pidx, nsp, plo);
      sink.emit(PARTIAL, 4, mine, mine + 1, 0, 1, -1, pidx);
      sink.emit(TICKET, 5, pidx, pidx + 1, first, first + (phi - plo + 1), phi - plo + 1, pidx);
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
// block's reads are its tile's rows and its split's K range, clipped at M,
// N and K as the kernels' masks clip them (x0, x1: the output tile's
// origin).
extern "C" int64_t repro_enum_gemm(int M, int N, int K, int int8, int route, int splits,
                                   int sms, int64_t* ev, int64_t cap) {
  int bm, bn;
  if (int8)
    int8_tile(route, splits, bm, bn);
  else
    bf16_tile(M, splits, bm, bn);
  const int walk = int8 && route >= 2, round = int8 ? 32 : 64;
  Sink sink{ev, cap};
  if (walk) {
    int mt, tiles, grid;
    walk_grid(M, N, bm, bn, sms, mt, tiles, grid);
    for (int blk = 0; blk < grid; ++blk) {
      sink.block = blk;
      for (int t = blk; t < tiles; t += grid) {
        int m0, n0;
        walk_tile(t, mt, bm, bn, m0, n0);
        const int m1 = imin(m0 + bm, M), n1 = imin(n0 + bn, N);
        sink.emit(READ, 0, m0, m1, 0, K, m0, n0);
        sink.emit(READ, 1, 0, K, n0, n1, m0, n0);
        sink.emit(WRITE, 2, m0, m1, n0, n1);
      }
    }
    return sink.n;
  }
  int gx, gy;
  gemm_grid(M, N, bm, bn, splits, gx, gy);
  const int kc = split_chunk(K, splits, round);
  for (int y = 0; y < gy; ++y)
    for (int x = 0; x < gx; ++x) {
      sink.block = (int64_t)y * gx + x;
      const int split = splits > 1 ? x % splits : 0;  // the block's rank in its cluster
      int m0, n0, kbeg, kend;
      gemm_tile(static_cast<unsigned>(x), static_cast<unsigned>(y), bm, bn, splits, m0, n0);
      split_range(split, kc, K, kbeg, kend);
      const int m1 = imin(m0 + bm, M), n1 = imin(n0 + bn, N);
      if (kend > kbeg) {
        sink.emit(READ, 0, m0, m1, kbeg, kend, m0, n0);
        sink.emit(READ, 1, kbeg, kend, n0, n1, m0, n0);
      }
      if (splits == 1) {
        sink.emit(WRITE, 2, m0, m1, n0, n1);
        continue;
      }
      int e0, e1;
      reduce_slice(split, splits, bm, bn, M, m0, e0, e1);
      for (int e = e0; e < e1; ++e) {
        const int row = e / (bn / 4), col = (e % (bn / 4)) * 4;
        sink.emit(WRITE, 2, m0 + row, m0 + row + 1, n0 + col, imin(n0 + col + 4, N));
      }
    }
  return sink.n;
}
