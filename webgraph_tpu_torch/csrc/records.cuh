// The BVGraph record parse and the copy merge that K1's k1_parse
// (decode2.cu) and K2's k2_parse and k2_resolve (decode.cu) share, as device
// functions.
//
// parse_head reads a record up to its residuals: outdegree, reference, copy
// blocks (their ends, cumulative in the parent's list, to bend[bstart[x] ..))
// and the interval count and intervals (counted, and read again later from
// the saved cursor).  merge_serial merges the interval runs with the
// gap-coded residuals, ascending, into the node's extras slots, one thread
// alone; parse_record is the two in a row, the whole record by one thread.
// keep_and_merge builds a node of depth >= 1 by one warp: the parent's slots
// that the toggle rule keeps (ballot compaction), merged by rank with the
// node's extras.  kernels/levels.py holds the plain PyTorch versions of
// this arithmetic (parse_records_plain, resolve_copies_plain,
// merge_copies_plain).

#pragma once
#include <climits>
#include <cstdint>

#include "pcodes.cuh"

namespace wgt {

constexpr unsigned FULL = 0xffffffffu;

// error codes of the depth plan (kernels/levels.py names them)
constexpr int ERR_PLAN = 5;    // the record's reference disagrees with the depth plan
constexpr int ERR_PARENT = 6;  // the parent's list failed

// k2_resolve's ready flags: a parse sets them for depth 0, k2_resolve for
// every deeper node
constexpr int NOT_READY = 0, READY = 1, FAILED = 2;

// Exclusive prefix sum over the warp's lanes of per-lane counts below
// 2^BITS, and the warp's total: one ballot per bit.  With BITS = 1 it is the
// ballot-and-popc compaction of keep_and_merge.  All 32 lanes must call it.
template <int BITS>
__device__ __forceinline__ int warp_excl_scan(unsigned v, int& total) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  int pre = 0;
  total = 0;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned m = __ballot_sync(FULL, (v >> b) & 1u);
    pre += __popc(m & lt) << b;
    total += __popc(m) << b;
  }
  return pre;
}

// Count of a[0 .. len) below v (a ascending).
__device__ __forceinline__ int64_t lower_bound(const int32_t* a, int64_t len, int32_t v) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A record read up to its residuals.
struct Head {
  int64_t base, d;      // CSR offset and outdegree
  int64_t extras;       // arcs not copied: interval values and residuals
  int64_t icnt, iarcs;  // intervals and their values
  int32_t ref;          // reference, 0 where there is none
  BufReader iv;         // cursor at the first interval's left code
};

// Reads node x's record up to its residuals, leaving `rd` at the first
// residual; returns an error code.  Writes the block ends to
// bend[bstart[x] ..).  The checks, in order: a code, the outdegree against
// off, the reference against the window and against the depth plan, the
// block count against bstart, the blocks against the parent's outdegree,
// the copied arcs against the outdegree, the interval values against the
// extras.
__device__ int parse_head(BufReader& rd, const Codings& c, int64_t x, bool depth0,
                          const int64_t* __restrict__ off,
                          const int64_t* __restrict__ bstart, int32_t* __restrict__ bend,
                          Head& h) {
  h.base = off[x];
  h.d = off[x + 1] - h.base;
  h.extras = h.icnt = h.iarcs = 0;
  h.ref = 0;
  const int64_t dd = rd.read(c.outd, c.k);
  if (rd.err) return rd.err;
  if (dd != h.d) return ERR_COUNT;
  int64_t r = 0;
  if (h.d > 0 && c.window > 0) {
    r = rd.read(c.ref, c.k);
    if (rd.err) return rd.err;
    if (r > c.window || r > x) return ERR_REF;
  }
  if (depth0 != (r == 0)) return ERR_PLAN;
  h.ref = static_cast<int32_t>(r);

  // copy blocks: the first as is, later ones + 1; even blocks are copied,
  // and the tail past the last block when the count is even
  int64_t copied = 0;
  if (r > 0) {
    const int64_t dp = off[x - r + 1] - off[x - r];
    const int64_t bc = rd.read(c.bcnt, c.k);
    if (rd.err) return rd.err;
    const int64_t b0 = bstart[x];
    if (bc != bstart[x + 1] - b0) return ERR_COUNT;
    int64_t cum = 0;
    for (int64_t k = 0; k < bc; ++k) {
      const int64_t v = rd.read(c.blk, c.k) + (k > 0);
      if (rd.err) return rd.err;
      cum += v;
      if (!(k & 1)) copied += v;
      bend[b0 + k] = static_cast<int32_t>(cum);
    }
    if (cum > dp) return ERR_COUNT;
    if (!(bc & 1)) copied += dp - cum;
  }
  if (copied > h.d) return ERR_COUNT;
  h.extras = h.d - copied;
  h.iv = rd;
  if (h.extras == 0) return 0;

  // intervals: count, then (left, length) pairs, read once here to count
  // their arcs and again from the saved cursor `iv` during the merge
  if (c.minint != 0) {
    h.icnt = rd.read(GAMMA, c.k);
    h.iv = rd;
    for (int64_t j = 0; j < h.icnt && !rd.err; ++j) {
      rd.read(GAMMA, c.k);
      h.iarcs += rd.read(GAMMA, c.k) + c.minint;
    }
    if (rd.err) return rd.err;
    if (h.iarcs > h.extras) return ERR_COUNT;
  }
  return 0;
}

// Merges the interval runs (first left = x + nat2int(v), later prev end
// + 1 + v, read at h.iv) with the residuals (first x + nat2int(v), later
// prev + 1 + v, read at rd) into dst[h.base ..); an interval's values below
// the next residual go out in one tight run.  A residual inside an
// interval run fails the node, after every code is read.
__device__ int merge_serial(BufReader& rd, const Codings& c, int64_t x, const Head& h,
                            int32_t* dst) {
  BufReader iv = h.iv;
  const int64_t extras = h.extras;
  int64_t ileft = h.icnt, ival = 0, irem = 0, iprev = 0;
  int64_t rleft = extras - h.iarcs, rv = 0;
  bool ifirst = true, rfirst = true, rvok = false, dup = false;
  int64_t em = 0;
  while (em < extras) {
    if (irem == 0 && ileft > 0) {
      const int64_t v = iv.read(GAMMA, c.k);
      ival = ifirst ? x + nat2int(static_cast<uint32_t>(v)) : iprev + 1 + v;
      ifirst = false;
      irem = iv.read(GAMMA, c.k) + c.minint;
      iprev = ival + irem;
      --ileft;
    }
    if (!rvok && rleft > 0) {
      const int64_t v = rd.read(c.res, c.k);
      rv = rfirst ? x + nat2int(static_cast<uint32_t>(v)) : rv + 1 + v;
      rfirst = false;
      rvok = true;
      --rleft;
    }
    if (rd.err) return rd.err;
    if (iv.err) return iv.err;
    dup |= rvok && irem > 0 && rv >= ival && rv < ival + irem;
    if (irem > 0 && (!rvok || ival <= rv)) {
      int64_t run = irem;
      if (rvok && rv - ival < run) run = rv - ival > 1 ? rv - ival : 1;
      if (run > extras - em) return ERR_COUNT;
      for (int64_t t = 0; t < run; ++t) dst[h.base + em + t] = static_cast<int32_t>(ival + t);
      em += run;
      irem -= run;
      ival += run;
    } else if (rvok) {
      dst[h.base + em++] = static_cast<int32_t>(rv);
      rvok = false;
    } else {
      return ERR_COUNT;
    }
  }
  return dup ? ERR_COUNT : 0;
}

// Parses node x's record by one thread; returns an error code.  Writes the
// block ends to bend[bstart[x] ..), the extras to dst[off[x] ..), and the
// reference and extras count to ref, ne.
__device__ int parse_record(BufReader& rd, const Codings& c, int64_t x, bool depth0,
                            const int64_t* __restrict__ off,
                            const int64_t* __restrict__ bstart, int32_t* __restrict__ bend,
                            int32_t* dst, int32_t& ref, int32_t& ne) {
  Head h;
  const int e = parse_head(rd, c, x, depth0, off, bstart, bend, h);
  ref = h.ref;
  ne = static_cast<int32_t>(h.extras);
  if (e || h.extras == 0) return e;
  return merge_serial(rd, c, x, h, dst);
}

// One node of depth >= 1 by one warp, once its parent's list is complete;
// returns an error code (the same in every lane).  The parent's list is
// parent[0 .. dp); the node has block ends bend[0 .. bc) and its ne extras
// already in stage[0 .. ne) (the caller stages them and gives each lane's
// first block end, bend[lane] or INT_MAX, in e_end).  The kept parent slots
// are compacted after the extras, stage[ne .. d), 32 at a time (ballot
// compaction): a slot is kept when an even number of block ends lie at or
// before it.  Then kept and extra values are merged by rank into out[0 ..
// d): a value goes to its index in its own run plus the count of the other
// run's values below it.  The runs must share no value, or two land in one
// slot and another slot stays unwritten: an extra that equals a kept value
// fails the node.
__device__ int keep_and_merge(int lane, int32_t* stage, const int32_t* parent, int64_t dp,
                              const int32_t* __restrict__ bend, int64_t bc, int32_t e_end,
                              int64_t ne, int64_t d, int32_t* out) {
  const int64_t nk = d - ne;
  // kb block ends lie before the chunk; those inside it set bits of `mask`
  int64_t kb = 0, wb = 0, kept = 0;
  for (int64_t c0 = 0; c0 < dp; c0 += 32) {
    if (kb == bc && (bc & 1)) break;  // past the last end of an odd count
    if (kb != wb) {
      wb = kb;
      e_end = wb + lane < bc ? bend[wb + lane] : INT_MAX;
    }
    const int64_t rel = static_cast<int64_t>(e_end) - c0;
    const unsigned mask =
        __reduce_or_sync(FULL, rel >= 0 && rel < 32 ? 1u << rel : 0u);
    const int64_t jj = c0 + lane;
    const bool keep =
        jj < dp && !((kb + __popc(mask & (FULL >> (31 - lane)))) & 1);
    int total;
    const int at = warp_excl_scan<1>(keep, total);
    if (keep && ne + kept + at < d) stage[ne + kept + at] = __ldcg(parent + jj);
    kept += total;
    kb += __popc(mask);
  }
  if (kept != nk) return ERR_COUNT;
  __syncwarp();

  // merge by rank: extras stage[0, ne), kept stage[ne, d)
  bool clash = false;
  for (int64_t k = lane; k < d; k += 32) {
    const int32_t v = stage[k];
    int64_t at;
    if (k < ne) {
      const int64_t lb = lower_bound(stage + ne, nk, v);
      clash |= lb < nk && stage[ne + lb] == v;
      at = k + lb;
    } else {
      at = k - ne + lower_bound(stage, ne, v);
    }
    out[at] = v;
  }
  return __any_sync(FULL, clash) ? ERR_COUNT : 0;
}

}  // namespace wgt
