// enc_costs, enc_select, enc_emit: the BVGraph encoder on Hopper (sm_90a),
// fed by a CSR that is on the card, its output byte-identical to the host
// store (formats/bvgraph.py::BVGraph.store).
//
// They have no Pallas counterpart.  They take the place of the XLA
// programs of webgraph_tpu/formats/bvgraph_jax_encode.py, which re-derive
// the reference diffComp and storeInternal (BVGraph.java:2049-2219,
// :2436-2650):
//
// * enc_costs replaces compute_costs (:449): every (node x, shift r <= w)
//   diffComp cost, costs[x][r], and whether the shift is a candidate,
//   valid[x][r].  A thread takes one pair and runs the two-pointer merge of
//   the host diff_comp (host/wgt_codec.cpp:379) in count-only mode: the
//   copy blocks against node z = x - r, the intervals (runs of at least
//   max(minint, 2) consecutive extras) and the residual gaps, their
//   lengths by wcodes.cuh.  The JAX module finds the same structure with
//   arc-parallel segment operations over all shifts at once.  Its values
//   in the slots that are not candidates are kept as well: for z < 0 no
//   block part; for z < shard_start the blocks against z but every arc of
//   x an extra.
// * enc_select replaces select_references (:487), a lax.scan over the
//   nodes: the greedy choice under maxRefCount, in the reference's order
//   (BVGraph.java:2301-2331): shifts r = 0..w in turn, a candidate when
//   valid and (r = 0 or the chain depth of x - r is under maxref), and
//   only a strictly smaller cost replaces, so the first wins a tie; no
//   candidate gives r = 0 and depth 0.  The state carried from node to
//   node is the depth of the last w nodes: one thread runs the chain with
//   it in registers (w <= 7; a ring in shared memory for larger windows),
//   while the block's other warps stage the next chunk of cost rows in
//   shared memory and write the last chunk's choices out.
// * enc_emit replaces _chosen_structure, emit_graph and emit_offsets
//   (:520-805): a thread a node re-runs its chosen merge, first to count
//   (block count, where the sections start) and then to write its record
//   at starts[x]: outdegree, reference, block count and blocks, interval
//   count and intervals (minint != 0), residuals.  Each section has its
//   own writer (wcodes.cuh BitWriter: atomicOr on the two words a section
//   may share, plain stores between).  The thread also writes its
//   .offsets code at opos[x + 1] (node 0 also the leading 0), and adds its
//   stats (through a warp's sum) and gap histograms to the block's
//   partials, which the block adds to the output once.  A record whose sections do not end where the plan
//   (starts, from the costs) says sets the error flag; the wrapper raises.
//
// Bounds.  enc_costs and enc_emit: bytes (the CSR read once, the cost
// table or the streams written once), while the work is the merges,
// sum over the pairs of d(x) + d(z) steps, each a dependent load and
// compare: the cell's 12 hubs of 1,500-6,000 arcs make the longest threads
// (a warp or a block for a long pair is the later lever).  enc_select:
// the serial chain of n steps, a compare, a select and an add each; its
// bytes (the cost table read once) are far under it.

#include <cstdint>

#include <cuda_runtime.h>

#include "wcodes.cuh"

namespace {

using wgt::enc::BitWriter;
using wgt::enc::bitlen;
using wgt::enc::code;
using wgt::enc::code_len;
using wgt::enc::gamma_len;
using wgt::enc::int2nat;

constexpr int THREADS = 256;
constexpr int NSTATS = 10;  // the counters of bvgraph_jax_encode.py:787-790
constexpr int NBINS = 33;   // each gap histogram (updateBins)
constexpr int STATS = NSTATS + 2 * NBINS;  // then the error flag
constexpr int SEL_THREADS = 256;
constexpr int SEL_SMEM = 96 * 1024;  // enc_select's staged rows and ring
constexpr int SEL_CHUNK = 2048;      // nodes a stage at most

// error flags (stats[STATS])
constexpr unsigned long long ERR_RECORD = 1;   // a record is not its planned length
constexpr unsigned long long ERR_REF = 2;      // a reference outside 0..min(x, w)
constexpr unsigned long long ERR_OFFSET = 4;   // an offsets code off its position

struct Settings {
  int outd, ref, bcnt, blk, res, k, w, minint;
};

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Turns the extras of a merge, in increasing order, into intervals (runs
// of at least max(minint, 2) consecutive values) and residuals, as the
// reference intervalize (BVGraph.java:1631-1654); with minint 0 all are
// residuals.
template <class Out>
struct Split {
  Out& o;
  const bool iv;
  const int64_t thr;
  int64_t rs = 0, rl = 0;  // the run of consecutive extras so far

  __device__ Split(Out& out, int minint)
      : o(out), iv(minint != 0), thr(minint > 2 ? minint : 2) {}

  __device__ void extra(int64_t v) {
    if (!iv) {
      o.residual(v);
    } else if (rl && v == rs + rl) {
      rl++;
    } else {
      flush();
      rs = v;
      rl = 1;
    }
  }

  __device__ void flush() {
    if (rl >= thr) {
      o.interval(rs, rl);
    } else {
      for (int64_t i = 0; i < rl; i++) o.residual(rs + i);
    }
    rl = 0;
  }
};

// The reference diffComp merge (host/wgt_codec.cpp:379, BVGraph.java:
// 2066-2140) of cur[0, curlen) against ref[0, reflen): o.block(len) for
// each copy/skip block (the trailing run implicit), o.copy() for each
// copied arc, and the extras through Split.  all_extras feeds every arc of
// cur to the extras (the JAX cost of a shift before shard_start).
template <class Out>
__device__ void diff_comp(const int32_t* __restrict__ cur, int64_t curlen,
                          const int32_t* __restrict__ ref, int64_t reflen,
                          bool all_extras, int minint, Out& o) {
  Split<Out> sp(o, minint);
  int64_t j = 0, t = 0, cbl = 0;
  bool copying = true;
  int32_t cj = curlen ? __ldg(cur) : 0, rt = reflen ? __ldg(ref) : 0;
  while (j < curlen && t < reflen) {
    if (cj < rt) {  // an extra, copying or not
      sp.extra(cj);
      if (++j < curlen) cj = __ldg(cur + j);
    } else if (copying) {
      if (cj > rt) {
        o.block(cbl);
        copying = false;
        cbl = 0;
      } else {
        if (all_extras) sp.extra(cj);
        o.copy();
        cbl++;
        if (++j < curlen) cj = __ldg(cur + j);
        if (++t < reflen) rt = __ldg(ref + t);
      }
    } else if (cj > rt) {
      cbl++;
      if (++t < reflen) rt = __ldg(ref + t);
    } else {
      o.block(cbl);
      copying = true;
      cbl = 0;
    }
  }
  if (copying && t < reflen) o.block(cbl);
  for (; j < curlen; j++) sp.extra(__ldg(cur + j));
  sp.flush();
}

// Counts the bits of each part of a record.
struct Count {
  const Settings s;
  const int64_t x;
  int64_t nblocks = 0, blk_bits = 0, copied = 0;
  int64_t nint = 0, int_arcs = 0, int_bits = 0, prev_end = 0;
  int64_t nres = 0, res_bits = 0, prev = 0;

  __device__ Count(const Settings& st, int64_t node) : s(st), x(node) {}

  __device__ void block(int64_t len) {
    blk_bits += code_len(s.blk, nblocks ? len - 1 : len, s.k);
    nblocks++;
  }
  __device__ void copy() { copied++; }
  __device__ void interval(int64_t left, int64_t len) {
    int_bits += gamma_len(nint ? left - prev_end - 1 : int2nat(left - x))
                + gamma_len(len - s.minint);
    prev_end = left + len;
    nint++;
    int_arcs += len;
  }
  __device__ void residual(int64_t v) {
    res_bits += code_len(s.res, nres ? v - prev - 1 : int2nat(v - x), s.k);
    prev = v;
    nres++;
  }
  __device__ bool extras() const { return int_arcs + nres > 0; }
  // the interval part's bits (count and intervals; none with minint 0)
  __device__ int64_t interval_bits() const {
    return extras() && s.minint != 0 ? gamma_len(nint) + int_bits : 0;
  }
  __device__ int64_t residual_bits() const { return extras() ? res_bits : 0; }
};

// Writes the blocks, intervals and residuals of a record, each into its
// own section, and counts the residual gaps into `bins`.
struct Write {
  const Settings s;
  const int64_t x;
  BitWriter b, i, r;
  unsigned int* bins;
  int64_t nblocks = 0, nint = 0, prev_end = 0, nres = 0, prev = 0;

  __device__ Write(const Settings& st, int64_t node, uint32_t* words,
                   int64_t bs, int64_t is, int64_t rs, int64_t re,
                   unsigned int* res_bins)
      : s(st), x(node), b(words, bs, is), i(words, is, rs), r(words, rs, re),
        bins(res_bins) {}

  __device__ void block(int64_t len) {
    b.put(code(s.blk, nblocks ? len - 1 : len, s.k));
    nblocks++;
  }
  __device__ void copy() {}
  __device__ void interval(int64_t left, int64_t len) {
    i.put(code(wgt::enc::GAMMA,
               nint ? left - prev_end - 1 : int2nat(left - x), 0));
    i.put(code(wgt::enc::GAMMA, len - s.minint, 0));
    prev_end = left + len;
    nint++;
  }
  __device__ void residual(int64_t v) {
    const uint64_t gap = nres ? v - prev : int2nat(v - x);
    if (gap) atomicAdd(bins + imin(bitlen(gap) - 1, 32), 1u);
    r.put(code(s.res, nres ? v - prev - 1 : int2nat(v - x), s.k));
    prev = v;
    nres++;
  }
};

__global__ void __launch_bounds__(THREADS)
enc_costs(const int64_t* __restrict__ off, const int32_t* __restrict__ succ,
          int64_t n, Settings s, int64_t shard_start,
          int32_t* __restrict__ costs, uint8_t* __restrict__ valid) {
  const int cbs = s.w + 1;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n * cbs) return;
  const int64_t x = i / cbs;
  const int r = static_cast<int>(i - x * cbs);
  const int64_t b0 = off[x], d = off[x + 1] - b0, z = x - r;
  int64_t cost = s.w > 0 ? code_len(s.ref, r, s.k) : 0;
  bool ok = d > 0;
  Count c(s, x);
  if (r == 0 || z < 0) {
    diff_comp(succ + b0, d, nullptr, 0, false, s.minint, c);
    ok = ok && r == 0;
  } else {
    const int64_t zb = off[z], dz = off[z + 1] - zb;
    diff_comp(succ + b0, d, succ + zb, dz, z < shard_start, s.minint, c);
    cost += code_len(s.bcnt, c.nblocks, s.k) + c.blk_bits;
    ok = ok && z >= shard_start && dz > 0;
  }
  costs[i] = static_cast<int32_t>(cost + c.interval_bits() + c.residual_bits());
  valid[i] = ok;
}

// CBS > 0: w + 1 = CBS, the last w depths in registers; CBS == 0: any
// window, the ring of w + 1 depths in shared memory.  Shared memory holds
// two stages of cost rows, two of outputs (refs, then depths, of a
// chunk), then the ring.  In chunk c thread 0 runs the chain over stage
// c & 1 into outputs c & 1, while warps 1.. fill stage (c + 1) & 1 and
// write chunk c - 1's outputs out, both coalesced.
template <int CBS>
__global__ void __launch_bounds__(SEL_THREADS)
enc_select(const int32_t* __restrict__ costs, const uint8_t* __restrict__ valid,
           int64_t n, int cbs_rt, int64_t maxref, int chunk, bool aligned,
           int32_t* __restrict__ refs, int32_t* __restrict__ depths) {
  extern __shared__ __align__(16) int32_t sm[];
  const int cbs = CBS > 0 ? CBS : cbs_rt;
  const int64_t span = static_cast<int64_t>(chunk) * cbs;
  int32_t* const stage0 = sm;
  int32_t* const out0 = sm + 2 * span;
  int32_t* const ring = out0 + 4 * chunk;
  const int64_t nch = (n + chunk - 1) / chunk;
  const bool vec = aligned && span % 4 == 0;  // 16-byte loads and stores
  // a stage: each node's row of costs, -1 where the shift is no candidate
  auto fill = [&](int64_t c, int t0, int nt) {
    int32_t* dst = stage0 + (c & 1) * span;
    const int64_t first = c * span;
    const int64_t cnt = imin(chunk, n - c * chunk) * cbs;
    int64_t j = 0;
    if (vec) {
      const int4* cv = reinterpret_cast<const int4*>(costs + first);
      const uchar4* vv = reinterpret_cast<const uchar4*>(valid + first);
      for (int64_t q = t0; q < cnt / 4; q += nt) {
        const int4 cc = __ldg(cv + q);
        const uchar4 ok = __ldg(vv + q);
        reinterpret_cast<int4*>(dst)[q] =
            make_int4(ok.x ? cc.x : -1, ok.y ? cc.y : -1, ok.z ? cc.z : -1,
                      ok.w ? cc.w : -1);
      }
      j = cnt / 4 * 4;
    }
    for (j += t0; j < cnt; j += nt) {
      const int32_t cc = __ldg(costs + first + j);
      dst[j] = __ldg(valid + first + j) ? cc : -1;
    }
  };
  auto drain = [&](int64_t c, int t0, int nt) {
    const int32_t* o = out0 + (c & 1) * 2 * chunk;
    const int64_t x0 = c * chunk, cnt = imin(chunk, n - x0);
    for (int64_t j = t0; j < cnt; j += nt) {
      refs[x0 + j] = o[j];
      depths[x0 + j] = o[chunk + j];
    }
  };
  if (CBS == 0)
    for (int j = threadIdx.x; j < cbs; j += blockDim.x) ring[j] = 0;
  fill(0, threadIdx.x, blockDim.x);
  __syncthreads();
  constexpr int R = CBS > 0 ? CBS : 1;
  int32_t dep[R];  // dep[r]: the depth of node x - r (0 before node 0)
#pragma unroll
  for (int r = 0; r < R; r++) dep[r] = 0;
  // a depth is at most n - 1 < 2^31 - 1, so clamping maxref keeps `<`
  const int32_t mr = static_cast<int32_t>(
      maxref > 0x7fffffff ? 0x7fffffff : (maxref < 0 ? -1 : maxref));
  int xm = 0;  // x mod cbs (the ring)
  for (int64_t c = 0; c < nch; c++) {
    if (threadIdx.x >= 32) {
      if (c + 1 < nch) fill(c + 1, threadIdx.x - 32, blockDim.x - 32);
      if (c > 0) drain(c - 1, threadIdx.x - 32, blockDim.x - 32);
    } else if (threadIdx.x == 0) {
      const int32_t* row = stage0 + (c & 1) * span;
      int32_t* o = out0 + (c & 1) * 2 * chunk;
      const int64_t cnt = imin(chunk, n - c * chunk);
      // the next node's row is loaded while this one's step runs
      int32_t cur[R], nxt[R];
#pragma unroll
      for (int r = 0; r < R; r++) cur[r] = CBS > 0 ? row[r] : 0;
      for (int64_t i = 0; i < cnt; i++, row += cbs) {
        int best_r = 0;
        int32_t best = -1, best_dep = -1;
        if (CBS > 0) {
          const bool more = i + 1 < cnt;
#pragma unroll
          for (int r = 0; r < R; r++) nxt[r] = more ? row[cbs + r] : 0;
          // shifts in turn, a strictly smaller cost replacing (a tree of
          // minima measured slower on the card); an invalid slot is -1,
          // as unsigned above every cost
          uint32_t b = static_cast<uint32_t>(cur[0]);
#pragma unroll
          for (int r = 1; r < R; r++) {
            const bool take = cur[r] >= 0 && dep[r] < mr
                              && static_cast<uint32_t>(cur[r]) < b;
            b = take ? static_cast<uint32_t>(cur[r]) : b;
            best_r = take ? r : best_r;
            best_dep = take ? dep[r] : best_dep;
          }
#pragma unroll
          for (int r = 0; r < R; r++) cur[r] = nxt[r];
        } else {
          for (int r = 0; r < cbs; r++) {
            const int32_t cr = row[r];
            int slot = xm - r;
            if (slot < 0) slot += cbs;
            const int32_t dr = ring[slot];
            if (cr >= 0 && (r == 0 || dr < maxref) && (best < 0 || cr < best)) {
              best = cr;
              best_r = r;
              best_dep = r ? dr : -1;
            }
          }
        }
        const int32_t depth = best_dep + 1;  // 0 for r = 0 or no candidate
        if (CBS > 0) {
#pragma unroll
          for (int r = R - 1; r > 1; r--) dep[r] = dep[r - 1];
          if (R > 1) dep[1] = depth;
        } else {
          ring[xm] = depth;
          xm = xm + 1 == cbs ? 0 : xm + 1;
        }
        o[i] = best_r;
        o[chunk + i] = depth;
      }
    }
    __syncthreads();
  }
  drain(nch - 1, threadIdx.x, blockDim.x);
}

// words: the .graph stream (nullptr: offsets only); owords: the .offsets
// stream (nullptr: graph only), code off_c of node x's bits at opos[x + 1]
// and of 0 at opos[0], opos[n + 1] its end.  stats: int64[STATS + 1],
// zeroed.
__global__ void __launch_bounds__(THREADS)
enc_emit(const int64_t* __restrict__ off, const int32_t* __restrict__ succ,
         const int32_t* __restrict__ refs, const int32_t* __restrict__ depths,
         const int64_t* __restrict__ starts, int64_t n, Settings s,
         uint32_t* words, const int64_t* __restrict__ opos, int off_c,
         uint32_t* owords, unsigned long long* stats) {
  // the block's partials: the counters (added by one lane a warp) and the
  // two histograms (32-bit shared atomics: a block's counts fit)
  __shared__ unsigned long long part[NSTATS];
  __shared__ unsigned int bins[2 * NBINS];
  for (int i = threadIdx.x; i < 2 * NBINS; i += blockDim.x) {
    bins[i] = 0;
    if (i < NSTATS) part[i] = 0;
  }
  __syncthreads();
  const int64_t x = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  unsigned long long err = 0;
  unsigned long long st[NSTATS] = {};
  if (x < n) {
    const int64_t start = starts[x], end = starts[x + 1];
    if (owords) {
      if (x == 0) {
        const auto c0 = code(off_c, 0, s.k);
        BitWriter o(owords, opos[0], opos[0] + c0.len);
        o.put(c0);
        o.done();
        if (opos[1] - opos[0] != c0.len) err |= ERR_OFFSET;
      }
      const auto c = code(off_c, end - start, s.k);
      BitWriter o(owords, opos[x + 1], opos[x + 1] + c.len);
      o.put(c);
      o.done();
      if (opos[x + 2] - opos[x + 1] != c.len) err |= ERR_OFFSET;
    }
    if (words) {
      const int64_t b0 = off[x], d = off[x + 1] - b0;
      const int32_t* cur = succ + b0;
      const auto co = code(s.outd, d, s.k);
      st[0] = co.len;
      if (d == 0) {
        BitWriter h(words, start, end);
        h.put(co);
        h.done();
        if (start + co.len != end) err |= ERR_RECORD;
      } else {
        const int64_t r = refs[x], z = x - r;
        const int32_t* rl = nullptr;
        int64_t rlen = 0;
        if (r < 0 || z < 0 || r > s.w) {
          err |= ERR_REF;
        } else if (r > 0) {
          rl = succ + off[z];
          rlen = off[z + 1] - off[z];
        }
        Count c(s, x);
        diff_comp(cur, d, rl, rlen, false, s.minint, c);
        const auto cr = code(s.ref, r, s.k);
        const auto cb = code(s.bcnt, c.nblocks, s.k);
        const int64_t lr = s.w > 0 ? cr.len : 0, lb = r > 0 ? cb.len : 0;
        const int64_t bs = start + co.len + lr + lb, is = bs + c.blk_bits;
        const int64_t rs = is + c.interval_bits(), re = rs + c.residual_bits();
        BitWriter h(words, start, bs);
        h.put(co);
        if (s.w > 0) h.put(cr);
        if (r > 0) h.put(cb);
        h.done();
        Write wr(s, x, words, bs, is, rs, re, bins + NBINS);
        if (c.interval_bits()) wr.i.put(code(wgt::enc::GAMMA, c.nint, 0));
        diff_comp(cur, d, rl, rlen, false, s.minint, wr);
        wr.b.done();
        wr.i.done();
        wr.r.done();
        if (wr.b.pos != is || wr.i.pos != rs || wr.r.pos != re || re != end)
          err |= ERR_RECORD;
        st[1] = lr;
        st[2] = r > 0 ? lb + c.blk_bits : 0;
        st[3] = c.interval_bits();
        st[4] = c.residual_bits();
        st[5] = r > 0 ? c.copied : 0;
        st[6] = s.minint != 0 ? c.int_arcs : 0;
        st[7] = c.nres;
        // successor gaps (updateBins, BVGraph.java:1940-1944)
        int64_t prev = x;
        for (int64_t j = 0; j < d; j++) {
          const int64_t v = __ldg(cur + j);
          const uint64_t gap = j ? v - prev : int2nat(v - x);
          if (gap) atomicAdd(bins + imin(bitlen(gap) - 1, 32), 1u);
          prev = v;
        }
      }
      st[8] = static_cast<unsigned long long>(depths[x]);
      st[9] = static_cast<unsigned long long>(refs[x]);
    }
  }
  if (err) atomicOr(stats + STATS, err);
#pragma unroll
  for (int j = 0; j < NSTATS; j++) {
    unsigned long long v = st[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(part + j, v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * NBINS; i += blockDim.x) {
    if (bins[i]) atomicAdd(stats + NSTATS + i, static_cast<unsigned long long>(bins[i]));
    if (i < NSTATS && part[i]) atomicAdd(stats + i, part[i]);
  }
}

bool settings_ok(const Settings& s) {
  const int codings[5] = {s.outd, s.ref, s.bcnt, s.blk, s.res};
  for (int c : codings)
    if (c != wgt::enc::GAMMA && c != wgt::enc::DELTA && c != wgt::enc::ZETA &&
        c != wgt::enc::UNARY && c != wgt::enc::GOLOMB && c != wgt::enc::NIBBLE)
      return false;
  return s.k >= 1 && s.w >= 0 && s.minint >= 0;
}

template <int CBS>
cudaError_t launch_select(const void* costs, const void* valid, int64_t n, int cbs,
                          int64_t maxref, void* refs, void* depths, cudaStream_t st) {
  // nodes a chunk: a multiple of 4 where it fits, so the stages take
  // 16-byte loads
  int64_t chunk = imin(SEL_CHUNK, (SEL_SMEM / 4 - cbs) / (2 * static_cast<int64_t>(cbs) + 4));
  if (chunk >= 4) chunk &= ~int64_t{3};
  if (chunk < 1) return cudaErrorInvalidValue;
  const int smem = static_cast<int>((2 * chunk * cbs + 4 * chunk + (CBS == 0 ? cbs : 0)) * 4);
  cudaError_t e = cudaFuncSetAttribute(enc_select<CBS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const bool aligned = reinterpret_cast<uintptr_t>(costs) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  enc_select<CBS><<<1, SEL_THREADS, smem, st>>>(
      static_cast<const int32_t*>(costs), static_cast<const uint8_t*>(valid), n, cbs,
      maxref, static_cast<int>(chunk), aligned, static_cast<int32_t*>(refs),
      static_cast<int32_t*>(depths));
  return cudaGetLastError();
}

}  // namespace

extern "C" int wgt_enc_costs(const void* off, const void* succ, int64_t n, int outd,
                             int ref, int bcnt, int blk, int res, int k, int w,
                             int minint, int64_t shard_start, void* costs, void* valid,
                             void* stream) {
  const Settings s{outd, ref, bcnt, blk, res, k, w, minint};
  if (!settings_ok(s) || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pairs = n * (w + 1);
  const int64_t blocks = (pairs + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  enc_costs<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(off), static_cast<const int32_t*>(succ), n, s,
      shard_start, static_cast<int32_t*>(costs), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_enc_select(const void* costs, const void* valid, int64_t n, int w,
                              int64_t maxref, void* refs, void* depths, void* stream) {
  if (n < 1 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (w + 1) {
    case 1: e = launch_select<1>(costs, valid, n, 1, maxref, refs, depths, st); break;
    case 2: e = launch_select<2>(costs, valid, n, 2, maxref, refs, depths, st); break;
    case 3: e = launch_select<3>(costs, valid, n, 3, maxref, refs, depths, st); break;
    case 4: e = launch_select<4>(costs, valid, n, 4, maxref, refs, depths, st); break;
    case 5: e = launch_select<5>(costs, valid, n, 5, maxref, refs, depths, st); break;
    case 6: e = launch_select<6>(costs, valid, n, 6, maxref, refs, depths, st); break;
    case 7: e = launch_select<7>(costs, valid, n, 7, maxref, refs, depths, st); break;
    case 8: e = launch_select<8>(costs, valid, n, 8, maxref, refs, depths, st); break;
    default: e = launch_select<0>(costs, valid, n, w + 1, maxref, refs, depths, st);
  }
  return static_cast<int>(e);
}

extern "C" int wgt_enc_emit(const void* off, const void* succ, const void* refs,
                            const void* depths, const void* starts, int64_t n, int outd,
                            int ref, int bcnt, int blk, int res, int k, int w, int minint,
                            void* words, const void* opos, int off_c, void* owords,
                            void* stats, void* stream) {
  const Settings s{outd, ref, bcnt, blk, res, k, w, minint};
  const Settings so{off_c, off_c, off_c, off_c, off_c, k, w, minint};
  if (n < 1 || (words && !settings_ok(s)) || (owords && (!settings_ok(so) || !opos)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  enc_emit<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(off), static_cast<const int32_t*>(succ),
      static_cast<const int32_t*>(refs), static_cast<const int32_t*>(depths),
      static_cast<const int64_t*>(starts), n, s, static_cast<uint32_t*>(words),
      static_cast<const int64_t*>(opos), off_c, static_cast<uint32_t*>(owords),
      static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}
