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
//   node is the depth of the last w nodes, and once two runs agree on it
//   they agree on every later choice.  So one persistent cooperative
//   launch cuts the nodes into chunks of SEL_C, a thread's chain each
//   (the depths in registers for w <= 7, read back for larger windows),
//   and (1) runs every chunk from a guessed ring of zero depths; (2) in a
//   round, behind grid barriers, reads each chunk's true incoming ring and
//   re-runs the chunks whose ring differs from the one they ran from,
//   stopping each where its last w depths meet the stored ones; rounds go
//   on while a repair changed a depth that a later chunk reads and, from
//   the third, while they settle chunks fast enough (SEL_GAIN), at most
//   SEL_ROUNDS; (3) if one still did, block 0 walks the chunks left
//   unsettled in order, re-running those whose ring changed, warp 0
//   stepping while the block's other warps stage each node's shifts in
//   order of cost.  On web graphs a repair ends within ~80 nodes, so one
//   round settles them; a chain through every chunk costs two rounds and
//   then the serial walk.
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
// bytes, the cost table read once and refs and depths written once; a
// thread's chain of SEL_C steps and each repair's, plus the walk where
// the rounds do not settle, are its serial part.

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
constexpr int SEL_SMEM = 96 * 1024;  // the walk's staged rows and ring
constexpr int SEL_STAGE = 2048;      // nodes a stage of the walk at most
constexpr int SEL_C = 128;           // nodes a chunk: a thread's chain
constexpr int SEL_ROUNDS = 16;       // repair rounds at most
// a round costs about as much as walking this many chunks (~60 against
// ~9 us on an H100), so from the third a round runs only if the one
// before cut the chunks still changing by this many
constexpr int SEL_GAIN = 8;
constexpr int SEL_GROUP = 4;         // rows a thread loads at once
// enc_select's scratch: SEL_WORDS int64 (zeroed), then int32: two
// [nch][w] rings and [nch] the round each chunk last changed its tail in;
// kernels/encode.py holds the same numbers
constexpr int SEL_WORDS = 32;
constexpr int SW_ROUNDS = 0, SW_RERUN = 1, SW_SERIAL = 2;  // the counts
constexpr int SW_BARRIER = 3;  // the grid barrier's count
constexpr int SW_CHANGED = 4;  // + k - 1: the chunks round k changed
static_assert(SW_CHANGED + SEL_ROUNDS <= SEL_WORDS, "the scratch's head");

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

// grid_sync's acquiring load (propagate.cu)
__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid meets here; `target` is the number of this
// barrier times gridDim.x (the count only rises within a launch).
__device__ void grid_sync(unsigned long long* count, unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1ull);
    while (ld_acquire(count) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

struct Sel {
  const int32_t* __restrict__ costs;
  const uint8_t* __restrict__ valid;
  int64_t n, nch;    // nodes, chunks of SEL_C
  int cbs, stage;    // w + 1; nodes a stage of the walk
  int32_t mr;        // maxref clamped to int32
  bool aligned;      // costs on 16 bytes, valid on 8: vector loads
  int32_t* refs;
  int32_t* depths;
  unsigned long long* head;  // the scratch's SEL_WORDS words
  int32_t* last;     // [nch][w]: the ring each chunk last ran from
  int32_t* snap;     // [nch][w]: the rings read at a round's start
  int32_t* chg;      // [nch]: the round a chunk last changed its tail in
};

// A node's choice split at r = 1.  The shifts r = 0 and r >= 2 read the
// depths of nodes before the last, known a step early, so prep reduces
// them ahead of the chain; finish then waits on the last node's depth
// alone: one compare and two selects a node on the chain.
struct Pre {
  int32_t r, d;  // the choice among r = 0 and r >= 2, the depth it gives
  bool one;      // r = 1, if a candidate, replaces it
};

// From the node's row (-1 where the shift is no candidate), dep[r] the
// depth of x - r: the shifts in the reference's order, a later one
// replacing only when strictly cheaper (so the first wins a tie), by a
// tree of minima; -1 is above every cost as unsigned.  No candidate gives
// r = 0 and depth 0.
template <int R>
__device__ __forceinline__ Pre prep(const int32_t (&row)[R], const int32_t (&dep)[R],
                                    int32_t mr) {
  uint32_t c[R];
  int32_t k[R], d[R];
#pragma unroll
  for (int r = 0; r < R; r++) {
    const int32_t dr = r >= 2 ? dep[r] : 0;
    const bool ok = r == 0 || (r >= 2 && row[r] >= 0 && dr < mr);
    c[r] = ok ? static_cast<uint32_t>(row[r]) : 0xffffffffu;
    k[r] = r;
    d[r] = r ? dr + 1 : 0;
  }
#pragma unroll
  for (int s = 1; s < R; s *= 2)
#pragma unroll
    for (int i = 0; i + s < R; i += 2 * s) {
      const bool t = c[i + s] < c[i];
      c[i] = t ? c[i + s] : c[i];
      k[i] = t ? k[i + s] : k[i];
      d[i] = t ? d[i + s] : d[i];
    }
  Pre q{k[0], d[0], false};
  if (R > 1) {
    const int32_t r1 = row[R > 1 ? 1 : 0];
    const uint32_t c1 = static_cast<uint32_t>(r1);
    q.one = r1 >= 0 && (k[0] ? c1 <= c[0] : c1 < c[0]);
  }
  return q;
}

// The choice and depth given d1, the depth of x - 1.
__device__ __forceinline__ int32_t finish(const Pre& q, int32_t d1, int32_t mr, int& best_r) {
  const bool take = q.one && d1 < mr;
  best_r = take ? 1 : q.r;
  return take ? d1 + 1 : q.d;
}

template <int R>
__device__ __forceinline__ void push(int32_t (&dep)[R], int32_t d) {
#pragma unroll
  for (int r = R - 1; r > 1; r--) dep[r] = dep[r - 1];
  if (R > 1) dep[1] = d;
}

template <int R>
__device__ __forceinline__ void load_row(const Sel& p, int64_t x, int32_t (&row)[R]) {
  const int64_t at = x * R;
  if constexpr (R == 8) {
    if (p.aligned) {  // a row: two 16-byte loads of costs, one 8-byte of valid
      const int4 a = __ldg(reinterpret_cast<const int4*>(p.costs + at));
      const int4 b = __ldg(reinterpret_cast<const int4*>(p.costs + at) + 1);
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p.valid + at));
      const int32_t c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 8; r++)
        row[r] = ((r < 4 ? v.x : v.y) >> (8 * (r & 3)) & 0xff) ? c[r] : -1;
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; r++) {
    const int32_t c = __ldg(p.costs + at + r);
    row[r] = __ldg(p.valid + at + r) ? c : -1;
  }
}

// Nodes [lo, end) of a chunk from dep (dep[r]: the depth of lo - r), a
// thread's chain, SEL_GROUP rows loaded at once.  eq < 0: a first run.
// eq >= 0: a repair, eq the depths before lo that agree with the ring the
// chunk last ran from; each new depth is compared with the stored one, and
// the repair stops once the last w agree, the rest of the chunk standing
// (the rest of its group is run again to the same values, unwritten).
// Returns the nodes run; tail: a depth of the chunk's last w nodes changed.
template <int R>
__device__ int64_t run_chunk(const Sel& p, int64_t lo, int64_t end, int32_t (&dep)[R], int eq,
                             bool& tail) {
  const bool repair = eq >= 0;
  int64_t ran = 0;
  for (int64_t x = lo; x < end && !(repair && eq >= R - 1); x += SEL_GROUP) {
    int32_t rows[SEL_GROUP][R], old[SEL_GROUP];
#pragma unroll
    for (int i = 0; i < SEL_GROUP; i++) {
      if (x + i < end) {
        load_row(p, x + i, rows[i]);
      } else {
#pragma unroll
        for (int r = 0; r < R; r++) rows[i][r] = -1;
      }
      old[i] = repair && x + i < end ? p.depths[x + i] : 0;
    }
#pragma unroll
    for (int i = 0; i < SEL_GROUP; i++) {
      const int64_t y = x + i;
      const bool on = y < end && !(repair && eq >= R - 1);
      int best_r;
      const int32_t d = finish(prep(rows[i], dep, p.mr), dep[R > 1 ? 1 : 0], p.mr, best_r);
      push(dep, d);
      if (on) {
        if (repair) {
          const bool same = d == old[i];
          eq = same ? eq + 1 : 0;
          tail |= !same && y >= end - (R - 1);
        }
        p.refs[y] = best_r;
        p.depths[y] = d;
        ran++;
      }
    }
  }
  return ran;
}

// run_chunk for any window: the depths of the chunk's own nodes read back
// from `depths`, those before it from ring[0, w) (the depth of lo - w + j
// at j; nullptr: all 0).
__device__ int64_t run_chunk_any(const Sel& p, int64_t lo, int64_t end, const int32_t* ring,
                                 int eq, bool& tail) {
  const int w = p.cbs - 1;
  const bool repair = eq >= 0;
  int64_t ran = 0;
  for (int64_t x = lo; x < end && !(repair && eq >= w); x++) {
    const int32_t* cr = p.costs + x * p.cbs;
    const uint8_t* vr = p.valid + x * p.cbs;
    int32_t best = __ldg(vr) ? __ldg(cr) : -1, best_dep = -1;
    int best_r = 0;
    for (int r = 1; r <= w; r++) {
      const int32_t c = __ldg(cr + r);
      if (!__ldg(vr + r) || (best >= 0 && c >= best)) continue;
      const int64_t z = x - r;
      const int32_t dz = z >= lo ? p.depths[z] : (ring ? ring[z - lo + w] : 0);
      if (dz < p.mr) {
        best = c;
        best_r = r;
        best_dep = dz;
      }
    }
    const int32_t d = best_dep + 1;
    if (repair) {
      const bool same = d == p.depths[x];
      eq = same ? eq + 1 : 0;
      tail |= !same && x >= end - w;
    }
    p.refs[x] = best_r;
    p.depths[x] = d;
    ran++;
  }
  return ran;
}

// A node's shifts r >= 1 that beat r = 0 (every candidate one if r = 0 is
// not), by cost and then shift, a nibble each from the lowest, 0 after
// the last: the walk takes the first one whose node's depth is under
// maxref, else r = 0 with depth 0.  The nibbles are byte selectors
// (__byte_perm) into the walk's bytes of depth flags.
template <int R>
__device__ __forceinline__ uint32_t order_of(const int32_t (&row)[R]) {
  const uint32_t c0 = static_cast<uint32_t>(row[0]);  // -1: above every cost
  bool in[R];
#pragma unroll
  for (int r = 0; r < R; r++) in[r] = r > 0 && row[r] >= 0 && static_cast<uint32_t>(row[r]) < c0;
  uint32_t ord = 0;
#pragma unroll
  for (int r = 1; r < R; r++) {
    int rank = 0;
#pragma unroll
    for (int s = 1; s < R; s++)
      rank += s != r && in[s] && (row[s] < row[r] || (row[s] == row[r] && s < r));
    ord |= in[r] ? static_cast<uint32_t>(r) << (4 * rank) : 0u;
  }
  return ord;
}

// The walk, where the last round k still changed a chunk's tail: block 0
// goes chunk after chunk from f, the first chunk whose ring round k
// changed, to past l, the last, each from the true ring.  It re-runs, as
// a repair, a chunk whose ring round k or the walk changed: from the
// agreement of the true ring with the one the chunk last ran from, each
// new depth compared with the stored one; where the last w agree the
// rest stands (run again to the same values, uncounted).  Other chunks
// stand as they are.  Warp 0 steps while warps 1.. fill the next stage
// and write the last stage's choices out.  A stage holds, a node each,
// the stored depth and, CBS > 0 (w + 1 = CBS), its order_of: a step reads
// one word, permutes the depth flags (byte r of fl, fh: 0xff where the
// depth of x - r is under maxref) into the order, takes the first set,
// and picks its depth, the last w in registers; CBS == 0 (any window),
// its row of costs (-1 where the shift is no candidate), the ring of
// w + 1 depths in shared memory.  Shared memory: two stages, two of
// outputs (refs, -1 where the chunk stands, then depths), then the ring.
// Returns the nodes re-run (thread 0).
template <int CBS>
__device__ __forceinline__ int64_t walk(const Sel& p, int32_t* sm, int k) {
  __shared__ int64_t s_stop;  // nodes of the stage run where the walk ended; -1 on
  __shared__ int s_f, s_l;
  const int w = p.cbs - 1;
  const int cbs = CBS > 0 ? CBS : p.cbs;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_stop = -1;
    s_f = 0x7fffffff;
    s_l = 0;
  }
  __syncthreads();
  for (int64_t c = threadIdx.x; c < p.nch; c += blockDim.x)
    if (__ldcg(p.chg + c) == k) {
      atomicMin(&s_f, static_cast<int>(c + 1));
      atomicMax(&s_l, static_cast<int>(c + 1));
    }
  __syncthreads();
  const int64_t f = s_f, l = s_l;
  const int stage = p.stage;
  const int64_t per = CBS > 0 ? 2 : cbs + 1;  // ints a node of a stage
  const int64_t span = per * stage;
  int32_t* const stage0 = sm;
  int32_t* const out0 = sm + 2 * span;
  int32_t* const ring = out0 + 4 * stage;
  const int64_t x0 = f * SEL_C, nst = (p.n - x0 + stage - 1) / stage;
  // a stage: the stored depths, then each node's order_of or row
  auto fill = [&](int64_t c, int t0, int nt) {
    int32_t* const dst = stage0 + (c & 1) * span;
    int32_t* const rows = dst + stage;
    const int64_t x1 = x0 + c * stage, nodes = imin(stage, p.n - x1);
    for (int64_t j = t0; j < nodes; j += nt) dst[j] = __ldcg(p.depths + x1 + j);
    if constexpr (CBS > 0) {
      for (int64_t j = t0; j < nodes; j += nt) {
        int32_t row[CBS];
        load_row(p, x1 + j, row);
        rows[j] = static_cast<int32_t>(order_of(row));
      }
    } else {
      const int64_t first = x1 * cbs, cnt = nodes * cbs;
      for (int64_t j = t0; j < cnt; j += nt) {
        const int32_t cc = __ldg(p.costs + first + j);
        rows[j] = __ldg(p.valid + first + j) ? cc : -1;
      }
    }
  };
  auto drain = [&](int64_t c, int64_t cnt, int t0, int nt) {
    const int32_t* o = out0 + (c & 1) * 2 * stage;
    const int64_t x1 = x0 + c * stage;
    for (int64_t j = t0; j < cnt; j += nt)
      if (o[j] >= 0) {
        p.refs[x1 + j] = o[j];
        p.depths[x1 + j] = o[stage + j];
      }
  };
  if (CBS == 0)
    for (int r = 1 + threadIdx.x; r < cbs; r += blockDim.x) {
      const int64_t z = x0 - r;
      ring[(z % cbs + cbs) % cbs] = z >= 0 ? __ldcg(p.depths + z) : 0;
    }
  fill(0, threadIdx.x, blockDim.x);
  __syncthreads();
  constexpr int R = CBS > 0 ? CBS : 1;
  int32_t dep[R];  // dep[r]: the depth of node x - r
  uint32_t fl = 0, fh = 0;  // byte r of (fh:fl): 0xff where dep[r] < maxref (r >= 1)
#pragma unroll
  for (int r = 0; r < R; r++) {
    dep[r] = r ? __ldcg(p.depths + x0 - r) : 0;
    const uint32_t f = r && dep[r] < p.mr ? 0xffu : 0u;
    fl |= r < 4 ? f << (8 * r) : 0u;
    fh |= r >= 4 ? f << (8 * (r - 4)) : 0u;
  }
  int xm = static_cast<int>(x0 % cbs);  // x mod cbs (the ring)
  // the next node's depth enters the ring
  auto take = [&](int32_t depth) {
    if (CBS > 0) {
      fh = __funnelshift_l(fl, fh, 8);
      fl = fl << 8 | (depth < p.mr ? 0xff00u : 0u);
      push(dep, depth);
    } else {
      ring[xm] = depth;
      xm = xm + 1 == cbs ? 0 : xm + 1;
    }
  };
  bool run = false;  // the walk re-runs the chunk it is in
  int eq = 0;        // the depths agreeing, in such a chunk
  bool settled = false;
  int64_t walked = 0, c = 0;
  for (; c < nst; c++) {
    if (threadIdx.x >= 32) {
      if (c + 1 < nst) fill(c + 1, threadIdx.x - 32, blockDim.x - 32);
      if (c > 0) drain(c - 1, stage, threadIdx.x - 32, blockDim.x - 32);
    } else {  // warp 0 steps, its lanes in step (no divergent path to yield to)
      const int32_t* const old = stage0 + (c & 1) * span;
      const int32_t* const st = old + stage;
      int32_t* const o = out0 + (c & 1) * 2 * stage;
      const int64_t x1 = x0 + c * stage, cnt = imin(stage, p.n - x1);
      uint32_t nx = CBS > 0 ? static_cast<uint32_t>(st[0]) : 0u;  // read a node ahead
      // node i's choice, written to the outputs; returns its depth
      auto step = [&](int64_t i) {
        int32_t depth, best_r = 0;
        if (CBS > 0) {
          // the flags in the order's order (byte 0, r = 0, is clear, so
          // the zeros past the list never hit); the first set is the shift
          const uint32_t ord = nx;
          nx = i + 1 < cnt ? static_cast<uint32_t>(st[i + 1]) : 0u;
          const uint32_t lo = __byte_perm(fl, fh, ord & 0xffff);
          const uint32_t hi = __byte_perm(fl, fh, ord >> 16);
          const int kk = lo ? (__ffs(lo) - 1) >> 3 : 4 + ((__ffs(hi) - 1) >> 3);
          const int e = lo | hi ? static_cast<int>(ord >> (4 * kk) & 7) : 0;
          // dep[e] by a tree of selects on e's bits, the newest depth
          // (dep[1]) three selects from the result
          int32_t t[8];
#pragma unroll
          for (int j = 0; j < 8; j++) t[j] = j && j < R ? dep[j < R ? j : 0] : 0;
#pragma unroll
          for (int b = 0; b < 3; b++)
#pragma unroll
            for (int j = 0; j < 8 >> (b + 1); j++) t[j] = e >> b & 1 ? t[2 * j + 1] : t[2 * j];
          depth = e ? t[0] + 1 : 0;
          best_r = e;
        } else {
          const int32_t* row = st + i * cbs;
          int32_t best = -1, best_dep = -1;
          for (int r = 0; r < cbs; r++) {
            const int32_t cr = row[r];
            int slot = xm - r;
            if (slot < 0) slot += cbs;
            const int32_t dr = ring[slot];
            if (cr >= 0 && (r == 0 || dr < p.mr) && (best < 0 || cr < best)) {
              best = cr;
              best_r = r;
              best_dep = r ? dr : -1;
            }
          }
          depth = best_dep + 1;
        }
        take(depth);
        o[i] = best_r;
        o[stage + i] = depth;
        return depth;
      };
      for (int64_t i = 0; i < cnt;) {
        const int64_t x = x1 + i;
        if (x % SEL_C == 0) {  // a chunk's first node
          const int64_t ch = x / SEL_C;
          const bool moved = run && eq < w;  // the walk changed the last chunk's tail
          if (ch > l && !moved) {
            s_stop = i;
            break;
          }
          run = moved || __ldcg(p.chg + ch - 1) == k;
          settled = false;
          if (CBS > 0) nx = static_cast<uint32_t>(st[i]);  // past a chunk that stands
          if (run) {  // the true ring against the one the chunk last ran from
            const int32_t* g = p.last + ch * w;
            bool same = true;
            eq = 0;
            if (CBS > 0) {
#pragma unroll
              for (int r = 1; r < R; r++) {
                same = same && __ldcg(g + w - r) == dep[r];
                eq += same;
              }
            } else {
              for (int r = 1; r <= w; r++) {
                const int slot = xm - r < 0 ? xm - r + cbs : xm - r;
                same = same && __ldcg(g + w - r) == ring[slot];
                eq += same;
              }
            }
          }
        }
        // to the chunk's end (or the stage's) with no branch but the loop's
        const int64_t lim = imin(cnt, i + SEL_C - x % SEL_C);
        if (run) {
          for (; i < lim; i++) {
            // settled: the rest of the chunk runs again to its stored values
            settled = settled || eq >= w;
            eq = step(i) == old[i] ? eq + 1 : 0;
            walked += !settled;
          }
        } else {  // the chunk stands: its last w depths enter the ring
          for (int64_t j = i + lane; j < lim; j += 32) o[j] = -1;
          for (int64_t j = lim - w > i ? lim - w : i; j < lim; j++) take(old[j]);
          i = lim;
        }
      }
    }
    __syncthreads();
    if (s_stop >= 0) break;
  }
  if (c < nst)
    drain(c, s_stop, threadIdx.x, blockDim.x);
  else
    drain(nst - 1, imin(stage, p.n - x0 - (nst - 1) * stage), threadIdx.x, blockDim.x);
  return walked;
}

// The chunks a thread takes: lane l of warp slot s (warp-major over the
// blocks, so the first slots spread over the SMs) takes chunk 32 s + l,
// then 32 (s + slots) + l, ...
struct Chunks {
  int64_t first, step;
  __device__ Chunks()
      : first((static_cast<int64_t>(threadIdx.x / 32) * gridDim.x + blockIdx.x) * 32 +
              (threadIdx.x & 31)),
        step(static_cast<int64_t>(gridDim.x) * blockDim.x) {}
};

// Chunks of SEL_C nodes, a thread each: (1) each runs from a ring of zero
// depths; (2) a round reads every chunk's incoming ring (the depths of the
// w nodes before it) behind a grid barrier, and a chunk whose ring differs
// from the one it last ran from re-runs from it (run_chunk's repair); rounds
// go on while a repair changed a depth that a later chunk's ring holds, the
// third and later only while the round before cut the chunks still
// changing by SEL_GAIN, at most SEL_ROUNDS; (3) if one still did, block 0
// walks the rest.  head: [SW_ROUNDS] rounds run, [SW_RERUN] nodes re-run
// by repairs, [SW_SERIAL] nodes re-run by the walk.
template <int CBS>
__global__ void __launch_bounds__(SEL_THREADS) enc_select(Sel p) {
  extern __shared__ __align__(16) int32_t sm[];
  const int w = p.cbs - 1;
  const Chunks ch;
  unsigned long long* const head = p.head;
  for (int64_t c = ch.first; c < p.nch; c += ch.step) {
    bool tail = false;
    const int64_t lo = c * SEL_C, end = imin(lo + SEL_C, p.n);
    if constexpr (CBS > 0) {
      int32_t dep[CBS] = {};
      run_chunk(p, lo, end, dep, -1, tail);
    } else {
      run_chunk_any(p, lo, end, nullptr, -1, tail);
    }
  }
  unsigned long long bar = 0;  // barriers passed
  int64_t rerun = 0;
  int rounds = 0;
  bool walking = false;
  for (int k = 1; p.nch > 1; k++) {
    grid_sync(head + SW_BARRIER, ++bar * gridDim.x);
    if (k > 1) {
      const unsigned long long ck = __ldcg(head + SW_CHANGED + k - 2);
      if (ck == 0) break;
      if (k > SEL_ROUNDS || (k > 2 && __ldcg(head + SW_CHANGED + k - 3) < ck + SEL_GAIN)) {
        walking = true;
        break;
      }
    }
    rounds = k;
    for (int64_t c = ch.first; c < p.nch; c += ch.step)
      for (int j = 0; j < w; j++) {
        const int64_t z = c * SEL_C - w + j;
        p.snap[c * w + j] = z >= 0 ? __ldcg(p.depths + z) : 0;
      }
    grid_sync(head + SW_BARRIER, ++bar * gridDim.x);
    for (int64_t c = ch.first; c < p.nch; c += ch.step) {
      int32_t* const s = p.snap + c * w;
      int32_t* const g = p.last + c * w;
      int eq = 0;  // the depths before the chunk that agree, nearest first
      while (eq < w && s[w - 1 - eq] == g[w - 1 - eq]) eq++;
      if (c == 0 || eq == w) continue;
      bool tail = false;
      const int64_t lo = c * SEL_C, end = imin(lo + SEL_C, p.n);
      if constexpr (CBS > 0) {
        int32_t dep[CBS];
        dep[0] = 0;
#pragma unroll
        for (int r = 1; r < CBS; r++) dep[r] = s[w - r];
        rerun += run_chunk(p, lo, end, dep, eq, tail);
      } else {
        rerun += run_chunk_any(p, lo, end, s, eq, tail);
      }
      for (int j = 0; j < w; j++) g[j] = s[j];
      if (tail && c + 1 < p.nch) {
        atomicAdd(head + SW_CHANGED + k - 1, 1ull);
        p.chg[c] = k;
      }
    }
  }
  if (rerun) atomicAdd(head + SW_RERUN, static_cast<unsigned long long>(rerun));
  if (blockIdx.x != 0) return;
  if (walking) {
    const int64_t walked = walk<CBS>(p, sm, rounds);
    if (threadIdx.x == 0) head[SW_SERIAL] = walked;
  }
  if (threadIdx.x == 0) head[SW_ROUNDS] = rounds;
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

// The most blocks of enc_select<CBS> co-resident at `smem` bytes a block,
// found once a device and instance (the generic one again when its shared
// memory changes).
int g_sel[64][9][2];  // [device][CBS][smem, blocks]

template <int CBS>
cudaError_t launch_select(Sel p, cudaStream_t st) {
  // nodes a stage of the walk: a multiple of 4 where it fits, so the
  // stages take 16-byte loads
  const int64_t per = CBS > 0 ? 2 : p.cbs + 1;  // ints a node of a stage
  int64_t stage = imin(SEL_STAGE, (SEL_SMEM / 4 - p.cbs) / (2 * per + 4));
  if (stage >= 4) stage &= ~int64_t{3};
  if (stage < 1) return cudaErrorInvalidValue;
  p.stage = static_cast<int>(stage);
  const int smem = static_cast<int>((2 * stage * per + 4 * stage + (CBS == 0 ? p.cbs : 0)) * 4);
  const void* kernel = reinterpret_cast<const void*>(enc_select<CBS>);
  cudaError_t e = cudaFuncSetAttribute(enc_select<CBS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int* const cache = g_sel[dev][CBS];
  if (cache[0] != smem) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SEL_THREADS, smem);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[0] = smem;
    cache[1] = sms * per_sm;
  }
  // a warp slot a block first, so that a small grid's chains spread over
  // the SMs; no more blocks than warps of 32 chunks
  const int64_t want = (p.nch + 31) / 32;
  const unsigned blocks = static_cast<unsigned>(imin(want, cache[1]));
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(SEL_THREADS), args, smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return e;
  }
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

// scratch: int64[scratch_words], zeroed, at least SEL_WORDS + nch (2 w +
// 1) / 2 rounded up (nch = ceil(n / SEL_C)); its first three words get
// the counts.
extern "C" int wgt_enc_select(const void* costs, const void* valid, int64_t n, int w,
                              int64_t maxref, void* refs, void* depths, void* scratch,
                              int64_t scratch_words, void* stream) {
  if (n < 1 || w < 0 || !scratch) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nch = (n + SEL_C - 1) / SEL_C;
  if (scratch_words < SEL_WORDS + (nch * (2 * w + 1) + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Sel p{};
  p.costs = static_cast<const int32_t*>(costs);
  p.valid = static_cast<const uint8_t*>(valid);
  p.n = n;
  p.nch = nch;
  p.cbs = w + 1;
  // a depth is at most n - 1 < 2^31 - 1, so clamping maxref keeps `<`
  p.mr = static_cast<int32_t>(maxref > 0x7fffffff ? 0x7fffffff : (maxref < 0 ? -1 : maxref));
  p.aligned = reinterpret_cast<uintptr_t>(costs) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(valid) % 8 == 0;
  p.refs = static_cast<int32_t*>(refs);
  p.depths = static_cast<int32_t*>(depths);
  p.head = static_cast<unsigned long long*>(scratch);
  p.last = reinterpret_cast<int32_t*>(p.head + SEL_WORDS);
  p.snap = p.last + nch * w;
  p.chg = p.snap + nch * w;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (w + 1) {
    case 1: e = launch_select<1>(p, st); break;
    case 2: e = launch_select<2>(p, st); break;
    case 3: e = launch_select<3>(p, st); break;
    case 4: e = launch_select<4>(p, st); break;
    case 5: e = launch_select<5>(p, st); break;
    case 6: e = launch_select<6>(p, st); break;
    case 7: e = launch_select<7>(p, st); break;
    case 8: e = launch_select<8>(p, st); break;
    default: e = launch_select<0>(p, st);
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
