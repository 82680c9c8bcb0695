// K2: the long-reference-chain BVGraph decode for Hopper (sm_90a), in two
// kernels.
//
// Replaces webgraph_tpu/pallas/decode.py::build_kernel (:423, launched by
// _compiled through pl.pallas_call at :1333), the route of
// decode_to_csr_auto for graphs whose reference chains reach back further
// than K1's lanes cover.  The TPU kernel walks 1,024-node blocks in a
// sequential grid: _p1b_blocks (:669) and _p2_extras (:799) parse the copy
// blocks, intervals and residuals, then _p3_round (:938) resolves the copies
// one in-block chain depth at a time out of a compacted VMEM pool
// (compact_slab :352, pool_fetch_queue :272), and a halo of the last
// `window` lists goes on to the next block.  The pool, its bf16 byte-plane
// mirror and the one-hot MXU fetches serve Mosaic and have no counterpart
// here.  What it computes is the CSR of the graph, each list the sorted union
// of the copied part of its parent's list, its interval runs and its
// gap-coded residuals.  The split into parse and resolve stays, over the
// whole graph at once, one launch each:
//
// k2_parse: every record, one thread a node.  Nothing in a record depends on
//   another list, so this one launch fills the card.  A thread reads its
//   record through wgt::BufReader (a 64-bit buffer in registers, refilled a
//   word at a time) and writes its block ends, cumulative in the parent's
//   list, to bend[bstart[x] ..) and its extras (the interval runs merged with
//   the residuals, ascending) to ext[offsets[x] ..).  A node of depth 0
//   copies nothing: its extras are its list, written straight to succ, and
//   its ready flag is set.  Thread i takes the record of order[i]; handing
//   the hubs out first, or one a warp, gained nothing measured on the K2
//   cells.  Bound: the longest record's chain of dependent code reads and
//   merge steps (a hub of thousands of arcs), not bytes.
//
// k2_resolve: the copy chains, in one persistent launch, a warp a node.
//   Warps take the nodes of depth >= 1 in depth order (`order[b1:]`) from a
//   ticket counter.  A node's parent has a smaller ticket, taken by a warp
//   that is already running, so every wait ends, independent chains overlap
//   and no grid barrier is needed.  The warp prefetches its node's extras
//   (into shared memory) and block ends, then waits for the parent's flag
//   (an acquire load at GPU scope, __nanosleep back-off, capped), keeps the
//   parent's slots that have an even number of block ends at or before them
//   (the toggle rule; ballot compaction, warp_excl_scan), and merges kept
//   and extra values by rank into succ[offsets[x] ..): a value goes to its
//   index in its own run plus the count of the other run's values below it,
//   one binary search each (kernels/decode.py::merge_copies_plain is this
//   arithmetic in plain torch).  The runs must share no value, or two land
//   in one slot and another slot stays unwritten: an extra that equals a
//   kept value fails the node.  Then a release fence and the node's flag.
//   Bound: the longest chain, one link at a time: the flag's trip through
//   L2, the parent's slots from L2, the merge, the release.
//
// A node whose parse or resolve fails still publishes its flag, marked
// failed; its children record ERR_PARENT instead of waiting.  Every error
// goes to a per-node array that the wrapper checks once after the launches.
// Every C entry point returns cudaGetLastError() after its launches.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "pcodes.cuh"

namespace {

constexpr int PARSE_THREADS = 128;
constexpr int RESOLVE_THREADS = 256;
constexpr int RESOLVE_WARPS = RESOLVE_THREADS / 32;
constexpr int STAGE = 1024;  // a warp's shared staging, int32 slots (4 KB)
constexpr unsigned FULL = 0xffffffffu;
// polls of a parent's flag before ERR_WAIT: seconds of waiting, far past
// any chain a decode can hold
constexpr int64_t MAX_POLLS = int64_t(1) << 26;
constexpr unsigned MAX_SLEEP_NS = 64;

// ready flags
constexpr int NOT_READY = 0, READY = 1, FAILED = 2;

// K2's own error codes (kernels/decode.py names them)
constexpr int ERR_PLAN = 5;    // the record's reference disagrees with the depth plan
constexpr int ERR_PARENT = 6;  // the parent's list failed
constexpr int ERR_WAIT = 7;    // the parent's flag did not come within MAX_POLLS

// Exclusive prefix sum over the warp's lanes of per-lane counts below
// 2^BITS, and the warp's total: one ballot per bit.  With BITS = 1 it is the
// ballot-and-popc compaction of k2_resolve.  All 32 lanes must call it.
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

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
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

// Parses node x's record; returns an error code.  Writes the block ends to
// bend[bstart[x] ..), the extras to dst[offsets[x] ..), and the reference
// and extras count to ref, ne.
__device__ int parse_record(wgt::BufReader& rd, const wgt::Codings& c, int64_t x,
                            bool depth0, const int64_t* __restrict__ off,
                            const int64_t* __restrict__ bstart, int32_t* __restrict__ bend,
                            int32_t* dst, int32_t& ref, int32_t& ne) {
  const int64_t base = off[x];
  const int64_t d = off[x + 1] - base;
  const int64_t dd = rd.read(c.outd, c.k);
  if (rd.err) return rd.err;
  if (dd != d) return wgt::ERR_COUNT;
  int64_t r = 0;
  if (d > 0 && c.window > 0) {
    r = rd.read(c.ref, c.k);
    if (rd.err) return rd.err;
    if (r > c.window || r > x) return wgt::ERR_REF;
  }
  if (depth0 != (r == 0)) return ERR_PLAN;
  ref = static_cast<int32_t>(r);

  // copy blocks: the first as is, later ones + 1; even blocks are copied,
  // and the tail past the last block when the count is even
  int64_t copied = 0;
  if (r > 0) {
    const int64_t dp = off[x - r + 1] - off[x - r];
    const int64_t bc = rd.read(c.bcnt, c.k);
    if (rd.err) return rd.err;
    const int64_t b0 = bstart[x];
    if (bc != bstart[x + 1] - b0) return wgt::ERR_COUNT;
    int64_t cum = 0;
    for (int64_t k = 0; k < bc; ++k) {
      const int64_t v = rd.read(c.blk, c.k) + (k > 0);
      if (rd.err) return rd.err;
      cum += v;
      if (!(k & 1)) copied += v;
      bend[b0 + k] = static_cast<int32_t>(cum);
    }
    if (cum > dp) return wgt::ERR_COUNT;
    if (!(bc & 1)) copied += dp - cum;
  }
  if (copied > d) return wgt::ERR_COUNT;
  const int64_t extras = d - copied;
  ne = static_cast<int32_t>(extras);
  if (extras == 0) return 0;

  // intervals: count, then (left, length) pairs, read once here to count
  // their arcs and again from the saved cursor `iv` during the merge
  int64_t icnt = 0, iarcs = 0;
  wgt::BufReader iv = rd;
  if (c.minint != 0) {
    icnt = rd.read(wgt::GAMMA, c.k);
    iv = rd;
    for (int64_t j = 0; j < icnt && !rd.err; ++j) {
      rd.read(wgt::GAMMA, c.k);
      iarcs += rd.read(wgt::GAMMA, c.k) + c.minint;
    }
    if (rd.err) return rd.err;
    if (iarcs > extras) return wgt::ERR_COUNT;
  }

  // merge the interval runs (first left = x + nat2int(v), later prev end
  // + 1 + v) with the residuals (first x + nat2int(v), later prev + 1 + v);
  // an interval's values below the next residual go out in one tight run
  int64_t ileft = icnt, ival = 0, irem = 0, iprev = 0;
  int64_t rleft = extras - iarcs, rv = 0;
  bool ifirst = true, rfirst = true, rvok = false;
  int64_t em = 0;
  while (em < extras) {
    if (irem == 0 && ileft > 0) {
      const int64_t v = iv.read(wgt::GAMMA, c.k);
      ival = ifirst ? x + wgt::nat2int(static_cast<uint32_t>(v)) : iprev + 1 + v;
      ifirst = false;
      irem = iv.read(wgt::GAMMA, c.k) + c.minint;
      iprev = ival + irem;
      --ileft;
    }
    if (!rvok && rleft > 0) {
      const int64_t v = rd.read(c.res, c.k);
      rv = rfirst ? x + wgt::nat2int(static_cast<uint32_t>(v)) : rv + 1 + v;
      rfirst = false;
      rvok = true;
      --rleft;
    }
    if (rd.err) return rd.err;
    if (iv.err) return iv.err;
    if (irem > 0 && (!rvok || ival <= rv)) {
      int64_t run = irem;
      if (rvok && rv - ival < run) run = rv - ival > 1 ? rv - ival : 1;
      if (run > extras - em) return wgt::ERR_COUNT;
      for (int64_t t = 0; t < run; ++t) dst[base + em + t] = static_cast<int32_t>(ival + t);
      em += run;
      irem -= run;
      ival += run;
    } else if (rvok) {
      dst[base + em++] = static_cast<int32_t>(rv);
      rvok = false;
    } else {
      return wgt::ERR_COUNT;
    }
  }
  return 0;
}

// Every record: thread j parses the node at order position j.  `succ` may
// be `ext` (the parse alone, as parse_records_plain lays it out).
__global__ void __launch_bounds__(PARSE_THREADS)
k2_parse(const uint64_t* __restrict__ words, int64_t nbits,
         const int64_t* __restrict__ bo, const int64_t* __restrict__ off,
         const int32_t* __restrict__ order, const int64_t* __restrict__ bstart,
         int64_t n, int64_t b1, wgt::Codings c, int32_t* ext,
         int32_t* __restrict__ bend, int32_t* __restrict__ rank,
         int32_t* __restrict__ pref, int32_t* __restrict__ nex,
         int32_t* __restrict__ flags, int32_t* succ, int32_t* __restrict__ err) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int64_t x = order[j];
  const bool depth0 = j < b1;
  rank[x] = static_cast<int32_t>(j);
  wgt::BufReader rd;
  rd.init(words, nbits, bo[x]);
  int32_t r = 0, ne = 0;
  const int e = rd.err ? rd.err
                       : parse_record(rd, c, x, depth0, off, bstart, bend,
                                      depth0 ? succ : ext, r, ne);
  if (depth0) flags[x] = e ? FAILED : READY;
  pref[x] = r;
  nex[x] = ne;
  err[j] = e;
}

// Waits until the flag is set; returns it, or NOT_READY past MAX_POLLS.
// Every lane loads with acquire, so each lane's later loads see the list.
__device__ int wait_ready(const int32_t* flag) {
  unsigned ns = 8;
  for (int64_t polls = 0; polls < MAX_POLLS; ++polls) {
    const int f = ld_acquire(flag);
    if (__all_sync(FULL, f != NOT_READY)) return f;
    __nanosleep(ns);
    if (ns < MAX_SLEEP_NS) ns <<= 1;
  }
  return NOT_READY;
}

// One node of depth >= 1 by one warp; returns an error code.  `sm` is the
// warp's shared staging.
__device__ int resolve_node(int lane, int32_t* sm, int64_t j, int64_t x,
                            const int64_t* __restrict__ off,
                            const int64_t* __restrict__ bstart,
                            const int32_t* __restrict__ bend, int32_t* ext,
                            const int32_t* __restrict__ rank,
                            const int32_t* __restrict__ pref,
                            const int32_t* __restrict__ nex, const int32_t* flags,
                            int32_t* succ) {
  const int64_t p = x - pref[x];
  if (rank[p] >= j) return ERR_PLAN;
  const int64_t base = off[x];
  const int64_t d = off[x + 1] - base;
  const int64_t ne = nex[x];
  const int64_t nk = d - ne;
  const int64_t pb = off[p];
  const int64_t dp = off[p + 1] - pb;
  const int64_t bs = bstart[x];
  const int64_t bc = bstart[x + 1] - bs;

  // before the wait: the extras into the staging (shared memory when the
  // list fits, else the node's own slots of ext, where they already are),
  // and the first 32 block ends into the lanes
  int32_t* const stage = d <= STAGE ? sm : ext + base;
  if (d <= STAGE)
    for (int64_t k = lane; k < ne; k += 32) sm[k] = ext[base + k];
  int64_t wb = 0;
  int32_t e_end = lane < bc ? bend[bs + lane] : INT_MAX;

  const int f = wait_ready(flags + p);
  if (f == NOT_READY) return ERR_WAIT;
  if (f == FAILED) return ERR_PARENT;

  // the kept parent slots, 32 at a time, compacted after the extras.  kb
  // block ends lie before the chunk; those inside it set bits of `mask`.
  int64_t kb = 0, kept = 0;
  for (int64_t c0 = 0; c0 < dp; c0 += 32) {
    if (kb == bc && (bc & 1)) break;  // past the last end of an odd count
    if (kb != wb) {
      wb = kb;
      e_end = wb + lane < bc ? bend[bs + wb + lane] : INT_MAX;
    }
    const int64_t rel = static_cast<int64_t>(e_end) - c0;
    const unsigned mask =
        __reduce_or_sync(FULL, rel >= 0 && rel < 32 ? 1u << rel : 0u);
    const int64_t jj = c0 + lane;
    const bool keep =
        jj < dp && !((kb + __popc(mask & (FULL >> (31 - lane)))) & 1);
    int total;
    const int at = warp_excl_scan<1>(keep, total);
    if (keep && ne + kept + at < d) stage[ne + kept + at] = __ldcg(succ + pb + jj);
    kept += total;
    kb += __popc(mask);
  }
  if (kept != nk) return wgt::ERR_COUNT;
  __syncwarp();

  // merge by rank: extras stage[0, ne), kept stage[ne, d); an extra found
  // among the kept values is a corrupted record
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
    succ[base + at] = v;
  }
  return __any_sync(FULL, clash) ? wgt::ERR_COUNT : 0;
}

// The nodes of depth >= 1, order[b1 .. n), a warp each, by ticket.
__global__ void __launch_bounds__(RESOLVE_THREADS)
k2_resolve(const int64_t* __restrict__ off, const int32_t* __restrict__ order,
           int64_t b1, int64_t n, const int64_t* __restrict__ bstart,
           const int32_t* __restrict__ bend, int32_t* ext,
           const int32_t* __restrict__ rank, const int32_t* __restrict__ pref,
           const int32_t* __restrict__ nex, int32_t* flags, int32_t* ticket,
           int32_t* succ, int32_t* err) {
  __shared__ int32_t stage[RESOLVE_WARPS][STAGE];
  const int lane = threadIdx.x & 31;
  int32_t* const sm = stage[threadIdx.x >> 5];
  const int64_t count = n - b1;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(ticket, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= count) break;
    const int64_t j = b1 + t;
    const int64_t x = order[j];
    int e = err[j];
    if (!e)
      e = resolve_node(lane, sm, j, x, off, bstart, bend, ext, rank, pref, nex,
                       flags, succ);
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      err[j] = e;
      st_release(flags + x, e ? FAILED : READY);
    }
  }
}

// The probe of the warp compaction: the counterpart of
// scripts/pallas_compact_chip.py:60 (compact_slab and pool_fetch_queue of
// decode.py:352, 272).  One block, a thread a lane: lane l's cnt[l] values
// (rows of the lane-major `vals`) go to pool[pre[l] ..), pre the exclusive
// prefix sum of the counts (warp_excl_scan, then across the block's warps);
// then q[k][l] = pool[qpos[l] + k] for k < depth.
__global__ void __launch_bounds__(1024)
k2_compact_probe(const int32_t* __restrict__ vals, const int32_t* __restrict__ cnt,
                 const int32_t* __restrict__ qpos, int depth, int32_t* pool,
                 int32_t* __restrict__ q) {
  __shared__ int wsum[32];
  const int l = threadIdx.x;
  const int lanes = blockDim.x;
  const int lane = l & 31;
  const int w = l >> 5;
  const int c = cnt[l];
  int total;
  const int pre_w = warp_excl_scan<5>(c, total);
  if (lane == 0) wsum[w] = total;
  __syncthreads();
  if (w == 0) {
    const int s = lane < lanes / 32 ? wsum[lane] : 0;
    int all;
    const int pre = warp_excl_scan<10>(s, all);
    __syncwarp();
    wsum[lane] = pre;
  }
  __syncthreads();
  const int pre = wsum[w] + pre_w;
  for (int k = 0; k < c; ++k) pool[pre + k] = vals[k * lanes + l];
  __syncthreads();
  for (int k = 0; k < depth; ++k) q[k * lanes + l] = pool[qpos[l] + k];
}

}  // namespace

// One decode: zeroes the flags and the ticket, launches k2_parse over all n
// nodes and, when `resolve` is set and a node has depth >= 1, k2_resolve
// over order[b1 .. n) with as many blocks as stay resident.  With `resolve`
// 0 and succ == ext it is the parse alone.  launched[0] and launched[1]
// get the launches of k2_parse and k2_resolve.
extern "C" int wgt_k2_decode(const void* words, int64_t nbits, const void* bo,
                             const void* off, const void* order, const void* bstart,
                             int64_t n, int64_t b1, int outd, int ref, int bcnt,
                             int blk, int res, int zeta_k, int window, int minint,
                             void* ext, void* bend, void* rank, void* pref, void* nex,
                             void* flags, void* ticket, void* succ, void* err,
                             int resolve, int* launched, void* stream) {
  const wgt::Codings c{outd, ref, bcnt, blk, res, zeta_k, window, minint};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  launched[0] = launched[1] = 0;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaMemsetAsync(flags, 0, n * sizeof(int32_t), s);
  cudaMemsetAsync(ticket, 0, sizeof(int32_t), s);
  const auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto o32 = [](void* p) { return static_cast<int32_t*>(p); };
  k2_parse<<<static_cast<unsigned>((n + PARSE_THREADS - 1) / PARSE_THREADS),
             PARSE_THREADS, 0, s>>>(
      static_cast<const uint64_t*>(words), nbits, i64(bo), i64(off), i32(order),
      i64(bstart), n, b1, c, o32(ext), o32(bend), o32(rank), o32(pref), o32(nex),
      o32(flags), o32(succ), o32(err));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  launched[0] = 1;
  if (!resolve || n <= b1) return 0;
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k2_resolve, RESOLVE_THREADS, 0);
  const int64_t want = (n - b1 + RESOLVE_WARPS - 1) / RESOLVE_WARPS;
  const int64_t resident = static_cast<int64_t>(per > 0 ? per : 1) * (sms > 0 ? sms : 1);
  k2_resolve<<<static_cast<unsigned>(want < resident ? want : resident),
               RESOLVE_THREADS, 0, s>>>(
      i64(off), i32(order), b1, n, i64(bstart), i32(bend), o32(ext), i32(rank),
      i32(pref), i32(nex), o32(flags), o32(ticket), o32(succ), o32(err));
  e = cudaGetLastError();
  if (e == cudaSuccess) launched[1] = 1;
  return static_cast<int>(e);
}

// The compaction probe: one block of `lanes` threads (a multiple of 32, at
// most 1024).
extern "C" int wgt_k2_compact_probe(const void* vals, const void* cnt, const void* qpos,
                                    int lanes, int depth, void* pool, void* q,
                                    void* stream) {
  k2_compact_probe<<<1, lanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vals), static_cast<const int32_t*>(cnt),
      static_cast<const int32_t*>(qpos), depth, static_cast<int32_t*>(pool),
      static_cast<int32_t*>(q));
  return static_cast<int>(cudaGetLastError());
}
