// K2: the long-reference-chain BVGraph decode for Hopper (sm_90a), in two
// kernels.
//
// Replaces webgraph_tpu/pallas/decode.py::build_kernel (:423, launched by
// _compiled through pl.pallas_call at :1333), the route of
// decode_to_csr_auto for graphs whose reference chains reach back further
// than K1 takes (decode2.supports).  The TPU kernel walks 1,024-node blocks in a
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
//   the residuals, ascending) to ext[offsets[x] ..) (wgt::parse_record,
//   records.cuh, which K1 shares).  A node of depth 0
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
//   one binary search each (wgt::keep_and_merge, records.cuh;
//   kernels/levels.py::merge_copies_plain is this arithmetic in plain
//   torch).  The runs must share no value, or two land
//   in one slot and another slot stays unwritten: an extra that equals a
//   kept value fails the node.  Then a release fence and the node's flag.
//   Bound: the longest chain, one link at a time: the flag's trip through
//   L2, the parent's slots from L2, the merge, the release.
//
// k2_resolve also resolves K1's copies (decode2.cu), after k1_parse: K1's
// chains are at most 3 links on cnr-2000's maxref 3, and a launch per chain
// depth in place of the ticket and the flags measured no faster there.
//
// A node whose parse or resolve fails still publishes its flag, marked
// failed; its children record ERR_PARENT instead of waiting.  Every error
// goes to a per-node array that the wrapper checks once after the launches.
// Every C entry point returns cudaGetLastError() after its launches.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "records.cuh"

namespace {

using wgt::ERR_PARENT;
using wgt::ERR_PLAN;
using wgt::FAILED;
using wgt::FULL;
using wgt::NOT_READY;
using wgt::READY;

constexpr int PARSE_THREADS = 128;
constexpr int RESOLVE_THREADS = 256;
constexpr int RESOLVE_WARPS = RESOLVE_THREADS / 32;
constexpr int STAGE = 1024;  // a warp's shared staging, int32 slots (4 KB)
// polls of a parent's flag before ERR_WAIT: seconds of waiting, far past
// any chain a decode can hold
constexpr int64_t MAX_POLLS = int64_t(1) << 26;
constexpr unsigned MAX_SLEEP_NS = 64;

// K2's own error code (kernels/levels.py names it)
constexpr int ERR_WAIT = 7;  // the parent's flag did not come within MAX_POLLS

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
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
                       : wgt::parse_record(rd, c, x, depth0, off, bstart, bend,
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
  int32_t e_end = lane < bc ? bend[bs + lane] : INT_MAX;

  const int f = wait_ready(flags + p);
  if (f == NOT_READY) return ERR_WAIT;
  if (f == FAILED) return ERR_PARENT;
  return wgt::keep_and_merge(lane, stage, succ + pb, dp, bend + bs, bc, e_end, ne, d,
                             succ + base);
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
  const int pre_w = wgt::warp_excl_scan<5>(c, total);
  if (lane == 0) wsum[w] = total;
  __syncthreads();
  if (w == 0) {
    const int s = lane < lanes / 32 ? wsum[lane] : 0;
    int all;
    const int pre = wgt::warp_excl_scan<10>(s, all);
    __syncwarp();
    wsum[lane] = pre;
  }
  __syncthreads();
  const int pre = wsum[w] + pre_w;
  for (int k = 0; k < c; ++k) pool[pre + k] = vals[k * lanes + l];
  __syncthreads();
  for (int k = 0; k < depth; ++k) q[k * lanes + l] = pool[qpos[l] + k];
}

// k2_resolve over order[b1 .. n) with as many blocks as stay resident,
// after a parse has filled ext, bend, rank, pref, nex, err and the flags
// (depth 0 set, every other node NOT_READY).  Zeroes the ticket first.
cudaError_t launch_resolve(const int64_t* off, const int32_t* order, int64_t b1, int64_t n,
                           const int64_t* bstart, const int32_t* bend, int32_t* ext,
                           const int32_t* rank, const int32_t* pref, const int32_t* nex,
                           int32_t* flags, int32_t* ticket, int32_t* succ, int32_t* err,
                           cudaStream_t s) {
  cudaMemsetAsync(ticket, 0, sizeof(int32_t), s);
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k2_resolve, RESOLVE_THREADS, 0);
  const int64_t want = (n - b1 + RESOLVE_WARPS - 1) / RESOLVE_WARPS;
  const int64_t resident = static_cast<int64_t>(per > 0 ? per : 1) * (sms > 0 ? sms : 1);
  k2_resolve<<<static_cast<unsigned>(want < resident ? want : resident),
               RESOLVE_THREADS, 0, s>>>(off, order, b1, n, bstart, bend, ext, rank,
                                        pref, nex, flags, ticket, succ, err);
  return cudaGetLastError();
}

}  // namespace

// One decode: zeroes the flags, launches k2_parse over all n nodes and,
// when `resolve` is set and a node has depth >= 1, k2_resolve over
// order[b1 .. n).  With `resolve` 0 and succ == ext it is the parse alone.
// launched[0] and launched[1] get the launches of k2_parse and k2_resolve.
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
  e = launch_resolve(i64(off), i32(order), b1, n, i64(bstart), i32(bend), o32(ext),
                     i32(rank), i32(pref), i32(nex), o32(flags), o32(ticket), o32(succ),
                     o32(err), s);
  if (e == cudaSuccess) launched[1] = 1;
  return static_cast<int>(e);
}

// k2_resolve alone, after another parse (K1's k1_parse) has filled its
// inputs: the copies of order[b1 .. n), when it holds a node.  launched[0]
// gets its launches.
extern "C" int wgt_k2_resolve(const void* off, const void* order, int64_t b1, int64_t n,
                              const void* bstart, const void* bend, void* ext,
                              const void* rank, const void* pref, const void* nex,
                              void* flags, void* ticket, void* succ, void* err,
                              int* launched, void* stream) {
  launched[0] = 0;
  if (n <= b1) return static_cast<int>(cudaGetLastError());
  const auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto o32 = [](void* p) { return static_cast<int32_t*>(p); };
  const cudaError_t e =
      launch_resolve(i64(off), i32(order), b1, n, i64(bstart), i32(bend), o32(ext),
                     i32(rank), i32(pref), i32(nex), o32(flags), o32(ticket), o32(succ),
                     o32(err), static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) launched[0] = 1;
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
