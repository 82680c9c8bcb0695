// or_pull: reachability by pull over a graph's in-CSR, for Hopper (sm_90a),
// level after level in one persistent cooperative launch, over k words a
// node (64 sources a word).
//
// It has no Pallas counterpart.  It takes the place of
// webgraph_tpu/algo/device.py::_seg_or_scan (:118) and the loops around it
// (nf64 :147, make_nf_batches :204, make_geometric_batches :296, and the
// scatter-max BFS of _bfs_program :67), each one while_loop dispatch in the
// JAX package: XLA has no scatter-OR, so it ORs each node's in-arcs by a
// segmented Hillis-Steele scan over a destination-sorted arc copy,
// O(m log m) a step.  CUDA reaches every in-arc of a node directly, so a
// level here reads each arc once.  Level t, for each word j of each node x:
//
//   new[x][j] = old[x][j] | OR_{y in in(x)} old[y][j]
//   nb        = new[x][j] & ~old[x][j]                 (bits reached now)
//   totals[t][j]      += popcount(nb)                   (always)
//   bits[t][j][b]     += bit b of nb                    (with perbit)
//   dist[x][j] = level0 + t + 1 where old == 0, new != 0 (with dist)
//
// Words are row-major uint64[n][k], so a source's k words are one read.
// Each level reads one buffer and writes the other (ping-pong: the input,
// then a, b, a, ...), so a bit moves one hop a level (Jacobi, as the JAX
// step) and the counts of a level are those of one distance.  A grid-wide
// barrier on a device counter separates the levels; a cooperative launch
// keeps every block resident, so the barrier cannot deadlock.  After it,
// every block reads the level's totals and all stop on the same level: the
// first whose totals are all 0, or the cap.  The host reads the level count
// and the totals once a launch.
//
// The mapping follows the in-degree, from `order` (the nodes sorted by
// in-degree, computed once a graph), `span` (each sorted node's in-arc
// range, one 16-byte read) and `bounds` (bounds[e] = the nodes of in-degree
// <= 2^e).  A node takes G lanes a slot (G = k rounded up to a power of
// two; lane j holds word j) and P slots, the arcs strided over the slots:
// P = 1, 2, 4, ... up to a warp, the least P with in-degree <= 4 P, so each
// lane has two rounds of up to UNROLL gathers in flight; nodes of in-degree
// > 16 P_warp take a block each.  Sorted nodes keep a warp's trip counts
// alike; each class starts on the warps the classes before it left idle,
// so on a small graph the classes' load chains overlap.  A node's own word
// is read before its gathers.  Slots OR-reduce with __shfl_xor_sync
// (across warps through shared memory for a block's node); slot 0's lanes
// store the row, G lanes side by side.  Popcounts are summed in registers.
// Per-bit counts (the kernel's PERBIT instance) go to vertical counters in
// registers (bit b of a lane's count of bit b in slice s), flushed per
// warp by a butterfly of bit-sliced adds over the lanes of a word, then to
// shared memory; each level's counts then take one atomicAdd a block.
//
// Gathers and reads of the word buffers go through L2 (ld.global.cg): a
// buffer written by other SMs in the previous level may still sit in this
// SM's L1 from the level before.
//
// Bound: bytes.  A level must read in_off (8 (n + 1)), in_src (4 m), the
// gathered words (8 k m; each source's row is gathered once per out-arc,
// at 8 k n bytes they stay in the card's L2) and old and new (2 * 8 k n).
// The kernel reads `order` and `span` (20 n) in place of in_off.  Each
// gather of k <= 4 words costs a 32-byte L2 sector, so at k = 1 the
// gathers, not the bound's bytes, set a level's time.
//
// The C entry point returns the launch's error code: a refused cooperative
// launch, a k outside 1..KMAX, or a card without cooperative launches is
// returned, never run another way.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 16;
constexpr int UNROLL = 2;
constexpr int BLOCK_E = 9;  // a warp's nodes: in-degree <= 2^(BLOCK_E - lg G)
constexpr int NS = 8;       // slices of a lane's vertical counters
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

struct Args {
  const int32_t* in_src;
  const int32_t* order;
  const int64_t* bounds;
  const longlong2* span;  // (first, end) of the in-arcs of order[i]
  int64_t n;
  int k, lg;  // words a node, log2 of G
  const u64* in;
  u64* a;
  u64* b;
  // [0] levels run, [1] the barrier's count, [2, 2 + cap k) totals by
  // level and word, then with perbit bits[cap][k][64]
  u64* stat;
  int32_t* dist;
  int level0, cap;
};

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid meets here; `target` is the number of this
// barrier times gridDim.x (the count only rises within a launch).
__device__ void grid_sync(u64* count, u64 target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1ull);
    while (ld_acquire(count) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// OR of word j of the sources of in-arcs first, first + stride, ... < end.
__device__ __forceinline__ u64 gather_or(const int32_t* __restrict__ in_src, const u64* src,
                                         int64_t first, int64_t end, int64_t stride, int k,
                                         int j) {
  u64 acc = 0;
  int64_t q = first;
  for (; q + (UNROLL - 1) * stride < end; q += UNROLL * stride) {
    int32_t y[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) y[u] = __ldg(in_src + q + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc |= __ldcg(src + static_cast<int64_t>(y[u]) * k + j);
  }
  for (; q < end; q += stride) acc |= __ldcg(src + static_cast<int64_t>(__ldg(in_src + q)) * k + j);
  return acc;
}

// Word j of node x, `was` before this level: stores was | acc, writes
// dist, returns the bits reached.
__device__ __forceinline__ u64 finish(const Args& p, u64* dst, int64_t x, int j, u64 was, u64 acc,
                                      int lvl) {
  const int64_t at = x * p.k + j;
  const u64 now = was | acc;
  dst[at] = now;
  if (p.dist != nullptr && was == 0 && now != 0) p.dist[at] = lvl + 1;
  return now & ~was;
}

// nb into the vertical counters c (bit b of c[s]: bit s of the count of b).
__device__ __forceinline__ void vc_add(u64 (&c)[NS], u64 nb) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const u64 t = c[s] & nb;
    c[s] ^= nb;
    nb = t;
  }
}

// The warp's vertical counters into s_bit[j][b] and cleared: summed over
// the lanes of word j by a butterfly of bit-sliced adds (NS + 5 slices hold
// 32 lanes' counts), then lane r of word j's 32 / G lanes adds bits r,
// r + 32 / G, ...  Every lane of the warp calls it.
__device__ __forceinline__ void vc_flush(u64 (&c)[NS], int& nvc, int lane, int j, int lg,
                                         bool word, unsigned* s_bit) {
  u64 any = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) any |= c[s];
  if (__any_sync(FULL, any != 0)) {
    u64 t[NS + 5];
#pragma unroll
    for (int s = 0; s < NS + 5; ++s) t[s] = s < NS ? c[s] : 0;
    for (int o = 1 << lg; o < 32; o <<= 1) {
      u64 carry = 0;
#pragma unroll
      for (int s = 0; s < NS + 5; ++s) {
        const u64 a = t[s], b = __shfl_xor_sync(FULL, a, o);
        const u64 x = a ^ b;
        t[s] = x ^ carry;
        carry = (a & b) | (carry & x);
      }
    }
    if (word) {
      for (int b = lane >> lg; b < 64; b += 32 >> lg) {
        unsigned cnt = 0;
#pragma unroll
        for (int s = 0; s < NS + 5; ++s) cnt |= static_cast<unsigned>((t[s] >> b) & 1ull) << s;
        if (cnt) atomicAdd(&s_bit[j * 64 + b], cnt);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) c[s] = 0;
  nvc = 0;
}

template <bool PERBIT>
__global__ void __launch_bounds__(THREADS) or_pull(Args p) {
  __shared__ u64 s_tot[KMAX];
  __shared__ unsigned s_bit[PERBIT ? KMAX * 64 : 1];
  __shared__ u64 s_red[WARPS][KMAX];
  __shared__ int64_t s_first[6];  // the first warp of each class
  __shared__ int s_stop;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = 1 << p.lg, j = lane & (G - 1), k = p.k;
  const bool word = j < k;  // lanes j >= k of a slot hold no word
  const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * WARPS;
  const int64_t nblock = p.bounds[BLOCK_E - p.lg];
  const int64_t big = p.n - nblock;  // nodes a block each

  if (PERBIT)
    for (int i = threadIdx.x; i < KMAX * 64; i += THREADS) s_bit[i] = 0;
  if (threadIdx.x < KMAX) s_tot[threadIdx.x] = 0;
  // the warp classes, widest first: P slots a node, in-degree <= 4 P (the
  // widest up to 16 P), 32 / (G P) nodes a warp; each class starts on the
  // warp after the last one the classes before it took
  if (threadIdx.x == 0) {
    int64_t w = (big < gridDim.x ? big : gridDim.x) * WARPS;
    for (int c = 5 - p.lg; c >= 0; --c) {
      const int per = 32 >> (p.lg + c);
      const int64_t lo = c == 0 ? 0 : p.bounds[c + 1];
      const int64_t hi = c == 5 - p.lg ? nblock : p.bounds[c + 2];
      s_first[c] = w % nwarps;
      w += (hi - lo + per - 1) / per;
    }
  }
  __syncthreads();

  u64 vc[NS] = {};
  int nvc = 0;
  int t = 0;
  for (;; ++t) {
    const u64* src = t == 0 ? p.in : ((t & 1) ? p.a : p.b);
    u64* dst = (t & 1) ? p.b : p.a;
    const int lvl = p.level0 + t;
    u64 tot = 0;

    // in-degree > 16 slots a warp: a block a node
    const int bslots = THREADS >> p.lg, bslot = threadIdx.x >> p.lg;
    for (int64_t i = nblock + blockIdx.x; i < p.n; i += gridDim.x) {
      const int64_t x = p.order[i];
      const longlong2 r = __ldg(p.span + i);
      const bool mine = warp == 0 && lane < G && word;  // slot 0 of the block
      const u64 was = mine ? __ldcg(src + x * k + j) : 0;
      u64 acc = word ? gather_or(p.in_src, src, r.x + bslot, r.y, bslots, k, j) : 0;
      for (int o = G; o < 32; o <<= 1) acc |= __shfl_xor_sync(FULL, acc, o);
      if (lane < G) s_red[warp][lane] = acc;
      __syncthreads();
      if (warp == 0) {
        u64 nb = 0;
        if (mine) {
          u64 all = 0;
          for (int w = 0; w < WARPS; ++w) all |= s_red[w][lane];
          nb = finish(p, dst, x, j, was, all, lvl);
          tot += __popcll(nb);
        }
        if (PERBIT) {
          vc_add(vc, nb);
          if (__any_sync(FULL, ++nvc == (1 << NS) - 1))
            vc_flush(vc, nvc, lane, j, p.lg, word, s_bit);
        }
      }
      __syncthreads();
    }

    // the warp classes
    for (int c = 5 - p.lg; c >= 0; --c) {
      const int P = 1 << c, S = G << c;  // slots, lanes a node
      const int64_t lo = c == 0 ? 0 : p.bounds[c + 1];
      const int64_t hi = c == 5 - p.lg ? nblock : p.bounds[c + 2];
      const int per = 32 / S, slot = (lane & (S - 1)) >> p.lg;
      int64_t w = gwarp - s_first[c];
      if (w < 0) w += nwarps;
      for (int64_t base = lo + w * per; base < hi; base += nwarps * per) {
        const int64_t i = base + lane / S;
        const bool mine = i < hi && slot == 0 && word;
        u64 acc = 0, was = 0;
        int64_t x = 0;
        if (i < hi) {
          x = p.order[i];
          const longlong2 r = __ldg(p.span + i);
          if (mine) was = __ldcg(src + x * k + j);
          if (word) acc = gather_or(p.in_src, src, r.x + slot, r.y, P, k, j);
        }
        __syncwarp();
        for (int o = G; o < S; o <<= 1) acc |= __shfl_xor_sync(FULL, acc, o);
        u64 nb = 0;
        if (mine) {
          nb = finish(p, dst, x, j, was, acc, lvl);
          tot += __popcll(nb);
        }
        if (PERBIT) {
          vc_add(vc, nb);
          if (__any_sync(FULL, ++nvc == (1 << NS) - 1))
            vc_flush(vc, nvc, lane, j, p.lg, word, s_bit);
        }
      }
    }

    // the level's counts: the lanes of a word, the block, then the card
    if (PERBIT) vc_flush(vc, nvc, lane, j, p.lg, word, s_bit);
    for (int o = G; o < 32; o <<= 1) tot += __shfl_xor_sync(FULL, tot, o);
    if (lane < k && tot) atomicAdd(&s_tot[lane], tot);
    __syncthreads();
    u64* totals = p.stat + 2 + static_cast<int64_t>(t) * k;
    if (threadIdx.x < k) {
      if (s_tot[threadIdx.x]) atomicAdd(totals + threadIdx.x, s_tot[threadIdx.x]);
      s_tot[threadIdx.x] = 0;
    }
    if (PERBIT) {
      u64* bits = p.stat + 2 + static_cast<int64_t>(p.cap) * k + static_cast<int64_t>(t) * k * 64;
      for (int i = threadIdx.x; i < k * 64; i += THREADS) {
        if (s_bit[i]) atomicAdd(bits + i, static_cast<u64>(s_bit[i]));
        s_bit[i] = 0;
      }
    }
    if (t + 1 == p.cap) break;  // kernel completion is the last barrier
    grid_sync(p.stat + 1, static_cast<u64>(t + 1) * gridDim.x);
    if (threadIdx.x == 0) {
      u64 s = 0;
      for (int w = 0; w < k; ++w) s += __ldcg(totals + w);
      s_stop = s == 0;
    }
    __syncthreads();
    if (s_stop) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.stat[0] = static_cast<u64>(t + 1);
}

// blocks a launch of each instance on each device: SMs x occupancy, found
// at the first launch
int g_blocks[64][2];

}  // namespace

// Up to `cap` levels over n nodes of k words from `in` (not written), into
// a and b alternately (the result of L levels in a when L is odd, else b);
// stat: device int64[2 + cap k (+ 64 cap k with perbit)], zeroed; dist:
// device int32[n k] or null; order, bounds, span: the in-degree order.
extern "C" int wgt_or_pull(const void* in_src, const void* order, const void* bounds,
                           const void* span, int64_t n, int k, const void* in, void* a, void* b,
                           void* stat, int perbit, void* dist, int level0, int cap,
                           void* stream) {
  if (k < 1 || k > KMAX || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int pb = perbit != 0;
  const void* kernel = pb ? reinterpret_cast<const void*>(or_pull<true>)
                          : reinterpret_cast<const void*>(or_pull<false>);
  if (g_blocks[dev][pb] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    g_blocks[dev][pb] = sms * per_sm;
  }
  int lg = 0;
  while ((1 << lg) < k) ++lg;
  Args p{static_cast<const int32_t*>(in_src), static_cast<const int32_t*>(order),
         static_cast<const int64_t*>(bounds), static_cast<const longlong2*>(span), n, k, lg,
         static_cast<const u64*>(in), static_cast<u64*>(a), static_cast<u64*>(b),
         static_cast<u64*>(stat), static_cast<int32_t*>(dist), level0, cap};
  // at most SMs x occupancy blocks; fewer where the graph cannot fill them
  // (4 lanes a node), so a small graph's barrier waits on fewer blocks
  const int64_t want = (n * (1 << lg) * 4 + THREADS - 1) / THREADS;
  const unsigned blocks =
      static_cast<unsigned>(want < 1 ? 1 : (want < g_blocks[dev][pb] ? want : g_blocks[dev][pb]));
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args, 0,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Most blocks a launch of or_pull takes on the current device, without and
// with per-bit counts (0 before the first launch of that instance).
extern "C" int wgt_or_pull_blocks(int perbit) {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev >= 0 && dev < 64 ? g_blocks[dev][perbit != 0] : 0;
}
