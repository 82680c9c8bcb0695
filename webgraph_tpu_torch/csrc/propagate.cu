// or_pull: one step of 64-source reachability over a graph's in-CSR, for
// Hopper (sm_90a).
//
// It has no Pallas counterpart.  It takes the place of
// webgraph_tpu/algo/device.py::_seg_or_scan (:118) and the steps around it
// (nf64 :147, make_nf_batches :204, make_geometric_batches :296, and the
// scatter-max BFS of _bfs_program :67): XLA has no scatter-OR, so the JAX
// package ORs each node's in-arcs by a segmented Hillis-Steele scan over a
// destination-sorted arc copy, O(m log m) a step.  CUDA reaches every
// in-arc of a node directly, so a step here reads each arc once:
//
//   new[x] = old[x] | OR_{y in in(x)} old[y]           (64 bits a node)
//   nb[x]  = new[x] & ~old[x]                          (bits reached now)
//   stats[0]      += popcount(nb[x])                   (always)
//   stats[1 + b]  += #{x : bit b of nb[x]}             (when perbit)
//   dist[x] = level + 1 where old[x] == 0, new[x] != 0 (when dist)
//
// `old` is read and `new` written: two buffers, never in place, so a bit
// moves one hop a launch (the JAX step is Jacobi-style too) and the counts
// of a launch are those of one distance.
//
// A warp a node (grid-stride over the nodes): the lanes stride over the
// node's in-arcs and OR-reduce with __shfl_xor_sync, so a hub's in-list of
// thousands of arcs is read by 32 lanes, not one thread.  Popcounts are
// summed in registers, then per block in shared memory, then one atomicAdd
// a block to device memory; for the per-bit counts lane b counts bits b and
// b + 32 of each of its warp's words, with one flush a block.
//
// Bound: bytes.  A launch reads in_off (8 (n + 1)), in_src (4 m), the
// gathered old words (8 m) and old and new (2 * 8 n).  The gathers are
// random 8-byte reads, so the kernel sits above the streaming bound; wider
// words (several batches a launch) and staging are later work.
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
    or_pull(const int64_t* __restrict__ in_off, const int32_t* __restrict__ in_src,
            int64_t n, const unsigned long long* __restrict__ old,
            unsigned long long* __restrict__ out, unsigned long long* __restrict__ stats,
            int perbit, int32_t* __restrict__ dist, int32_t level) {
  __shared__ unsigned long long s_total;
  __shared__ unsigned long long s_bit[64];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_total = 0;
  if (threadIdx.x < 64) s_bit[threadIdx.x] = 0;
  __syncthreads();

  unsigned long long total = 0, lo = 0, hi = 0;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t x = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5); x < n;
       x += nwarps) {
    const int64_t a = in_off[x], b = in_off[x + 1];
    unsigned long long acc = 0;
    for (int64_t i = a + lane; i < b; i += 32) acc |= old[in_src[i]];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc |= __shfl_xor_sync(FULL, acc, o);
    const unsigned long long was = old[x];
    const unsigned long long now = was | acc;
    const unsigned long long nb = now & ~was;
    if (lane == 0) {
      out[x] = now;
      total += static_cast<unsigned long long>(__popcll(nb));
      if (dist != nullptr && was == 0 && now != 0) dist[x] = level + 1;
    }
    if (perbit) {
      lo += (nb >> lane) & 1ull;
      hi += (nb >> (lane + 32)) & 1ull;
    }
  }

  if (lane == 0 && total) atomicAdd(&s_total, total);
  if (perbit) {
    if (lo) atomicAdd(&s_bit[lane], lo);
    if (hi) atomicAdd(&s_bit[lane + 32], hi);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_total) atomicAdd(&stats[0], s_total);
  if (perbit && threadIdx.x < 64 && s_bit[threadIdx.x])
    atomicAdd(&stats[1 + threadIdx.x], s_bit[threadIdx.x]);
}

}  // namespace

// One step over n nodes.  stats: device int64[65] (perbit) or int64[1], added
// to; dist: device int32[n] or null.
extern "C" int wgt_or_pull(const void* in_off, const void* in_src, int64_t n,
                           const void* old, void* out, void* stats, int perbit,
                           void* dist, int level, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int64_t want = (n + WARPS - 1) / WARPS;
  const int64_t cap = static_cast<int64_t>(sms) * (2048 / THREADS);
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  or_pull<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in_off), static_cast<const int32_t*>(in_src), n,
      static_cast<const unsigned long long*>(old), static_cast<unsigned long long*>(out),
      static_cast<unsigned long long*>(stats), perbit, static_cast<int32_t*>(dist),
      static_cast<int32_t>(level));
  return static_cast<int>(cudaGetLastError());
}
