// Fragment probes of the decoders, for Hopper (sm_90a): the counterparts of
// the JAX package's TPU probe scripts that time one fragment of K1/K2 each.
//
//   probe_winmach     scripts/pallas_winmach_chip.py:47   sequential code reads a lane
//   probe_relayout    scripts/pallas_composite_probe.py:49  (G) tile relayout round trip
//   probe_merge_trip  scripts/pallas_composite_probe.py:70  (H) the merge trip
//   probe_refill      scripts/pallas_composite_probe.py:117 (I) the word-queue refill
//   probe_compaction  scripts/pallas_composite_probe.py:158 (J) slab compaction
//   probe_page_fetch  scripts/pallas_composite_probe.py:213 (K) page fetch + transpose
//   probe_fetch       scripts/pallas_fetch_bench.py:31      pool gathers, summed
//   probe_row_gather  scripts/pallas_onehot_probe.py:30     one table row a block
//
// (scripts/pallas_probe.py's γ reads run on k0_probe, decode2.cu.)
//
// Each TPU probe works on one (8, 128) int32 tile of 1,024 lanes, lane
// l = 128 r + c.  It is computed here in Hopper's form, not carried over
// op by op: a one-hot matrix product (a gather or scatter on the MXU)
// becomes a load from global or shared memory; a roll network becomes the
// shifted index it computes; a reshape becomes a relayout through shared
// memory.  The composite probes (G-K) keep one block of 1,024 threads, a
// thread a lane, because their lanes share a tile; each runs one serial
// chain of trips a lane, so they are bound by latency, not by bytes or
// operations: the per-trip time is the fragment's cost, what they measure.
// The TPU's int32 arithmetic wraps; here it is done in uint32 (signed
// overflow is undefined in C++), with signed compares and arithmetic right
// shifts where the TPU kernel has them, and Python's floor modulo.
//
// Every C entry point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "pcodes.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 1024;        // lanes of an (8, 128) tile
constexpr int MAX_REFILL_PAGES = 1024;
constexpr int MAX_FETCH_PAGES = 64;
constexpr int FETCH_THREADS = 256;

__device__ __forceinline__ int floor_mod(int32_t a, int32_t m) {
  const int32_t r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int32_t wrap(uint32_t v) { return static_cast<int32_t>(v); }

// ---------------------------------------------------------------- B.1
// A thread a lane reads k codes in sequence from its start bit through
// wgt::BufReader, the reader of both parses: a 64-bit buffer in registers
// refilled a word at a time.  The TPU probe needed a sliding per-group word
// table, refills and stalls (win_reset / win_refill / win_consume); here a
// lane's next word is one cached global load.  out[j * lanes + l] is code j
// of lane l, -1 from the first code the reader refuses on.
__global__ void probe_winmach(const uint64_t* __restrict__ words, int64_t nbits,
                              const int64_t* __restrict__ starts, int lanes, int k,
                              int coding, int zeta_k, int32_t* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  wgt::BufReader rd;
  rd.init(words, nbits, starts[l]);
  for (int j = 0; j < k; ++j) {
    const int64_t v = rd.read(coding, zeta_k);
    out[static_cast<int64_t>(j) * lanes + l] = rd.err ? -1 : static_cast<int32_t>(v);
  }
}

// ---------------------------------------------------------------- G
// out = x + trips.  Each trip moves the tile (8, 128) -> (1, 1024) -> (8, 128)
// and adds 1.  Thread l holds element l of the tile form and element
// q(l) = 128 (l % 8) + l / 8 of the flat form, so each trip is two
// exchanges through shared memory (a transpose of ownership), a barrier
// each; one pad word every 32 keeps the transposed reads free of bank
// conflicts.
__device__ __forceinline__ int pad32(int e) { return e + (e >> 5); }

__global__ void __launch_bounds__(TILE)
    probe_relayout(const int32_t* __restrict__ x, int trips, int32_t* __restrict__ out) {
  __shared__ uint32_t a[TILE + TILE / 32], b[TILE + TILE / 32];
  const int l = threadIdx.x;
  const int q = (l & 7) * 128 + (l >> 3);
  uint32_t v = static_cast<uint32_t>(x[l]);
  for (int t = 0; t < trips; ++t) {
    a[pad32(l)] = v;
    __syncthreads();
    b[pad32(q)] = a[pad32(q)];
    __syncthreads();
    v = b[pad32(l)] + 1u;
  }
  out[l] = wrap(v);
}

// ---------------------------------------------------------------- H
// The merge trip: the recurrence on (v, rv, iv) a lane, two shifts of the
// lane's column of the word queue wq[0:8] (roll by 7 along the rows: row r
// takes row r + 1 mod 8, where emit is odd), and a row store of the emits
// to colbuf[t % 128] in global memory.  The queue is in shared memory,
// 32 KB, a lane's column conflict-free.  out = v + rv + iv + colbuf[0][l % 128]
// (lanes 0-127's emit at the last trip with t % 128 = 0); wq_out and colbuf
// hold the queue and the slab, which the TPU probe never read back.
__global__ void __launch_bounds__(TILE)
    probe_merge_trip(const int32_t* __restrict__ x, int trips, int32_t* __restrict__ out,
                     int32_t* __restrict__ wq_out, int32_t* __restrict__ colbuf) {
  __shared__ int32_t wq[8][TILE];
  const int l = threadIdx.x;
  const int32_t x0 = x[l];
#pragma unroll
  for (int r = 0; r < 8; ++r) wq[r][l] = x0;
  int32_t v = x0, rv = wrap(3u * static_cast<uint32_t>(x0)), iv = floor_mod(x0, 7);
  for (int t = 0; t < trips; ++t) {
    const int32_t hi = v ^ (rv >> 3);
    const int32_t lo = wrap(static_cast<uint32_t>(v) + static_cast<uint32_t>(iv));
    const int h = hi > 0 ? __clz(hi) : 32;
    const int32_t rest = wrap((static_cast<uint32_t>(lo) << (h & 31)) |
                              static_cast<uint32_t>(hi >> ((32 - h) & 31)));
    const int32_t val = wrap(static_cast<uint32_t>(rest & 0xFFFF) + static_cast<uint32_t>(rv));
    const bool take_c = val > rv;
    const bool take_i = !take_c && iv > 0;
    const int32_t emit = take_c ? val : (take_i ? iv : rv);
    rv = wrap(static_cast<uint32_t>(rv) + (take_c ? 1u : FULL));
    iv = take_i ? wrap(static_cast<uint32_t>(iv) - 1u)
                : wrap(static_cast<uint32_t>(iv) + static_cast<uint32_t>(floor_mod(emit, 3)));
    v = wrap((static_cast<uint32_t>(v) * 5u + static_cast<uint32_t>(emit)) & 0x7FFFFFFFu);
    if (emit & 1) {
      const int32_t first = wq[0][l];
#pragma unroll
      for (int r = 0; r < 7; ++r) wq[r][l] = wq[r + 1][l];
      wq[7][l] = first;
    }
    colbuf[(t & 127) * TILE + l] = emit;
  }
  __syncthreads();
  out[l] = wrap(static_cast<uint32_t>(v) + static_cast<uint32_t>(rv) + static_cast<uint32_t>(iv) +
                static_cast<uint32_t>(colbuf[l & 127]));
#pragma unroll
  for (int r = 0; r < 8; ++r) wq_out[r * TILE + l] = wq[r][l];
}

// ---------------------------------------------------------------- I
// The word-queue refill: page p = cur % p8 of (p8, 32) int32 pages, aligned
// by s = cur & 7, gives the word whose byte i is the low byte of
// pages[p][8 i + s] (the TPU's four int8 byte-plane products and its
// 3-stage roll network); cur = (cur + word) & 0x7FFFFFFF.  The low bytes of
// the pages are staged in shared memory, so a refill is four byte loads.
__global__ void __launch_bounds__(TILE)
    probe_refill(const int32_t* __restrict__ pages, int p8, const int32_t* __restrict__ x,
                 int reps, int32_t* __restrict__ out) {
  __shared__ uint8_t pb[MAX_REFILL_PAGES * 32];
  const int l = threadIdx.x;
  for (int i = l; i < p8 * 32; i += TILE) pb[i] = static_cast<uint8_t>(pages[i]);
  __syncthreads();
  uint32_t cur = static_cast<uint32_t>(x[l]);
  for (int t = 0; t < reps; ++t) {
    const uint8_t* row = pb + floor_mod(wrap(cur), p8) * 32 + (cur & 7u);
    const uint32_t w = row[0] | (row[8] << 8) | (row[16] << 16) |
                       (static_cast<uint32_t>(row[24]) << 24);
    cur = (cur + w) & 0x7FFFFFFFu;
  }
  out[l] = wrap(cur);
}

// ---------------------------------------------------------------- J
// Slab compaction.  Each rep t, lane l's row A[l][j] = colbuf[j][l] + carry[0]
// is rotated left by sh = pre & 127 (pre = (pre_in[l] + t) mod (128 r - 256)),
// split at the rotation, and added byte by byte, mod 256 with no carry between
// bytes (the TPU's int8 plane products masked with & 0xFF), into pool row
// pre >> 7 (columns j >= sh) and the row after it (j < sh); then
// carry += pool[0:8][0:128], lane for lane.  colbuf is held lane-major
// (colT[l][j], the slab the TPU transposes every rep), so a lane's row is one
// contiguous read.  No scatter: a warp sums each pool row it owns over the
// lanes that land there (a ballot over the lanes' rows in shared memory, then
// __vadd4, the byte-wise sum), so no atomics and no two writers.  pool holds
// the last rep's pool.
__global__ void __launch_bounds__(TILE)
    probe_compaction(const int32_t* __restrict__ x, const int32_t* __restrict__ pre_in, int r,
                     int reps, uint32_t* __restrict__ colT, uint32_t* __restrict__ pool,
                     int32_t* __restrict__ out) {
  __shared__ int32_t row0[TILE];
  __shared__ int32_t shift[TILE];
  __shared__ uint32_t c00;
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  for (int e = l; e < TILE * 128; e += TILE) colT[e] = static_cast<uint32_t>(x[e >> 7]);
  uint32_t carry = static_cast<uint32_t>(x[l]);
  if (l == 0) c00 = carry;
  const int mod = r * 128 - 256;
  __syncthreads();
  for (int t = 0; t < reps; ++t) {
    const int pre = floor_mod(wrap(static_cast<uint32_t>(pre_in[l]) + static_cast<uint32_t>(t)), mod);
    row0[l] = pre >> 7;
    shift[l] = pre & 127;
    const uint32_t cc = c00;
    __syncthreads();
    for (int row = warp; row < r; row += 32) {
      uint32_t acc[4] = {0u, 0u, 0u, 0u};
      for (int base = 0; base < TILE; base += 32) {
        const int rl = row0[base + lane];
        unsigned m = __ballot_sync(FULL, rl == row || rl + 1 == row);
        while (m) {
          const int src = base + __ffs(m) - 1;
          m &= m - 1;
          const int s = shift[src];
          const bool top = row0[src] == row;
          const uint32_t* a = colT + static_cast<int64_t>(src) * 128;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = lane + 32 * q;
            if (top == (j >= s)) acc[q] = __vadd4(acc[q], a[(j + s) & 127] + cc);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) pool[row * 128 + lane + 32 * q] = acc[q];
    }
    __syncthreads();
    carry += pool[l];
    if (l == 0) c00 = carry;
    __syncthreads();
  }
  out[l] = wrap(carry);
}

// ---------------------------------------------------------------- K
// Page fetch: each rep lane l fetches page row cur % np of (np, 128) pages
// into the (1024, 128) fetch, which the TPU transposes to (128, 1024) to read
// its row 0: cur = (cur + pages[cur % np][0]) & 0x7FFFFFFF.  The pages are
// staged in shared memory.  A warp fetches its 32 lanes' rows one after the
// other, each row read by all 32 threads (four words each, conflict-free);
// the transpose is the hand-over of column 0 through shared memory (thread
// 0 writes it, the row's lane reads it).  Every fetched word enters
// chk[32 w + t], the sum over reps and the warp's 32 rows of the words that
// thread t of warp w read (columns t, t + 32, t + 64, t + 96): a checksum of
// the whole fetch.
__global__ void __launch_bounds__(TILE)
    probe_page_fetch(const int32_t* __restrict__ pages, int np, const int32_t* __restrict__ x,
                     int reps, int32_t* __restrict__ out, int32_t* __restrict__ chk) {
  __shared__ uint32_t pg[MAX_FETCH_PAGES * 128];
  __shared__ uint32_t col0[TILE];
  const int l = threadIdx.x, lane = l & 31, base = l & ~31;
  for (int i = l; i < np * 128; i += TILE) pg[i] = static_cast<uint32_t>(pages[i]);
  __syncthreads();
  uint32_t cur = static_cast<uint32_t>(x[l]), sum = 0u;
  for (int t = 0; t < reps; ++t) {
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const uint32_t* row = pg + floor_mod(wrap(__shfl_sync(FULL, cur, i)), np) * 128;
      const uint32_t w0 = row[lane];
      sum += w0 + row[lane + 32] + row[lane + 64] + row[lane + 96];
      if (lane == 0) col0[base + i] = w0;
    }
    __syncwarp();
    cur = (cur + col0[l]) & 0x7FFFFFFFu;
    __syncwarp();
  }
  out[l] = wrap(cur);
  chk[l] = wrap(sum);
}

// ---------------------------------------------------------------- B.4
// Pool gathers: the sum over steps i < k, lanes and columns c < 16 of
// pool[p >> 7][((p & 127) + c) & 127], p = pos[lane] + i (a row outside the
// pool gives 0, as the one-hot product does).  A thread a (step, lane), its
// 16 words from the pool row (in L1/L2), a block sum, one atomic a block;
// wrapping int32 like the TPU's accumulator.
__global__ void __launch_bounds__(FETCH_THREADS)
    probe_fetch(const int32_t* __restrict__ pos, int lanes, const int32_t* __restrict__ pool,
                int rows, int k, int32_t* __restrict__ out) {
  __shared__ uint32_t part[FETCH_THREADS / 32];
  const int64_t g = static_cast<int64_t>(blockIdx.x) * FETCH_THREADS + threadIdx.x;
  uint32_t s = 0u;
  if (g < static_cast<int64_t>(lanes) * k) {
    const int lane = static_cast<int>(g % lanes), i = static_cast<int>(g / lanes);
    const int32_t p = wrap(static_cast<uint32_t>(pos[lane]) + static_cast<uint32_t>(i));
    const int32_t row = p >> 7;
    if (row >= 0 && row < rows) {
      const int32_t* a = pool + static_cast<int64_t>(row) * 128;
#pragma unroll
      for (int c = 0; c < 16; ++c) s += static_cast<uint32_t>(__ldg(a + (((p & 127) + c) & 127)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t b = 0u;
#pragma unroll
    for (int w = 0; w < FETCH_THREADS / 32; ++w) b += part[w];
    atomicAdd(reinterpret_cast<unsigned*>(out), b);
  }
}

// ---------------------------------------------------------------- B.5
// out[i][j] = T[(idx[i][0] >> 7) * 128 + (idx[i][j] & 127)]: the table row of
// output row i comes from its column 0 (the TPU probe's one-hot row
// product), the column from each index.  T is given as four int8 byte planes
// (r, 128), bytes 3, 2, 1, 0 of each word.  A block of 128 threads an output
// row stages the table row's words in shared memory, then each thread reads
// its column.  A row outside the table gives 0.
__global__ void __launch_bounds__(128)
    probe_row_gather(const int8_t* __restrict__ planes, int r, const int32_t* __restrict__ idx,
                     int32_t* __restrict__ out) {
  __shared__ uint32_t words[128];
  const int t = threadIdx.x;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * 128;
  const int32_t row = idx[at] >> 7;
  uint32_t w = 0u;
  if (row >= 0 && row < r) {
    const int64_t plane = static_cast<int64_t>(r) * 128, e = static_cast<int64_t>(row) * 128 + t;
    w = (static_cast<uint32_t>(static_cast<uint8_t>(planes[e])) << 24) |
        (static_cast<uint32_t>(static_cast<uint8_t>(planes[plane + e])) << 16) |
        (static_cast<uint32_t>(static_cast<uint8_t>(planes[2 * plane + e])) << 8) |
        static_cast<uint32_t>(static_cast<uint8_t>(planes[3 * plane + e]));
  }
  words[t] = w;
  __syncthreads();
  out[at + t] = wrap(words[idx[at + t] & 127]);
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" int wgt_probe_winmach(const void* words, int64_t nbits, const void* starts,
                                 int lanes, int k, int coding, int zeta_k, void* out,
                                 void* stream) {
  probe_winmach<<<(lanes + 127) / 128, 128, 0, as_stream(stream)>>>(
      static_cast<const uint64_t*>(words), nbits, static_cast<const int64_t*>(starts), lanes,
      k, coding, zeta_k, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_relayout(const void* x, int trips, void* out, void* stream) {
  probe_relayout<<<1, TILE, 0, as_stream(stream)>>>(static_cast<const int32_t*>(x), trips,
                                                     static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_merge_trip(const void* x, int trips, void* out, void* wq,
                                    void* colbuf, void* stream) {
  probe_merge_trip<<<1, TILE, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), trips, static_cast<int32_t*>(out),
      static_cast<int32_t*>(wq), static_cast<int32_t*>(colbuf));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_refill(const void* pages, int p8, const void* x, int reps, void* out,
                                void* stream) {
  if (p8 < 1 || p8 > MAX_REFILL_PAGES) return static_cast<int>(cudaErrorInvalidValue);
  probe_refill<<<1, TILE, 0, as_stream(stream)>>>(static_cast<const int32_t*>(pages), p8,
                                                   static_cast<const int32_t*>(x), reps,
                                                   static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_compaction(const void* x, const void* pre, int r, int reps,
                                    void* colT, void* pool, void* out, void* stream) {
  if (r < 8) return static_cast<int>(cudaErrorInvalidValue);  // carry reads pool rows 0-7
  probe_compaction<<<1, TILE, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(pre), r, reps,
      static_cast<uint32_t*>(colT), static_cast<uint32_t*>(pool), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_page_fetch(const void* pages, int np, const void* x, int reps,
                                    void* out, void* chk, void* stream) {
  if (np < 1 || np > MAX_FETCH_PAGES) return static_cast<int>(cudaErrorInvalidValue);
  probe_page_fetch<<<1, TILE, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(pages), np, static_cast<const int32_t*>(x), reps,
      static_cast<int32_t*>(out), static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_fetch(const void* pos, int lanes, const void* pool, int rows, int k,
                               void* out, void* stream) {
  const int64_t n = static_cast<int64_t>(lanes) * k;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  probe_fetch<<<static_cast<unsigned>((n + FETCH_THREADS - 1) / FETCH_THREADS), FETCH_THREADS,
                0, as_stream(stream)>>>(static_cast<const int32_t*>(pos), lanes,
                                        static_cast<const int32_t*>(pool), rows, k,
                                        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_row_gather(const void* planes, int r, const void* idx, int n,
                                    void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  probe_row_gather<<<n, 128, 0, as_stream(stream)>>>(static_cast<const int8_t*>(planes), r,
                                                      static_cast<const int32_t*>(idx),
                                                      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
