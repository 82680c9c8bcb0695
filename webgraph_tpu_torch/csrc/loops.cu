// In-loop primitive probes, for Hopper (sm_90a): the counterparts of the JAX
// package's TPU timing scripts scripts/pallas_timing5.py, pallas_bisect4.py,
// pallas_bisect3.py and pallas_perf_probe.py.  Each TPU probe runs one
// primitive in a fori_loop over an (8, 128) int32 carry of 1,024 lanes
// (lane l = 128 r + c); eight kernels cover their eight families:
//
//   probe_lane_loop       the (v, rv) trip recurrence a lane, with the queue roll,
//                         slab row store and relayout of the merge trip; the VPU
//                         baseline; the row store
//                           timing5.trip_core :56, bisect3.trip_variant :38,
//                           bisect3.trip_1x1024 :82, perf.probe_vpu :207,
//                           perf.probe_rowstore :157
//   probe_gather_loop     a whole take_along_axis a trip
//                           timing5.gather_loop :99, bisect3.gather_inloop_timed :110,
//                           perf.probe_replicated :61, perf.probe_ownrow :128,
//                           bisect2.gather_in_loop :93
//   probe_dot_loop        an int8 product a rep: prebaked on the tensor cores
//                         (mma.sync m16n8k32), or against a one-hot matrix
//                           timing5.matmul_loop :125, bisect4.matmul_inloop :38
//   probe_plane_refill    byte-plane word refill and byte-plane row gather
//                           bisect3.refill_variant :134, perf.probe_onehot :89
//   probe_transpose_loop  a whole (T, 1024) -> (1024, T) transpose a rep
//                           timing5.transpose_loop :158, bisect4.transpose_inloop :69,
//                           perf.probe_transpose :184, bisect2.transpose_in_loop :72
//   probe_copy_loop       an (8, 1024) slice copied into shared memory a rep by a
//                         TMA bulk copy completing on an mbarrier
//                           timing5.dma_loop :178, bisect4.dma_inloop :87
//   probe_stack_fetch     a word from a lane's 128-row column stack
//                           bisect3.stack_select_refill :193
//   probe_jframe          prefixes of the slab compaction (composite J)
//                           bisect3.j_part :232, bisect4.j_frame :110
//
// and three more for the streaming decoder's primitives of scripts/v6_probe.py
// and v6_probe2.py:
//
//   probe_v6_trip         the state machine's trip: 8 sub-steps of a queue
//                         row select, window shift, merge selects, ab append
//                           v6.probe_trip :71
//   probe_v6_fetch        a one-hot stream fetch of 8 groups and a 32-chunk
//                         slab gather, summed (one call of fn200's body)
//                           v6.probe_fetch :140
//   probe_body_loop       the fetch body's primitives a rep (bodies A-F, D2)
//                           v6_probe2.run_loop :17, bodies :72-155
//
// Every kernel is one block of 1,024 threads, a thread a lane, on one SM, as
// csrc/probes.cu's composite probes are, so that a per-trip cost compares with
// theirs: a serial chain of trips bound by latency and issue, not by bytes.
// What the TPU computes through one-hot products and roll networks is
// computed here in its closed form (a load at the index the product or the
// roll selects); the plain versions in probes/loops.py keep the scripts'
// steps.  No work is dead: besides the script's (8, 128) output each kernel
// returns a checksum (wrapping sum) of every element its TPU body computes
// each rep, or the buffers it fills.  Tables larger than shared memory are
// staged as far as they fit (the first words of the flat table); the rest is
// read through L2.  int32 arithmetic wraps, done in uint32 with signed
// compares and floor modulo where the scripts have them.
//
// Every C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments its kernel does not take.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 1024;              // lanes of an (8, 128) tile
constexpr int STAGE_WORDS = 56 * 1024;  // table words staged in shared memory
constexpr int DOT_SMEM = 200 * 1024;    // bytes of b the product loop stages
constexpr int TR_SMEM = 32 * 32 * 33 * 4;  // a 32 x 33 tile a warp
constexpr int STACK_STRIDE = 136;       // bytes a lane's column of the stack
constexpr int STACK_SMEM = TILE * STACK_STRIDE;
constexpr int COPY_ROWS = 8;            // rows of the copied slice
constexpr int JR = 128;                 // pool rows of the compaction frame
constexpr int JMOD = JR * 128 - 256;

__device__ __forceinline__ int floor_mod(int32_t a, int32_t m) {
  const int32_t r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int32_t wrap(uint32_t v) { return static_cast<int32_t>(v); }

__device__ __forceinline__ int pad32(int e) { return e + (e >> 5); }

// Word e of a flat table whose first nstage words are staged in st.
__device__ __forceinline__ uint32_t staged(const uint32_t* st, const int32_t* __restrict__ g,
                                           int nstage, int e) {
  return e < nstage ? st[e] : static_cast<uint32_t>(__ldg(g + e));
}

// ---------------------------------------------------------------- lane loop
// flags of probe_lane_loop (probes/loops.py has the same values)
enum : int {
  LL_RESHAPE = 1,      // v += the tile relayout (8, 128) -> (1, 1024) -> (8, 128) of v
  LL_QUEUE_HALF = 2,   // the queue rolls in columns < 512 every trip (timing5 TX)
  LL_QUEUE_ODD = 4,    // the queue rolls in every column on odd trips (bisect3)
  LL_STORE_V = 8,      // colbuf[t % slab] = v
  LL_STORE_T = 16,     // colbuf[t % slab] = t
  LL_OUT_SLAB = 32,    // out adds colbuf[0][c]
  LL_VPU = 64,         // perf F's recurrence in place of (v, rv)
  LL_ROWSTORE = 128,   // perf D: colbuf[t % slab] = v, then v += 1
};

// A trip: `rounds` rounds of the recurrence in registers, then the flagged
// extras.  The relayout is two exchanges through shared memory, as
// probe_relayout's; the queue wq (8, 1024) is in shared memory, a lane's
// column its own (the roll by 7 along the rows: row r takes row r + 1 mod 8),
// and lane (r, c) then reads column c's row 0, another thread's, so a barrier
// comes before and after that read.  The slab is global memory, filled by the
// wrapper (unwritten rows keep what it holds).  out = v (+ rv) (+ colbuf[0][c]);
// wq_out gets the queue.
__global__ void __launch_bounds__(TILE)
    probe_lane_loop(const int32_t* __restrict__ x, int flags, int rounds, int trips, int slab,
                    int32_t* __restrict__ out, int32_t* __restrict__ wq_out,
                    int32_t* __restrict__ colbuf) {
  __shared__ uint32_t a[TILE + TILE / 32], b[TILE + TILE / 32];
  __shared__ uint32_t wq[8][TILE];
  const int l = threadIdx.x, c = l & 127;
  const int q = (l & 7) * 128 + (l >> 3);
  const bool queue = flags & (LL_QUEUE_HALF | LL_QUEUE_ODD);
  uint32_t v = static_cast<uint32_t>(x[l]), rv = 3u * v;
#pragma unroll
  for (int r = 0; r < 8; ++r) wq[r][l] = v;
  __syncthreads();
  for (int t = 0; t < trips; ++t) {
    if (flags & LL_VPU) {
      for (int i = 0; i < rounds; ++i) {
        v = (v * 3u + 1u) & 0x7FFFFFFFu;
        v ^= v >> 5;
        v += static_cast<uint32_t>(t);
        if (wrap(v) > 100) v -= 7u;
      }
    } else if (flags & LL_ROWSTORE) {
      colbuf[(t % slab) * TILE + l] = wrap(v);
      v += 1u;
    } else {
#pragma unroll 4
      for (int i = 0; i < rounds; ++i) {
        v = (v * 5u + rv) & 0x7FFFFFFFu;
        v ^= v >> 7;
        if (wrap(v) > wrap(rv)) rv += 1u;
        rv += v & 3u;
      }
    }
    if (flags & LL_RESHAPE) {
      a[pad32(l)] = v;
      __syncthreads();
      b[pad32(q)] = a[pad32(q)];
      __syncthreads();
      v += b[pad32(l)];
    }
    if (queue) {
      if ((flags & LL_QUEUE_HALF) ? l < 512 : (t & 1)) {
        const uint32_t first = wq[0][l];
#pragma unroll
        for (int r = 0; r < 7; ++r) wq[r][l] = wq[r + 1][l];
        wq[7][l] = first;
      }
      __syncthreads();
      v += wq[0][c];
      __syncthreads();
    }
    if (flags & LL_STORE_V) {
      colbuf[(t % slab) * TILE + l] = wrap(v);
    } else if (flags & LL_STORE_T) {
      colbuf[(t % slab) * TILE + l] = t;
    }
  }
  __syncthreads();
  uint32_t o = v;
  if (!(flags & (LL_VPU | LL_ROWSTORE))) o += rv;
  if (flags & LL_OUT_SLAB) o += static_cast<uint32_t>(colbuf[c]);
  out[l] = wrap(o);
#pragma unroll
  for (int r = 0; r < 8; ++r) wq_out[r * TILE + l] = wrap(wq[r][l]);
}

// ---------------------------------------------------------------- gather loop
// floor_mod(wrap(j + k), m) for 0 <= j < m: one modulo for every j, and a
// compare a j, where j + k cannot overflow int32 (then it equals
// (j + k mod m) mod m); a modulo a j where it can.
struct Rot {
  int32_t k, m, base;
  bool exact;
  __device__ __forceinline__ Rot(uint32_t key, int m_)
      : k(wrap(key)), m(m_), base(floor_mod(wrap(key), m_)), exact(wrap(key) <= 0x7FFFFFFF - m_) {}
  __device__ __forceinline__ int at(int j) const {
    if (!exact) return floor_mod(wrap(static_cast<uint32_t>(j) + static_cast<uint32_t>(k)), m);
    const int e = j + base;
    return e >= m ? e - m : e;
  }
};

enum : int {
  GL_ROWS = 0,  // (N, 128), idx[n][c] = (c + carry[0][c]) & 127, carry & 0xFFFF (G)
  GL_REPL = 1,  // (8, W), idx[r][w] = (w + carry[r][0]) % W, carry & 0x7FFFFFFF (A)
  GL_OWN = 2,   // (1024, T), idx[n][t] = (t + carry[n]) % T, carry & 0x7FFFFFFF (C)
  GL_COL = 3,   // (N, 128), idx[n][c] = carry[0][c] % 128, carry & 0xFFFF (bisect2)
};

// A trip gathers the whole (rows, cols) take_along_axis of the table; the
// lane's own element of the script's slice feeds its carry, and every
// gathered word its checksum.  G: lane (r, c) gathers rows r, r + 8, ... of
// column c, its index from lane (0, c) through shared memory (GL_COL the
// same without the + c).  A: lane (r, c)
// gathers columns c, c + 128, ... of row r, its index from lane (r, 0).  C: a
// warp gathers its 32 lanes' rows one after the other, each row by all 32
// threads (coalesced); the row's word 0 goes back to its lane by a shuffle.
__global__ void __launch_bounds__(TILE)
    probe_gather_loop(const int32_t* __restrict__ tbl, int rows, int cols, int mode,
                      const int32_t* __restrict__ carry0, int reps, int nstage,
                      int32_t* __restrict__ out, int32_t* __restrict__ chk) {
  extern __shared__ uint32_t st[];
  __shared__ uint32_t key[128];
  const int l = threadIdx.x, lane = l & 31, r = l >> 7, c = l & 127;
  for (int e = l; e < nstage; e += TILE) st[e] = static_cast<uint32_t>(tbl[e]);
  uint32_t carry = static_cast<uint32_t>(carry0[l]), sum = 0u;
  __syncthreads();
  if (mode == GL_OWN) {
    const int base = l & ~31;
    for (int t = 0; t < reps; ++t) {
      uint32_t val = 0u;
      for (int i = 0; i < 32; ++i) {
        const uint32_t k = __shfl_sync(FULL, carry, i);
        const int row = (base + i) * cols;
        const Rot rot(k, cols);
        uint32_t first = 0u;
#pragma unroll 4
        for (int j = lane; j < cols; j += 32) {
          const uint32_t w = staged(st, tbl, nstage, row + rot.at(j));
          sum += w;
          if (j == lane) first = w;
        }
        const uint32_t v0 = __shfl_sync(FULL, first, 0);
        if (lane == i) val = v0;
      }
      carry = (carry + val) & 0x7FFFFFFFu;
    }
  } else {
    for (int t = 0; t < reps; ++t) {
      const bool by_col = mode == GL_ROWS || mode == GL_COL;
      if (by_col ? r == 0 : c == 0) key[by_col ? c : r] = carry;
      __syncthreads();
      uint32_t val = 0u;
      if (by_col) {  // & 127 is the floor modulo 128 of an int32
        const uint32_t k = mode == GL_ROWS ? static_cast<uint32_t>(c) + key[c] : key[c];
        const int col = static_cast<int>(k & 127u);
#pragma unroll 8
        for (int n = r; n < rows; n += 8) {
          const uint32_t w = staged(st, tbl, nstage, n * 128 + col);
          sum += w;
          if (n == r) val = w;
        }
        carry = (carry + val) & 0xFFFFu;
      } else {
        const Rot rot(key[r], cols);
#pragma unroll 4
        for (int w_ = c; w_ < cols; w_ += 128) {
          const uint32_t w = staged(st, tbl, nstage, r * cols + rot.at(w_));
          sum += w;
          if (w_ == c) val = w;
        }
        carry = (carry + val) & 0x7FFFFFFFu;
      }
      __syncthreads();
    }
  }
  out[l] = wrap(carry);
  chk[l] = wrap(sum);
}

// ---------------------------------------------------------------- product loop
__device__ __forceinline__ void mma_s8(uint32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ldg32(const int8_t* p) {
  return static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(p)));
}

// carry (8, 128) starts at 1; each rep carry = (carry + out[:8, :128]) & 0x7FFF.
// Prebaked (onehot 0): out = a (m, k) x b (k, n), int8 in, int32 sums, the
// whole product every rep on the tensor cores: b is staged transposed in
// shared memory (rows padded by 16 bytes, so a fragment's eight rows fall in
// distinct banks), a's fragments come from L2; a warp takes (16-row, 32-column)
// units of the output in turn, four m16n8k32 products a 32-deep step.  Every
// sum enters the checksum xor the rep index, so no rep's product is the
// last's; chk[0] is the block's wrapping sum.  One-hot (onehot 1): out = the
// one-hot matrix of carry % k (k, 1024) contracted with b: row l of out is row
// carry_l % k of b, the rows of lanes 0-7 feed the carry; chk[l] sums the
// lane's whole row each rep (__dp4a over its bytes).
__global__ void __launch_bounds__(TILE)
    probe_dot_loop(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int m, int k,
                   int n, int onehot, int reps, int32_t* __restrict__ out,
                   int32_t* __restrict__ chk) {
  extern __shared__ __align__(16) uint8_t sb[];
  __shared__ uint32_t s_carry[TILE];
  __shared__ uint32_t part[32];
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  if (onehot) {
    for (int e = l; e < k * n; e += TILE) sb[e] = static_cast<uint8_t>(b[e]);
    const int r = l >> 7, c = l & 127;
    uint32_t carry = 1u, sum = 0u;
    __syncthreads();
    for (int t = 0; t < reps; ++t) {
      if (l < 8) s_carry[l] = carry;
      __syncthreads();
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(sb + floor_mod(wrap(carry), k) * n);
      int rs = 0;  // lane i starts at word i: the warp's 32 rows in distinct banks
      for (int j = 0, nw = n / 4; j < nw; ++j) {
        const int jj = j + lane < nw ? j + lane : j + lane - nw;
        rs = __dp4a(static_cast<int>(row[jj]), 0x01010101, rs);
      }
      sum += static_cast<uint32_t>(rs);
      const int kr = floor_mod(wrap(s_carry[r]), k);
      carry = (carry + static_cast<uint32_t>(static_cast<int8_t>(sb[kr * n + c]))) & 0x7FFFu;
      __syncthreads();
    }
    out[l] = wrap(carry);
    chk[l] = wrap(sum);
    return;
  }
  const int ks = k + 16, g = lane >> 2, tq = lane & 3;
  for (int e = l; e < k * n; e += TILE) sb[(e % n) * ks + e / n] = static_cast<uint8_t>(b[e]);
  s_carry[l] = 1u;
  __syncthreads();
  const int ncs = n / 32, units = (m / 16) * ncs;
  uint32_t sum = 0u;
  for (int t = 0; t < reps; ++t) {
    for (int u = warp; u < units; u += 32) {
      const int m0 = (u / ncs) * 16, n0 = (u % ncs) * 32;
      uint32_t acc[4][4] = {};
      for (int k0 = 0; k0 < k; k0 += 32) {
        const int8_t* ar = a + (m0 + g) * k + k0 + 4 * tq;
        const uint32_t a0 = ldg32(ar), a1 = ldg32(ar + 8 * k), a2 = ldg32(ar + 16),
                       a3 = ldg32(ar + 8 * k + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint8_t* br = sb + (n0 + 8 * j + g) * ks + k0 + 4 * tq;
          mma_s8(acc[j], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(br),
                 *reinterpret_cast<const uint32_t*>(br + 16));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sum += acc[j][i] ^ static_cast<uint32_t>(t);
        const int col = n0 + 8 * j + 2 * tq;
        if (m0 == 0 && col < 128) {  // rows g < 8 of the first row tile: the carry's
          s_carry[g * 128 + col] = (s_carry[g * 128 + col] + acc[j][0]) & 0x7FFFu;
          s_carry[g * 128 + col + 1] = (s_carry[g * 128 + col + 1] + acc[j][1]) & 0x7FFFu;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  out[l] = wrap(s_carry[l]);
  if (l == 0) {
    uint32_t s = 0u;
#pragma unroll
    for (int w = 0; w < 32; ++w) s += part[w];
    chk[0] = wrap(s);
  }
}

// ---------------------------------------------------------------- byte-plane refill
enum : int {
  PR_REFILL = 0,  // (P8, 32) pages: word j = bytes 8 i + j of row cur % P8 (R1-R4)
  PR_ROWS = 1,    // (R, 128) table: row carry of the table, carry = (carry + row[0]) % R (B)
};

// Refill: the low bytes of the pages are staged in shared memory; a lane's
// refill reads the (8, 1,024) plane-product result of its page row, eight
// words of four bytes each, whose word 0 advances its cursor, all eight its
// checksum.  Rows: a warp fetches its 32 lanes' table rows in turn, 128
// words each, all 32 threads a row (four words each); a row outside the table
// is zeros, as the one-hot product gives.
__global__ void __launch_bounds__(TILE)
    probe_plane_refill(const int32_t* __restrict__ pages, int rows, int mode,
                       const int32_t* __restrict__ carry0, int reps, int nstage,
                       int32_t* __restrict__ out, int32_t* __restrict__ chk) {
  extern __shared__ uint32_t st[];
  const int l = threadIdx.x, lane = l & 31;
  uint32_t cur = static_cast<uint32_t>(carry0[l]), sum = 0u;
  if (mode == PR_REFILL) {
    uint8_t* pb = reinterpret_cast<uint8_t*>(st);
    for (int e = l; e < rows * 32; e += TILE) pb[e] = static_cast<uint8_t>(pages[e]);
    __syncthreads();
    for (int t = 0; t < reps; ++t) {
      const uint8_t* row = pb + floor_mod(wrap(cur), rows) * 32;
      uint32_t w0 = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t w = row[j] | (row[8 + j] << 8) | (row[16 + j] << 16) |
                           (static_cast<uint32_t>(row[24 + j]) << 24);
        sum += w;
        if (j == 0) w0 = w;
      }
      cur = (cur + w0) & 0x7FFFFFFFu;
    }
  } else {
    for (int e = l; e < nstage; e += TILE) st[e] = static_cast<uint32_t>(pages[e]);
    __syncthreads();
    for (int t = 0; t < reps; ++t) {
      uint32_t val = 0u;
      for (int i = 0; i < 32; ++i) {
        const int32_t k = wrap(__shfl_sync(FULL, cur, i));
        uint32_t first = 0u;
        if (k >= 0 && k < rows) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t w = staged(st, pages, nstage, k * 128 + lane + 32 * q);
            sum += w;
            if (q == 0) first = w;
          }
        }
        const uint32_t v0 = __shfl_sync(FULL, first, 0);
        if (lane == i) val = v0;
      }
      cur = static_cast<uint32_t>(floor_mod(wrap(cur + val), rows));
    }
  }
  out[l] = wrap(cur);
  chk[l] = wrap(sum);
}

// ---------------------------------------------------------------- transpose loop
enum : int {
  TL_MASK = 0,    // carry = (carry + xt[r][c] + t) & 0x7FFF (timing5, bisect4)
  TL_ADDC = 1,    // xt = x.T + carry[0][0], carry += xt[r][c] (perf E)
  TL_NOMASK = 2,  // carry = carry + xt[r][c] + t (bisect2)
};

// Each rep the whole x (T, 1024) -> xt (1024, T) (+ carry[0][0] with
// TL_ADDC), in 32 x 32 tiles through shared memory (a 32 x 33 tile a warp:
// conflict-free both ways), rows read and written 128 bytes a warp; warp w
// takes the tiles of x's columns 32 w .. 32 w + 31.  Then lane (r, c) reads
// xt[r][c] back into its carry as addc says.  chk sums every word a thread
// wrote.
__global__ void __launch_bounds__(TILE)
    probe_transpose_loop(const int32_t* __restrict__ x, int t_rows, int addc, int reps,
                         uint32_t* __restrict__ xt, int32_t* __restrict__ out,
                         int32_t* __restrict__ chk) {
  extern __shared__ uint32_t tiles[];
  __shared__ uint32_t s_c00;
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  uint32_t* tile = tiles + warp * 32 * 33;
  uint32_t carry = 0u, sum = 0u;
  if (l == 0) s_c00 = 0u;
  __syncthreads();
  const int ntiles = (t_rows / 32) * 32;
  for (int t = 0; t < reps; ++t) {
    const uint32_t cc = addc == TL_ADDC ? s_c00 : 0u;
    for (int u = warp; u < ntiles; u += 32) {
      const int ti = u >> 5, tj = u & 31;
      const int32_t* src = x + (ti * 32) * TILE + tj * 32 + lane;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) tile[i * 33 + lane] = static_cast<uint32_t>(src[i * TILE]);
      __syncwarp();
      uint32_t* dst = xt + (tj * 32) * t_rows + ti * 32 + lane;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const uint32_t v = tile[lane * 33 + i] + cc;
        dst[i * t_rows] = v;
        sum += v;
      }
      __syncwarp();
    }
    __syncthreads();
    const uint32_t corner = xt[(l >> 7) * t_rows + (l & 127)];
    if (addc == TL_ADDC) {
      carry += corner;
      if (l == 0) s_c00 = carry;
    } else {
      carry += corner + static_cast<uint32_t>(t);
      if (addc == TL_MASK) carry &= 0x7FFFu;
    }
    __syncthreads();
  }
  out[l] = wrap(carry);
  chk[l] = wrap(sum);
}

// ---------------------------------------------------------------- copy loop
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0u;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Each rep, rows (t % 32) * 8 .. + 8 of x (rows, 1024), 32 KB, are copied into
// the shared buffer by one TMA bulk copy that thread 0 issues and that
// completes on an mbarrier (the counterpart of make_async_copy + its DMA
// semaphore); every thread waits on the barrier's phase t & 1, then lane
// (r, c) reads buf[r][c] into its carry and its column of the whole buffer
// into its checksum.  A block barrier and a proxy fence order the reads
// before the next copy overwrites the buffer.
__global__ void __launch_bounds__(TILE)
    probe_copy_loop(const int32_t* __restrict__ x, int reps, int32_t* __restrict__ out,
                    int32_t* __restrict__ chk) {
  __shared__ __align__(128) uint32_t buf[COPY_ROWS * TILE];
  __shared__ __align__(8) uint64_t bar;
  const int l = threadIdx.x;
  const uint32_t sbuf = smem_addr(buf), sbar = smem_addr(&bar);
  constexpr uint32_t bytes = COPY_ROWS * TILE * 4;
  if (l == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t carry = 0u, sum = 0u;
  for (int t = 0; t < reps; ++t) {
    if (l == 0) {
      const int32_t* src = x + (t & 31) * COPY_ROWS * TILE;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sbar),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(sbuf),
          "l"(src), "r"(bytes), "r"(sbar)
          : "memory");
    }
    mbar_wait(sbar, static_cast<uint32_t>(t & 1));
#pragma unroll
    for (int j = 0; j < COPY_ROWS; ++j) sum += buf[j * TILE + l];
    carry = (carry + buf[(l >> 7) * TILE + (l & 127)]) & 0x7FFFu;
    __syncthreads();
  }
  out[l] = wrap(carry);
  chk[l] = wrap(sum);
}

// ---------------------------------------------------------------- stack fetch
// The stack (128, 1024) holds row k's index k in every column, a column a
// lane; its values are 0-127, so a byte a word keeps it exact and all of it
// (136 KB with an 8-byte pad a column, against bank conflicts) fits in shared
// memory.  A fetch of word k = carry: the 16-way select of row group k >> 3
// is one 8-byte load of the lane's group, the 3-stage roll by k & 7 the byte
// it picks; chk sums the group's eight words (the TPU's (8, 1024) select).
__global__ void __launch_bounds__(TILE)
    probe_stack_fetch(const int32_t* __restrict__ x, int reps, int32_t* __restrict__ out,
                      int32_t* __restrict__ chk) {
  extern __shared__ __align__(16) uint8_t stk[];
  const int l = threadIdx.x;
  for (int e = l; e < TILE * 128; e += TILE)
    stk[(e >> 7) * STACK_STRIDE + (e & 127)] = static_cast<uint8_t>(e & 127);
  __syncthreads();
  const uint8_t* col = stk + l * STACK_STRIDE;
  uint32_t k = static_cast<uint32_t>(x[l]) & 127u, sum = 0u;
  for (int t = 0; t < reps; ++t) {
    const uint2 grp = *reinterpret_cast<const uint2*>(col + (k >> 3) * 8);
    const uint32_t w0 = ((k & 4u) ? grp.y : grp.x) >> (8u * (k & 3u)) & 0xFFu;
    sum += __dp4a(grp.x, 0x01010101u, __dp4a(grp.y, 0x01010101u, 0u));
    k = (k + (w0 & 3u) + 1u) & 127u;
  }
  out[l] = wrap(k);
  chk[l] = wrap(sum);
}

// ---------------------------------------------------------------- compaction frame
// stages of probe_jframe (probes/loops.py has the same values)
enum : int {
  JF_V0 = 0,  // out = x
  JF_V1 = 1,  // out = colbuf[0:8, 0:128]
  JF_V2 = 2,  // out = colbuf.T[:8, :128]
  JF_V3 = 3,  // out = (colbuf.T + carry[0][0])[:8, :128]
  JF_V4 = 4,  // out = (pre + t) % (128 R - 256)
  JF_P0 = 5,  // A = colbuf.T + carry[0][0]
  JF_P1 = 6,  // B = A rolled left by pre & 127 a row
  JF_P2 = 7,  // B0 = B where column >= pre & 127, else 0
  JF_P3 = 8,  // part0 = one-hot(pre >> 7) x int8(B0 & 0xFF), (R, 128)
};

// The slab colbuf (128, 1024) = x broadcast is held lane-major, colT[l][j],
// so a lane's row of A is one contiguous read.  Each rep carry += out, where
// out[r][c] is element (r, c) of the stage's array; lane l's checksum sums
// its row of A, B or B0 (the stage's whole (1024, 128) array).  Stage 8's
// product is the scatter of each lane's sign-extended low bytes into pool
// row pre >> 7, a warp a pool row summing the lanes a ballot finds there (as
// probe_compaction's), int32 sums, no mask; pool keeps the last rep's.
__global__ void __launch_bounds__(TILE)
    probe_jframe(const int32_t* __restrict__ x, const int32_t* __restrict__ pre_in, int stage,
                 int reps, uint32_t* __restrict__ colT, int32_t* __restrict__ pool,
                 int32_t* __restrict__ out, int32_t* __restrict__ chk) {
  __shared__ int32_t row0[TILE];
  __shared__ int32_t shift[TILE];
  __shared__ uint32_t s_c00;
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5, r = l >> 7, c = l & 127;
  if (stage != JF_V0 && stage != JF_V4) {
    for (int e = l; e < TILE * 128; e += TILE) colT[e] = static_cast<uint32_t>(x[e >> 7]);
  }
  const uint32_t x_l = static_cast<uint32_t>(x[l]);
  const int32_t pre_l = pre_in[l], pre_r = pre_in[r];
  uint32_t carry = x_l, sum = 0u;
  if (l == 0) s_c00 = carry;
  __syncthreads();
  const uint32_t* mine = colT + l * 128;
  const uint32_t* lane_r = colT + r * 128;
  for (int t = 0; t < reps; ++t) {
    const uint32_t cc = (stage == JF_V3 || stage >= JF_P0) ? s_c00 : 0u;
    const int p_l = floor_mod(wrap(static_cast<uint32_t>(pre_l) + t), JMOD);
    const int p_r = floor_mod(wrap(static_cast<uint32_t>(pre_r) + t), JMOD);
    const int sh_l = p_l & 127, sh_r = p_r & 127;
    uint32_t o = 0u;
    if (stage == JF_V0) {
      o = x_l;
    } else if (stage == JF_V1) {
      o = colT[c * 128 + r];
    } else if (stage == JF_V4) {
      o = static_cast<uint32_t>(p_l);
    } else if (stage <= JF_P0) {  // V2, V3, P0
      o = lane_r[c] + cc;
      for (int j = 0; j < 128; ++j) sum += mine[j] + cc;
    } else {  // P1, P2, P3
      const int lo = stage == JF_P1 ? 0 : sh_l;
      for (int j = lo; j < 128; ++j) sum += mine[(j + sh_l) & 127] + cc;
      if (stage == JF_P1 || c >= sh_r) o = lane_r[(c + sh_r) & 127] + cc;
      if (stage == JF_P3) {
        row0[l] = p_l >> 7;
        shift[l] = sh_l;
        __syncthreads();
        for (int row = warp; row < JR; row += 32) {
          int32_t acc[4] = {0, 0, 0, 0};
          for (int base = 0; base < TILE; base += 32) {
            unsigned m = __ballot_sync(FULL, row0[base + lane] == row);
            while (m) {
              const int src = base + __ffs(m) - 1;
              m &= m - 1;
              const int s = shift[src];
              const uint32_t* a = colT + src * 128;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int j = lane + 32 * q;
                if (j >= s) acc[q] += static_cast<int8_t>(a[(j + s) & 127] + cc);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) pool[row * 128 + lane + 32 * q] = acc[q];
        }
        __syncthreads();
        o = static_cast<uint32_t>(pool[r * 128 + c]);
      }
    }
    __syncthreads();
    carry += o;
    if (l == 0) s_c00 = carry;
    __syncthreads();
  }
  out[l] = wrap(carry);
  chk[l] = wrap(sum);
}

// ---------------------------------------------------------------- v6 trip
constexpr int V6_QD = 32;  // queue rows of the trip
constexpr int V6_U = 8;    // sub-steps a trip
constexpr int V6_SMEM = V6_QD * TILE * 4;

// Each lane's state (acc, cur, w0, w1, ap, ab0-ab3) in registers; the queue
// (32, 1,024) in shared memory, so sel_row of row cur & 31 is one conflict-free
// load of the lane's column.  The window shift w1 >> (32 - sh) is guarded at
// sh == 0, a shift by 32 (XLA gives 0; C++ leaves it undefined); the even
// sub-steps update w0 and w1 (u % 2 == 0 is static).  out[0] is the wrapping
// sum of acc over the lanes (the script's output); state gets ab0-ab3, w0, w1,
// which the script never reads.
__global__ void __launch_bounds__(TILE)
    probe_v6_trip(const int32_t* __restrict__ w, const int32_t* __restrict__ salt, int trips,
                  int32_t* __restrict__ out, int32_t* __restrict__ state) {
  extern __shared__ uint32_t q[];
  __shared__ uint32_t part[32];
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  for (int e = l; e < V6_QD * TILE; e += TILE) q[e] = static_cast<uint32_t>(w[e]);
  __syncthreads();
  uint32_t acc = static_cast<uint32_t>(salt[0]), cur = 0u, w0 = 0u, w1 = 0u, ap = 0u;
  uint32_t ab0 = 0u, ab1 = 0u, ab2 = 0u, ab3 = 0u;
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int u = 0; u < V6_U; ++u) {
      const uint32_t wv = q[(cur & (V6_QD - 1)) * TILE + l];
      const uint32_t sh = cur & 31u;
      const uint32_t hi = (w0 << sh) | (sh > 0u ? w1 >> (32u - sh) : 0u);
      const int32_t v = static_cast<int32_t>(hi >> 24);
      const int32_t ln = (v & 7) + 1;
      if (u % 2 == 0) {
        w0 = hi;
        w1 ^= wv;
      }
      const int32_t eh = wrap(acc) & 255, ih = wrap(cur) & 255;
      const int32_t emit = min(min(v, eh), ih);
      cur += (v <= eh && v <= ih) ? 1u : 2u;
      const uint32_t slot = ap & 3u, em = static_cast<uint32_t>(emit);
      ab0 = slot == 0u ? em : ab0;
      ab1 = slot == 1u ? em : ab1;
      ab2 = slot == 2u ? em : ab2;
      ab3 = slot == 3u ? em : ab3;
      ap += 1u;
      acc += em + static_cast<uint32_t>(ln);
    }
  }
  const uint32_t st[6] = {ab0, ab1, ab2, ab3, w0, w1};
#pragma unroll
  for (int i = 0; i < 6; ++i) state[i * TILE + l] = wrap(st[i]);
  uint32_t s = acc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (l == 0) {
    uint32_t total = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) total += part[i];
    out[0] = wrap(total);
  }
}

// ---------------------------------------------------------------- v6 fetch
constexpr int V6_GROUPS = 8;    // stream groups of the one-hot fetch
constexpr int V6_ROWS = 384;    // stream rows a group
constexpr int V6_SLAB_W = 4096; // slab words a row (32 chunks of 128)

// One call of fn200's body: (a) acc (128, 128), acc[row][c] = sum over the
// groups g of planes[g][r0[g][row]][c] in float32 (bf16 planes; a row index
// outside the group adds nothing): lane (r, c) takes column c of rows r, r + 8,
// ...; (b) got (1024, 128), got[n][j] = slab[n][idx[n][j]] for idx in [0, 4096),
// else 0 (the 32-chunk select): warp w takes rows w, w + 32, ..., four words a
// lane, the slab (16 MB) through L2.  r[call] = int(sum(acc)) + sum(got) + salt
// + call, wrapping; sum(acc) is taken in float64 in a fixed order, exact where
// the TPU's float32 sum is (the script's 131,072), then cut to int64's low word.
__global__ void __launch_bounds__(TILE)
    probe_v6_fetch(const uint16_t* __restrict__ planes, const int32_t* __restrict__ r0,
                   const int32_t* __restrict__ slab, const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ salt, int call, int32_t* __restrict__ r) {
  __shared__ double dpart[32];
  __shared__ uint32_t upart[32];
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5, c = l & 127;
  double dsum = 0.0;
  for (int row = l >> 7; row < 128; row += 8) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < V6_GROUPS; ++g) {
      const int k = __ldg(r0 + g * 128 + row);
      if (k >= 0 && k < V6_ROWS)
        a += __uint_as_float(static_cast<uint32_t>(__ldg(planes + (g * V6_ROWS + k) * 128 + c))
                             << 16);
    }
    dsum += a;
  }
  uint32_t usum = 0u;
  for (int n = warp; n < TILE; n += 32) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int32_t k = __ldg(idx + n * 128 + lane + 32 * p);
      if (k >= 0 && k < V6_SLAB_W)
        usum += static_cast<uint32_t>(__ldg(slab + static_cast<int64_t>(n) * V6_SLAB_W + k));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    dsum += __shfl_xor_sync(FULL, dsum, o);
    usum += __shfl_xor_sync(FULL, usum, o);
  }
  if (lane == 0) {
    dpart[warp] = dsum;
    upart[warp] = usum;
  }
  __syncthreads();
  if (l == 0) {
    double d = 0.0;
    uint32_t u = 0u;
    for (int i = 0; i < 32; ++i) {
      d += dpart[i];
      u += upart[i];
    }
    const uint32_t a = static_cast<uint32_t>(static_cast<long long>(d));
    r[call] = wrap(a + u + static_cast<uint32_t>(salt[0]) + static_cast<uint32_t>(call));
  }
}

// ---------------------------------------------------------------- body loop
// bodies of v6_probe2.py (probes/loops.py has the same values)
enum : int {
  BL_A = 0,   // (1024, 32) -> (32, 1024) transpose of words[:, :32] + i
  BL_B = 1,   // the 128-word window at (acc[0][0] + i) % 1024 through the 9-chunk select,
              // carry += out[l][0] + out[l][31] (to_regs(32))
  BL_C = 2,   // the same window, carry += out[l][0]
  BL_D = 3,   // rows (acc[0][0] + i) % 1088 + k, k < 32, of wordsT (1152, 1024)
  BL_D2 = 4,  // the same at per-lane bases (acc_l * 7 + i) % 1088
  BL_E = 5,   // place8: words[l][0:8] + i rolled to columns 8 pos .., pos = (words[l][8] + i) % 32
  BL_F = 6,   // sel_row of 32 registers: words[r][c + idx] + idx, idx = (acc + i) & 31
};
constexpr int BL_LW = 1152;  // words a row of the stream (9 chunks of 128)

// K reps over the (8, 128) carry from zeros, each rep's i = t + salt[0]; lane
// l = 128 r + c.  Every word a body builds each rep enters the lane's checksum:
// A the lane's 32 transposed words; B and C the window's rows, a warp reading
// its 32 lanes' rows in turn, 32 words at a time (coalesced), the row's words 0
// and 31 going back to its lane by a shuffle; D and D2 the lane's 32 gathered
// rows of its column (coalesced); E the 8 placed values (the other 248 words of
// the placed row are zeros); F the selected word.  B, C and D read acc[0][0]
// through shared memory behind a block barrier.
__global__ void __launch_bounds__(TILE)
    probe_body_loop(const int32_t* __restrict__ x, const int32_t* __restrict__ salt, int mode,
                    int reps, int32_t* __restrict__ out, int32_t* __restrict__ chk) {
  __shared__ uint32_t s_a00;
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5, r = l >> 7, c = l & 127;
  const uint32_t s0 = static_cast<uint32_t>(salt[0]);
  const bool shared_base = mode == BL_B || mode == BL_C || mode == BL_D;
  uint32_t acc = 0u, sum = 0u;
  if (l == 0) s_a00 = 0u;
  __syncthreads();
  for (int t = 0; t < reps; ++t) {
    const uint32_t i = static_cast<uint32_t>(t) + s0;
    if (mode == BL_A) {
      const int32_t* row = x + static_cast<int64_t>(l) * BL_LW;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const uint32_t v = static_cast<uint32_t>(row[k]) + i;
        sum += v;
        if (k == 0) acc += v;
      }
    } else if (mode == BL_B || mode == BL_C) {
      const int base = floor_mod(wrap(s_a00 + i), BL_LW - 128);
      uint32_t mine = 0u;
      for (int q = 0; q < 32; ++q) {
        const int32_t* row = x + static_cast<int64_t>(warp * 32 + q) * BL_LW;
        uint32_t v0 = 0u;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int col = min(max(base + lane + 32 * p, 0), BL_LW - 1);
          const uint32_t v = static_cast<uint32_t>(row[col]);
          sum += v;
          if (p == 0) v0 = v;
        }
        const uint32_t first = __shfl_sync(FULL, v0, 0), last = __shfl_sync(FULL, v0, 31);
        if (lane == q) mine = mode == BL_B ? first + last : first;
      }
      acc += mine;
    } else if (mode == BL_D || mode == BL_D2) {
      const int base = mode == BL_D ? floor_mod(wrap(s_a00 + i), BL_LW - 64)
                                    : floor_mod(wrap(acc * 7u + i), BL_LW - 64);
      uint32_t g0 = 0u, g31 = 0u;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int row = min(max(base + k, 0), BL_LW - 1);
        const uint32_t v = static_cast<uint32_t>(x[row * TILE + l]);
        sum += v;
        if (k == 0) g0 = v;
        if (k == 31) g31 = v;
      }
      acc += g0 + g31;
    } else if (mode == BL_E) {
      const int32_t* row = x + static_cast<int64_t>(l) * BL_LW;
      const int pos = floor_mod(wrap(static_cast<uint32_t>(row[8]) + i), 32);
      uint32_t v0 = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t v = static_cast<uint32_t>(row[k]) + i;
        sum += v;
        if (k == 0) v0 = v;
      }
      acc += pos == 0 ? v0 : 0u;
    } else {  // BL_F
      const uint32_t k = (acc + i) & 31u;
      const uint32_t v = static_cast<uint32_t>(x[r * BL_LW + c + static_cast<int>(k)]) + k;
      sum += v;
      acc += v;
    }
    if (shared_base) {
      __syncthreads();
      if (l == 0) s_a00 = acc;
      __syncthreads();
    }
  }
  out[l] = wrap(acc);
  chk[l] = wrap(sum);
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" int wgt_probe_lane_loop(const void* x, int flags, int rounds, int trips, int slab,
                                   void* out, void* wq, void* colbuf, void* stream) {
  if (slab < 1 || rounds < 0) return invalid();
  probe_lane_loop<<<1, TILE, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), flags, rounds, trips, slab, static_cast<int32_t*>(out),
      static_cast<int32_t*>(wq), static_cast<int32_t*>(colbuf));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_gather_loop(const void* tbl, int rows, int cols, int mode,
                                     const void* carry0, int reps, int nstage, void* out,
                                     void* chk, void* stream) {
  const bool ok = mode == GL_ROWS || mode == GL_COL ? cols == 128 && rows % 8 == 0
                  : mode == GL_REPL ? rows == 8 && cols % 128 == 0
                  : mode == GL_OWN  ? rows == TILE && cols % 32 == 0
                                    : false;
  if (!ok || nstage < 0 || nstage > STAGE_WORDS || nstage > rows * cols) return invalid();
  const int smem = nstage * 4;
  if (int rc = allow_smem(probe_gather_loop, smem)) return rc;
  probe_gather_loop<<<1, TILE, smem, as_stream(stream)>>>(
      static_cast<const int32_t*>(tbl), rows, cols, mode, static_cast<const int32_t*>(carry0),
      reps, nstage, static_cast<int32_t*>(out), static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_dot_loop(const void* a, const void* b, int m, int k, int n, int onehot,
                                  int reps, void* out, void* chk, void* stream) {
  const int smem = onehot ? k * n : n * (k + 16);
  const bool ok = onehot ? k >= 1 && n >= 128 && n % 4 == 0
                         : m >= 16 && m % 16 == 0 && k % 32 == 0 && k > 0 && n >= 128 &&
                               n % 32 == 0;
  if (!ok || smem > DOT_SMEM) return invalid();
  if (int rc = allow_smem(probe_dot_loop, smem)) return rc;
  probe_dot_loop<<<1, TILE, smem, as_stream(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), m, k, n, onehot, reps,
      static_cast<int32_t*>(out), static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_plane_refill(const void* pages, int rows, int mode, const void* carry0,
                                      int reps, int nstage, void* out, void* chk, void* stream) {
  int smem = 0;
  if (mode == PR_REFILL) {
    smem = rows * 32;
    if (rows < 1 || smem > STAGE_WORDS * 4) return invalid();
  } else if (mode == PR_ROWS) {
    if (rows < 1 || nstage < 0 || nstage > STAGE_WORDS || nstage > rows * 128) return invalid();
    smem = nstage * 4;
  } else {
    return invalid();
  }
  if (int rc = allow_smem(probe_plane_refill, smem)) return rc;
  probe_plane_refill<<<1, TILE, smem, as_stream(stream)>>>(
      static_cast<const int32_t*>(pages), rows, mode, static_cast<const int32_t*>(carry0), reps,
      nstage, static_cast<int32_t*>(out), static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_transpose_loop(const void* x, int t_rows, int addc, int reps, void* xt,
                                        void* out, void* chk, void* stream) {
  if (t_rows < 128 || t_rows % 32 || addc < TL_MASK || addc > TL_NOMASK) return invalid();
  if (int rc = allow_smem(probe_transpose_loop, TR_SMEM)) return rc;
  probe_transpose_loop<<<1, TILE, TR_SMEM, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), t_rows, addc, reps, static_cast<uint32_t*>(xt),
      static_cast<int32_t*>(out), static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_copy_loop(const void* x, int rows, int reps, void* out, void* chk,
                                   void* stream) {
  if (rows < 32 * COPY_ROWS) return invalid();  // rep t reads rows (t % 32) * 8 .. + 8
  probe_copy_loop<<<1, TILE, 0, as_stream(stream)>>>(static_cast<const int32_t*>(x), reps,
                                                      static_cast<int32_t*>(out),
                                                      static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_stack_fetch(const void* x, int reps, void* out, void* chk,
                                     void* stream) {
  if (int rc = allow_smem(probe_stack_fetch, STACK_SMEM)) return rc;
  probe_stack_fetch<<<1, TILE, STACK_SMEM, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), reps, static_cast<int32_t*>(out),
      static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_jframe(const void* x, const void* pre, int stage, int reps, void* colT,
                                void* pool, void* out, void* chk, void* stream) {
  if (stage < JF_V0 || stage > JF_P3) return invalid();
  probe_jframe<<<1, TILE, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(pre), stage, reps,
      static_cast<uint32_t*>(colT), static_cast<int32_t*>(pool), static_cast<int32_t*>(out),
      static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_v6_trip(const void* w, const void* salt, int trips, void* out,
                                 void* state, void* stream) {
  if (trips < 0) return invalid();
  if (int rc = allow_smem(probe_v6_trip, V6_SMEM)) return rc;
  probe_v6_trip<<<1, TILE, V6_SMEM, as_stream(stream)>>>(
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(salt), trips,
      static_cast<int32_t*>(out), static_cast<int32_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_v6_fetch(const void* planes, const void* r0, const void* slab,
                                  const void* idx, const void* salt, int call, void* r,
                                  void* stream) {
  if (call < 0) return invalid();
  probe_v6_fetch<<<1, TILE, 0, as_stream(stream)>>>(
      static_cast<const uint16_t*>(planes), static_cast<const int32_t*>(r0),
      static_cast<const int32_t*>(slab), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(salt), call, static_cast<int32_t*>(r));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_body_loop(const void* x, const void* salt, int mode, int reps,
                                   void* out, void* chk, void* stream) {
  if (mode < BL_A || mode > BL_F || reps < 0) return invalid();
  probe_body_loop<<<1, TILE, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(salt), mode, reps,
      static_cast<int32_t*>(out), static_cast<int32_t*>(chk));
  return static_cast<int>(cudaGetLastError());
}
