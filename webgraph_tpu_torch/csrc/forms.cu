// Single-shot capability forms, for Hopper (sm_90a): the counterparts of the
// one-shot pallas_calls of the JAX package's TPU capability scripts
// scripts/pallas_caps_probe.py, pallas_bisect_probe.py, pallas_bisect2.py and
// of v6_probe.py's probe_ta0 and probe_t8.  Each asks whether one Mosaic form
// lowers and computes the right array; here each is a small kernel that
// computes the same array exactly, seven kernels for seven families:
//
//   probe_form_gather    take_along_axis on axis 1 or 0, any table and index
//                        shape
//                          caps.probe_take_narrow :60, probe_take_wide :263;
//                          bisect.g_n128 :44, g_wide :53, g_axis0 :62;
//                          v6.probe_ta0 :32
//   probe_form_relayout  transposes (into a column block of a zero array),
//                        row-major reshapes and broadcasts
//                          caps.probe_transpose :304, probe_reshape :339;
//                          bisect.tr :105, rshp :113, bcast :121; v6.probe_t8 :49
//   probe_form_roll      a per-row left rotate (caps' 7-stage roll network) and a
//                        roll of whole rows by a device-held shift
//                          caps.probe_var_roll :77; bisect2.dyn_roll :84
//   probe_form_dot       int8 -> int32 products on the tensor cores (mma.sync
//                        m16n8k32), float32 and bf16 -> float32 on FMAs
//                          caps.probe_dot_dim0 :319; bisect.dot_var :72
//   probe_form_onehot    the one-hot products in closed form: byte-plane
//                        scatter, row gathers, a float32 scatter-sum
//                          caps.probe_onehot_scatter :101;
//                          bisect.dot_onehot_inkernel :86;
//                          bisect2.onehotT_gather :34, scatter_onehot :107
//   probe_form_copy      copies at device-held offsets by TMA bulk copies, in
//                        to shared memory on an mbarrier and out as a bulk group
//                          caps.probe_dma :169, probe_dma_flatten :280,
//                          probe_prefetch :210
//   probe_form_scalar    clz of uint32 words; a 7-trip loop with a count and a
//                        store under its condition
//                          caps.probe_clz :42, probe_fori :142
//
// Every form is a single call on small arrays: bound by its launch and a few
// hundred nanoseconds of latency, not by bytes or operations.  bisect2's two
// loops (transpose_in_loop, gather_in_loop) run on csrc/loops.cu's
// probe_transpose_loop and probe_gather_loop.  The kernels are
// the plain thread-a-word (or tile-a-block) forms of each; what the TPU
// computes through one-hot products and roll networks is computed here in its
// closed form (a load at the index the product or the roll selects), keeping
// the TPU's arithmetic (sign-extended int8 planes masked to a byte, bf16 values
// summed in float32).  The plain versions in probes/forms.py keep the
// scripts' steps.  int32 arithmetic wraps, done in uint32.
//
// Every C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments its kernel does not take.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t FILL = INT32_MIN;  // jnp.take_along_axis's fill for an index outside
constexpr int TILE = 1024;           // lanes of an (8, 128) tile
constexpr int ROW = 128;             // words a row of the copied and one-hot arrays
constexpr int MAX_BLOCKS = 8 * 132;  // a grid-stride kernel's blocks

__device__ __forceinline__ int64_t floor_mod64(int64_t a, int64_t m) {
  const int64_t r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float bf16_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// float -> bf16 -> float, round to nearest even (XLA's and torch's cast)
__device__ __forceinline__ float bf16_round(float f) {
  const uint32_t u = __float_as_uint(f);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

__device__ __forceinline__ int64_t gid() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t gstride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// ---------------------------------------------------------------- gather
// out (irows, icols), axis 1: out[i][j] = tbl[i][idx[i][j]] (irows == rows),
// axis 0: out[i][j] = tbl[idx[i][j]][j] (icols == cols); an index below 0
// counts from the end, one still outside gives FILL, as
// jnp.take_along_axis.  A thread a word, the table through L2 (bisect's
// (8192, 128) is 4 MB).
__global__ void __launch_bounds__(TILE)
    probe_form_gather(const int32_t* __restrict__ tbl, int rows, int cols,
                      const int32_t* __restrict__ idx, int irows, int icols, int axis,
                      int32_t* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(irows) * icols;
  const int span = axis == 1 ? cols : rows;
  for (int64_t e = gid(); e < n; e += gstride()) {
    const int64_t i = e / icols, j = e % icols;
    int64_t k = idx[e];
    if (k < 0) k += span;
    int32_t v = FILL;
    if (k >= 0 && k < span) v = __ldg(tbl + (axis == 1 ? i * cols + k : k * cols + j));
    out[e] = v;
  }
}

// ---------------------------------------------------------------- relayout
enum : int {
  RL_TRANSPOSE = 0,  // x (R, C) -> out (C, width): out[j][col + i] = x[i][j], the rest 0
  RL_COPY = 1,       // out.flat[e] = x.flat[e % n]: a reshape (n = out's size), a broadcast
};

// RL_TRANSPOSE: a 32 x 32 tile a 256-thread block (tx, ty), grid (width / 32,
// C / 32) rounded up; rows of x read and rows of out written 128 bytes a
// warp, through a 32 x 33 shared tile (conflict-free both ways).  RL_COPY: a
// word a thread.
__global__ void __launch_bounds__(TILE)
    probe_form_relayout(const int32_t* __restrict__ x, int R, int C, int mode, int width,
                        int col, int64_t n_out, int32_t* __restrict__ out) {
  if (mode == RL_COPY) {
    const int64_t n_in = static_cast<int64_t>(R) * C;
    for (int64_t e = gid(); e < n_out; e += gstride()) out[e] = __ldg(x + e % n_in);
    return;
  }
  __shared__ int32_t tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  for (int rr = ty; rr < 32; rr += 8) {
    const int i = k0 + rr - col, j = j0 + tx;
    tile[rr][tx] = (i >= 0 && i < R && j < C) ? x[static_cast<int64_t>(i) * C + j] : 0;
  }
  __syncthreads();
  for (int rr = ty; rr < 32; rr += 8) {
    const int j = j0 + rr, k = k0 + tx;
    if (j < C && k < width) out[static_cast<int64_t>(j) * width + k] = tile[tx][rr];
  }
}

// ---------------------------------------------------------------- roll
enum : int {
  RO_NET = 0,    // row i rotated left by shift[i] & (cols - 1): caps' network of rolls by 2^b
  RO_AXIS0 = 1,  // jnp.roll(x, shift[0], 0): out[i] = x[(i - shift) mod rows]
};

// A thread a word; the shifts are read from device memory.
__global__ void __launch_bounds__(TILE)
    probe_form_roll(const int32_t* __restrict__ x, int rows, int cols,
                    const int32_t* __restrict__ shift, int mode, int32_t* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(rows) * cols;
  const int64_t s0 = mode == RO_AXIS0 ? static_cast<int64_t>(shift[0]) : 0;
  for (int64_t e = gid(); e < n; e += gstride()) {
    const int64_t i = e / cols, j = e % cols;
    int64_t src;
    if (mode == RO_NET) {
      const int s = __ldg(shift + i) & (cols - 1);
      src = i * cols + ((j + s) & (cols - 1));
    } else {
      src = floor_mod64(i - s0, rows) * cols + j;
    }
    out[e] = __ldg(x + src);
  }
}

// ---------------------------------------------------------------- products
enum : int { DT_I8 = 0, DT_F32 = 1, DT_BF16 = 2 };

__device__ __forceinline__ void mma_s8(uint32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float load_f(const void* p, int64_t e, int dtype) {
  return dtype == DT_F32 ? __ldg(static_cast<const float*>(p) + e)
                         : bf16_float(__ldg(static_cast<const uint16_t*>(p) + e));
}

// out (m, n) = A (m, k) x b (k, n), A = a or, with trans_a, a (k, m) transposed
// (caps contracts dim 0 of both).  int8 (m % 64, k % 32, n % 128 == 0): a block
// of 256 threads an output tile of 64 rows x 128 columns; its rows of A and all
// of b are staged in shared memory k-contiguous (rows padded by 16 bytes, so a
// fragment's eight rows fall in distinct banks); warp w takes rows 16 (w & 3)
// .. + 16 and columns 64 (w >> 2) .. + 64, eight m16n8k32 products a 32-deep
// step, int32 sums.  float32 and bf16: a thread an output, grid (n / 128, m /
// 2), float32 FMAs in order of k; the scripts' operands are small integers, so
// every order of summation is exact.
__global__ void __launch_bounds__(256)
    probe_form_dot(const void* __restrict__ a, const void* __restrict__ b, int m, int k, int n,
                   int dtype, int trans_a, void* __restrict__ out) {
  const int tid = threadIdx.x;
  if (dtype != DT_I8) {
    const int i = blockIdx.y * 2 + (tid >> 7), j = blockIdx.x * 128 + (tid & 127);
    if (i >= m || j >= n) return;
    float acc = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const int64_t ae = trans_a ? static_cast<int64_t>(kk) * m + i : static_cast<int64_t>(i) * k + kk;
      acc = fmaf(load_f(a, ae, dtype), load_f(b, static_cast<int64_t>(kk) * n + j, dtype), acc);
    }
    static_cast<float*>(out)[static_cast<int64_t>(i) * n + j] = acc;
    return;
  }
  extern __shared__ __align__(16) uint8_t sm[];
  const int ks = k + 16, m0 = blockIdx.y * 64, n0 = blockIdx.x * 128;
  uint8_t* As = sm;
  uint8_t* Bs = sm + 64 * ks;
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  for (int e = tid; e < 64 * k; e += 256) {
    int i, kk;
    if (trans_a) {  // read a's rows (k, m) along m
      i = e & 63;
      kk = e >> 6;
      As[i * ks + kk] = static_cast<uint8_t>(A[static_cast<int64_t>(kk) * m + m0 + i]);
    } else {
      i = e / k;
      kk = e % k;
      As[i * ks + kk] = static_cast<uint8_t>(A[static_cast<int64_t>(m0 + i) * k + kk]);
    }
  }
  for (int e = tid; e < 128 * k; e += 256) {
    const int j = e & 127, kk = e >> 7;
    Bs[j * ks + kk] = static_cast<uint8_t>(B[static_cast<int64_t>(kk) * n + n0 + j]);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 64;
  uint32_t acc[8][4] = {};
  for (int k0 = 0; k0 < k; k0 += 32) {
    const uint8_t* ar = As + (r0 + g) * ks + k0 + 4 * tq;
    const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * ks), a2 = ld32(ar + 16),
                   a3 = ld32(ar + 8 * ks + 16);
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const uint8_t* br = Bs + (c0 + 8 * jt + g) * ks + k0 + 4 * tq;
      mma_s8(acc[jt], a0, a1, a2, a3, ld32(br), ld32(br + 16));
    }
  }
  int32_t* o = static_cast<int32_t*>(out);
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    const int64_t row = m0 + r0 + g, colx = n0 + c0 + 8 * jt + 2 * tq;
    o[row * n + colx] = static_cast<int32_t>(acc[jt][0]);
    o[row * n + colx + 1] = static_cast<int32_t>(acc[jt][1]);
    o[(row + 8) * n + colx] = static_cast<int32_t>(acc[jt][2]);
    o[(row + 8) * n + colx + 1] = static_cast<int32_t>(acc[jt][3]);
  }
}

// ---------------------------------------------------------------- one-hot products
enum : int {
  OH_SCATTER = 0,        // caps: src v (nsrc, 128) into rows by idx, int8 byte planes
  OH_GATHER_I8 = 1,      // bisect: row idx[l] of an int8 pool (rows, 128), sign-extended
  OH_GATHER_PLANES = 2,  // bisect2 i8: row idx[l] of an int32 pool through its int8 planes
  OH_GATHER_BF16 = 3,    // bisect2 bf16: the same through bf16 planes
  OH_SCATTER_SUM = 4,    // bisect2: bf16 values summed in float32 into rows, broadcast
};

// OH_SCATTER: a thread an output word (r, c): over the source rows i with idx[i]
// == r, the four planes' sums of sign-extended bytes of v[i][c], each masked to
// its byte and shifted back (not the int32 sum: they differ where a word has two
// nonzero contributors).  OH_GATHER_*: a thread an output word (l, c) = the
// pool row idx[l]'s word c (0 outside the pool), through the planes' arithmetic.
// OH_SCATTER_SUM (one block): thread r sums, in lane order, the bf16-rounded
// values of the lanes whose idx is r, in float32; the truncated sums fill the
// rows.
__global__ void __launch_bounds__(TILE)
    probe_form_onehot(const void* __restrict__ src, const int32_t* __restrict__ idx, int nsrc,
                      int rows, int mode, int32_t* __restrict__ out) {
  if (mode == OH_SCATTER_SUM) {
    __shared__ int32_t s_idx[TILE];
    __shared__ float s_val[TILE];
    __shared__ float s_sum[TILE];
    const int32_t* v = static_cast<const int32_t*>(src);
    for (int e = threadIdx.x; e < nsrc; e += blockDim.x) {
      s_idx[e] = idx[e];
      s_val[e] = bf16_round(static_cast<float>(v[e]));
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float acc = 0.f;
      for (int e = 0; e < nsrc; ++e) acc += s_idx[e] == r ? s_val[e] : 0.f;
      s_sum[r] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * ROW; e += blockDim.x)
      out[e] = static_cast<int32_t>(s_sum[e / ROW]);
    return;
  }
  const int64_t n = static_cast<int64_t>(mode == OH_SCATTER ? rows : nsrc) * ROW;
  for (int64_t e = gid(); e < n; e += gstride()) {
    const int64_t r = e / ROW, c = e % ROW;
    uint32_t o = 0u;
    if (mode == OH_SCATTER) {
      const int32_t* v = static_cast<const int32_t*>(src);
      int32_t part[4] = {0, 0, 0, 0};
      for (int i = 0; i < nsrc; ++i) {
        if (__ldg(idx + i) != r) continue;
        const uint32_t w = static_cast<uint32_t>(__ldg(v + static_cast<int64_t>(i) * ROW + c));
#pragma unroll
        for (int p = 0; p < 4; ++p) part[p] += static_cast<int8_t>(w >> (8 * p));
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) o += (static_cast<uint32_t>(part[p]) & 0xFFu) << (8 * p);
    } else {
      const int32_t k = __ldg(idx + r);
      if (k >= 0 && k < rows) {
        const int64_t at = static_cast<int64_t>(k) * ROW + c;
        if (mode == OH_GATHER_I8) {
          o = static_cast<uint32_t>(static_cast<int32_t>(__ldg(static_cast<const int8_t*>(src) + at)));
        } else {
          const uint32_t w = static_cast<uint32_t>(__ldg(static_cast<const int32_t*>(src) + at));
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const uint32_t byte = (w >> (8 * p)) & 0xFFu;
            const uint32_t part =
                mode == OH_GATHER_PLANES
                    ? static_cast<uint32_t>(static_cast<int32_t>(static_cast<int8_t>(byte))) & 0xFFu
                    : static_cast<uint32_t>(static_cast<int32_t>(static_cast<float>(byte)));
            o += part << (8 * p);
          }
        }
      }
    }
    out[e] = static_cast<int32_t>(o);
  }
}

// ---------------------------------------------------------------- copies
enum : int {
  CP_DMA = 0,       // rows start .. + 256 of src, doubled, to rows start + 8 .. of dst
  CP_FLATTEN = 1,   // src (16, 128) to dst row 0 (8, 2048): the words in order
  CP_PREFETCH = 2,  // block t: rows 8 srows[t] .. + 8 of src, plus 1, to rows 8 t .. + 8
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A block's copy of nrows rows of 128 words: thread 0 reads the offset from
// device memory (the scalar-prefetch index map's read), starts one TMA bulk
// copy into shared memory that completes on an mbarrier (make_async_copy and
// its DMA semaphore), every thread waits on the barrier, applies the form's
// operation to its words and fences them to the async proxy; then thread 0
// copies the buffer out with one bulk store and waits for its group.  A copy
// whose rows fall outside src or dst is not made: the wrapper's fill stays.
__global__ void __launch_bounds__(512)
    probe_form_copy(const int32_t* __restrict__ src, int src_rows,
                    const int32_t* __restrict__ offs, int mode, int32_t* __restrict__ dst,
                    int dst_rows) {
  extern __shared__ __align__(128) uint32_t buf[];
  __shared__ __align__(8) uint64_t bar;
  int64_t from = 0, to = 0, nrows = 16;
  if (mode == CP_DMA) {
    from = offs[0];
    to = from + 8;
    nrows = 256;
  } else if (mode == CP_PREFETCH) {
    from = static_cast<int64_t>(offs[blockIdx.x]) * 8;
    to = static_cast<int64_t>(blockIdx.x) * 8;
    nrows = 8;
  }
  if (from < 0 || from + nrows > src_rows || to < 0 || to + nrows > dst_rows) return;
  const uint32_t bytes = static_cast<uint32_t>(nrows * ROW * 4);
  const uint32_t sbuf = smem_addr(buf), sbar = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sbar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(sbuf),
        "l"(src + from * ROW), "r"(bytes), "r"(sbar)
        : "memory");
  }
  uint32_t done = 0u;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sbar)
        : "memory");
  }
  if (mode != CP_FLATTEN) {
    for (int e = threadIdx.x; e < nrows * ROW; e += blockDim.x)
      buf[e] = mode == CP_DMA ? buf[e] * 2u : buf[e] + 1u;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst + to * ROW),
                 "r"(sbuf), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------- scalar forms
enum : int { SC_CLZ = 0, SC_FORI = 1 };

// A thread a word.  SC_CLZ: the leading zeros of the uint32 word, 32 for 0.
// SC_FORI: trips adds of the word and a count; the word stored under count ==
// 7 (pl.when), the count by thread 0.
__global__ void __launch_bounds__(TILE)
    probe_form_scalar(const int32_t* __restrict__ x, int n, int mode, int trips,
                      int32_t* __restrict__ out, int32_t* __restrict__ cnt) {
  for (int64_t e = gid(); e < n; e += gstride()) {
    const uint32_t u = static_cast<uint32_t>(x[e]);
    if (mode == SC_CLZ) {
      out[e] = u > 0u ? __clz(static_cast<int>(u)) : 32;
      continue;
    }
    uint32_t a = 0u;
    int b = 0;
    for (int i = 0; i < trips; ++i) {
      a += u;
      b += 1;
    }
    if (b == 7) out[e] = static_cast<int32_t>(a);
    if (e == 0) cnt[0] = b;
  }
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

int blocks_for(int64_t n, int threads) {
  const int64_t b = (n + threads - 1) / threads;
  return static_cast<int>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" int wgt_probe_form_gather(const void* tbl, int rows, int cols, const void* idx,
                                     int irows, int icols, int axis, void* out, void* stream) {
  if (rows < 1 || cols < 1 || (axis == 1 && irows != rows) || (axis == 0 && icols != cols) ||
      (axis != 0 && axis != 1))
    return invalid();
  probe_form_gather<<<blocks_for(static_cast<int64_t>(irows) * icols, TILE), TILE, 0,
                      as_stream(stream)>>>(static_cast<const int32_t*>(tbl), rows, cols,
                                           static_cast<const int32_t*>(idx), irows, icols, axis,
                                           static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_form_relayout(const void* x, int rows, int cols, int mode, int width,
                                       int col, int64_t n_out, void* out, void* stream) {
  if (rows < 1 || cols < 1) return invalid();
  const auto* xs = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  if (mode == RL_COPY) {
    if (n_out < 1) return invalid();
    probe_form_relayout<<<blocks_for(n_out, TILE), TILE, 0, as_stream(stream)>>>(
        xs, rows, cols, mode, 0, 0, n_out, o);
  } else if (mode == RL_TRANSPOSE) {
    if (col < 0 || width < col + rows) return invalid();
    const dim3 grid((width + 31) / 32, (cols + 31) / 32);
    probe_form_relayout<<<grid, 256, 0, as_stream(stream)>>>(xs, rows, cols, mode, width, col,
                                                             0, o);
  } else {
    return invalid();
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_form_roll(const void* x, int rows, int cols, const void* shift,
                                   int mode, void* out, void* stream) {
  if (rows < 1 || cols < 1 || (mode != RO_NET && mode != RO_AXIS0) ||
      (mode == RO_NET && (cols & (cols - 1))))
    return invalid();
  probe_form_roll<<<blocks_for(static_cast<int64_t>(rows) * cols, TILE), TILE, 0,
                    as_stream(stream)>>>(static_cast<const int32_t*>(x), rows, cols,
                                         static_cast<const int32_t*>(shift), mode,
                                         static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_form_dot(const void* a, const void* b, int m, int k, int n, int dtype,
                                  int trans_a, void* out, void* stream) {
  if (m < 1 || k < 1 || n < 1) return invalid();
  if (dtype == DT_I8) {
    if (m % 64 || k % 32 || n % 128) return invalid();
    const int smem = (64 + 128) * (k + 16);
    if (smem > 227 * 1024) return invalid();
    if (int rc = allow_smem(probe_form_dot, smem)) return rc;
    probe_form_dot<<<dim3(n / 128, m / 64), 256, smem, as_stream(stream)>>>(a, b, m, k, n, dtype,
                                                                           trans_a, out);
  } else if (dtype == DT_F32 || dtype == DT_BF16) {
    probe_form_dot<<<dim3((n + 127) / 128, (m + 1) / 2), 256, 0, as_stream(stream)>>>(
        a, b, m, k, n, dtype, trans_a, out);
  } else {
    return invalid();
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_form_onehot(const void* src, const void* idx, int nsrc, int rows,
                                     int mode, void* out, void* stream) {
  if (nsrc < 1 || rows < 1 || mode < OH_SCATTER || mode > OH_SCATTER_SUM) return invalid();
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  if (mode == OH_SCATTER_SUM) {
    if (nsrc > TILE || rows > TILE) return invalid();
    probe_form_onehot<<<1, TILE, 0, as_stream(stream)>>>(src, ix, nsrc, rows, mode, o);
  } else {
    const int64_t n = static_cast<int64_t>(mode == OH_SCATTER ? rows : nsrc) * ROW;
    probe_form_onehot<<<blocks_for(n, 256), 256, 0, as_stream(stream)>>>(src, ix, nsrc, rows,
                                                                         mode, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_form_copy(const void* src, int src_rows, const void* offs, int mode,
                                   int blocks, void* dst, int dst_rows, void* stream) {
  int nrows;
  if (mode == CP_DMA) {
    nrows = 256;
  } else if (mode == CP_FLATTEN) {
    nrows = 16;
  } else if (mode == CP_PREFETCH) {
    nrows = 8;
  } else {
    return invalid();
  }
  if (blocks < 1 || (mode != CP_PREFETCH && blocks != 1)) return invalid();
  const int smem = nrows * ROW * 4;
  if (int rc = allow_smem(probe_form_copy, smem)) return rc;
  probe_form_copy<<<blocks, 512, smem, as_stream(stream)>>>(
      static_cast<const int32_t*>(src), src_rows, static_cast<const int32_t*>(offs), mode,
      static_cast<int32_t*>(dst), dst_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgt_probe_form_scalar(const void* x, int n, int mode, int trips, void* out,
                                     void* cnt, void* stream) {
  if (n < 1 || (mode != SC_CLZ && mode != SC_FORI) || trips < 0) return invalid();
  probe_form_scalar<<<blocks_for(n, TILE), TILE, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), n, mode, trips, static_cast<int32_t*>(out),
      static_cast<int32_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}
