// hll_pull: HyperBall's register max by pull over a graph's out-CSR, for
// Hopper (sm_90a), iteration after iteration in one persistent cooperative
// launch, with the HyperLogLog estimate, the centrality accumulators and
// the neighbourhood function fused in.
//
// It has no Pallas counterpart.  It takes the place of the XLA programs of
// webgraph_tpu/algo/hyperball_jax.py: hyperball_step (:38), a gather of
// regs[arc_dst] and a segment_max by arc_src, its systolic twin
// hyperball_step_systolic (:49), and what HyperBallJax.iterate does after
// them (:121-135: estimate_rows, the accumulators, the NF sum; two host
// reads an iteration, :110 and :135).  Iteration t of a launch (T = it0 +
// t + 1, the iteration's number), for each node x with registers old[x]
// (M = 2^log2m bytes):
//
//   new[x]  = max(old[x], max over successors y of old[y])      (bytewise)
//   flag[x] = new[x] != old[x]
//   where flag[x]:  c = estimate(new[x]);  inc = c - cur[x];  cur[x] = c
//                   sod[x] += T inc;  soi[x] += inc / T;  disc[d][x] += f[t][d] inc
//   mod[t]  = sum of flag[x];   nf[t] = sum of w[x] cur[x]
//
// A node whose row did not change has inc == 0 and writes nothing but its
// row and its flag.  The estimate is hll.py::_estimate's: z = sum of
// 2^-r (each term exact, built from its exponent), e = alpha m^2 / z, and
// m ln(m / v) where e <= 2.5 m and v, the zero registers, is positive.
//
// Systolic iterations (HyperBall.java:981-991): where the caller asks for
// them, an iteration whose previous iteration modified a share of the
// nodes under `sys_thr` (the first of a launch reads mod0) skips every
// successor whose flag of the previous iteration is 0.  Such a row has not
// changed since x last took its max, so the registers are the dense
// step's, byte for byte.  Each iteration's choice is recorded.
//
// The shape is or_pull's (propagate.cu).  Registers ping-pong between
// buffers (the input, then a, b, a, ...; the flags likewise), so a row
// moves one hop an iteration (Jacobi, as the JAX step).  A grid barrier on
// a device counter separates the iterations; a cooperative launch keeps
// every block resident.  After it every block reads the iteration's
// modified count and sums the blocks' NF partials, in block order, from
// fixed slots, so every block, and every run on one card, gets the same NF
// and stops on the same iteration: the first that modified nothing, whose
// NF rose by a share under `thr` (thr >= 0; HyperBall's run, :145-148), or
// the cap.  The host reads the iterations run and each one's modified
// count, NF and systolic choice once a launch.
//
// Mapping: a row is M / 16 16-byte vectors, G = min(32, M / 16) lanes a
// slot (VPL = 2 vectors a lane at log2m 10); a node takes P slots, P = 1,
// 2, 4, ... up to a warp by out-degree (`order`, `bounds`, `span`:
// kernels/propagate.py::pull_order of the out-CSR), the successors strided
// over the slots; nodes of out-degree over 16 P_warp take a block each.
// Slots reduce by __vmaxu4 on shuffled words (a block's warps through
// shared memory); slot 0 holds the new row, finds by a shuffle whether any
// word changed, and its lanes sum the estimate's terms of their bytes,
// reduced across the slot in a fixed order; its first lane updates the
// node's scalars.  Gathers and reads of the rows and flags go through L2
// (ld.global.cg): another SM wrote them last iteration, and this SM's L1
// may hold the iteration before.
//
// Bound: bytes.  An iteration must read the out-CSR (8 (n + 1) + 4 m), the
// old rows (M n), the old flags and cur (n + 8 n; the weights, 8 n, where
// given), write the new rows and flags (M n + n) and, for each changed
// node, cur (8) and each accumulator (read and written, 16).  The gathered
// rows (M bytes an arc) stay out of the bound; at log2m 6 a register
// buffer of cnr-2000's size is 20.8 MB, so two of them and the out-CSR
// pass the 50 MB L2 and the gathers partly come from HBM.
//
// The C entry point returns the launch's error code: a log2m outside
// 4..10, a refused cooperative launch, a card without cooperative
// launches, or more blocks than NF partial slots is returned, never run
// another way.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 2;
constexpr int BLOCK_E = 9;  // a warp's nodes: out-degree <= 2^(BLOCK_E - lg G)
constexpr int LOG2M_MIN = 4;
constexpr int LOG2M_MAX = 10;
constexpr int MAXB = 2048;  // blocks a launch at most: NF partial slots an iteration
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

template <int LOG2M>
struct Row {
  static constexpr int M = 1 << LOG2M;                           // registers (bytes)
  static constexpr int V = M / 16;                               // 16-byte vectors
  static constexpr int LG = LOG2M - 4 < 5 ? LOG2M - 4 : 5;       // log2 of G
  static constexpr int G = 1 << LG;                              // lanes a slot
  static constexpr int VPL = V / G;                              // vectors a lane
};

struct Args {
  const int32_t* succ;
  const int32_t* order;
  const int64_t* bounds;
  const longlong2* span;  // (first, end) of the out-arcs of order[i]
  int64_t n;
  const uint4* in;
  uint4* a;
  uint4* b;
  const uint8_t* fin;
  uint8_t* fa;
  uint8_t* fb;
  double* cur;  // null: registers and flags only
  const double* w;  // null: every weight 1
  double* sod;
  double* soi;
  double* disc;  // [nd][n]
  const double* factors;  // [cap][nd]: f_d(T) of each iteration
  int nd;
  double alpha_mm;
  u64 mod0;  // nodes modified by the iteration before the launch
  double nf0, thr, sys_thr;
  int systolic, it0, cap;
  // [0] iterations run, [1] the barrier's count, then by iteration t:
  // [2 + t] modified, [2 + cap + t] NF (double), [2 + 2 cap + t] systolic,
  // then [2 + 3 cap, + 2 MAXB) the blocks' NF partials of the even and odd
  // iterations (double)
  u64* stat;
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

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y), __vmaxu4(a.z, b.z),
                    __vmaxu4(a.w, b.w));
}

// the max of v and lane ^ o's v
__device__ __forceinline__ uint4 shfl_max(uint4 v, int o) {
  uint4 u;
  u.x = __shfl_xor_sync(FULL, v.x, o);
  u.y = __shfl_xor_sync(FULL, v.y, o);
  u.z = __shfl_xor_sync(FULL, v.z, o);
  u.w = __shfl_xor_sync(FULL, v.w, o);
  return vmax(v, u);
}

// sum of 2^-r over the 4 bytes r of x (exact terms), and the zero bytes
__device__ __forceinline__ void terms(unsigned x, double& z, int& v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned r = (x >> (8 * k)) & 0xffu;
    z += __longlong_as_double(static_cast<long long>(1023 - r) << 52);
    v += r == 0;
  }
}

// acc = max(acc, rows of the successors succ[first], succ[first + stride],
// ... < end): vectors j, j + G, ... of each row; in a systolic iteration
// only the successors whose flag in fsrc is set.
template <int LOG2M>
__device__ __forceinline__ void gather_max(const int32_t* __restrict__ succ, const uint4* src,
                                           const uint8_t* fsrc, bool sys, int64_t first,
                                           int64_t end, int64_t stride, int j,
                                           uint4 (&acc)[Row<LOG2M>::VPL]) {
  using R = Row<LOG2M>;
  int64_t q = first;
  for (; q + (UNROLL - 1) * stride < end; q += UNROLL * stride) {
    int32_t y[UNROLL];
    bool live[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) y[u] = __ldg(succ + q + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) live[u] = !sys || __ldcg(fsrc + y[u]) != 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (live[u]) {
#pragma unroll
        for (int i = 0; i < R::VPL; ++i)
          acc[i] = vmax(acc[i], __ldcg(src + static_cast<int64_t>(y[u]) * R::V + j + i * R::G));
      }
  }
  for (; q < end; q += stride) {
    const int32_t y = __ldg(succ + q);
    if (!sys || __ldcg(fsrc + y) != 0) {
#pragma unroll
      for (int i = 0; i < R::VPL; ++i)
        acc[i] = vmax(acc[i], __ldcg(src + static_cast<int64_t>(y) * R::V + j + i * R::G));
    }
  }
}

// Node x's new row `now` (in slot 0's G lanes, `mine`; its first lane
// `lead`) against its old row `was`: stores the row and the flag and,
// where the row changed, the estimate and the accumulators of iteration t;
// adds the flag to modc and w[x] cur[x] to nfp.  Every lane of the warp
// calls it.
template <int LOG2M>
__device__ __forceinline__ void finish(const Args& p, uint4* dst, uint8_t* fdst, int64_t x, int j,
                                       bool mine, const uint4 (&was)[Row<LOG2M>::VPL],
                                       const uint4 (&now)[Row<LOG2M>::VPL], int t, u64& modc,
                                       double& nfp) {
  using R = Row<LOG2M>;
  int ch = 0;
  if (mine) {
#pragma unroll
    for (int i = 0; i < R::VPL; ++i) {
      dst[x * R::V + j + i * R::G] = now[i];
      ch |= (now[i].x != was[i].x) | (now[i].y != was[i].y) | (now[i].z != was[i].z) |
            (now[i].w != was[i].w);
    }
  }
#pragma unroll
  for (int o = 1; o < R::G; o <<= 1) ch |= __shfl_xor_sync(FULL, ch, o);
  const bool lead = mine && j == 0;
  if (lead) {
    fdst[x] = static_cast<uint8_t>(ch);
    modc += ch;
  }
  if (p.cur == nullptr) return;
  double z = 0.0;
  int v = 0;
  if (__any_sync(FULL, mine && ch)) {
    if (mine && ch) {
#pragma unroll
      for (int i = 0; i < R::VPL; ++i) {
        terms(now[i].x, z, v);
        terms(now[i].y, z, v);
        terms(now[i].z, z, v);
        terms(now[i].w, z, v);
      }
    }
#pragma unroll
    for (int o = 1; o < R::G; o <<= 1) {
      z += __shfl_xor_sync(FULL, z, o);
      v += __shfl_xor_sync(FULL, v, o);
    }
  }
  if (!lead) return;
  double c = p.cur[x];
  if (ch) {
    const double m = R::M;
    const double e = p.alpha_mm / z;
    const double cnt = (e <= 2.5 * m && v > 0) ? m * log(m / v) : e;
    const double inc = cnt - c;
    const double T = p.it0 + t + 1;
    p.cur[x] = c = cnt;
    if (p.sod != nullptr) p.sod[x] += T * inc;
    if (p.soi != nullptr) p.soi[x] += inc / T;
    for (int d = 0; d < p.nd; ++d)
      p.disc[d * p.n + x] += __ldg(p.factors + static_cast<int64_t>(t) * p.nd + d) * inc;
  }
  nfp += (p.w != nullptr ? __ldg(p.w + x) : 1.0) * c;
}

template <int LOG2M>
__global__ void __launch_bounds__(THREADS) hll_pull(Args p) {
  using R = Row<LOG2M>;
  constexpr int G = R::G, LG = R::LG, VPL = R::VPL;
  __shared__ uint4 s_red[WARPS][R::V];
  __shared__ u64 s_mod[WARPS];
  __shared__ double s_nf[WARPS];
  __shared__ int64_t s_first[6];  // the first warp of each class
  __shared__ int s_stop, s_sys;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane & (G - 1);
  const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * WARPS;
  const int64_t nblock = p.bounds[BLOCK_E - LG];
  const int64_t big = p.n - nblock;  // nodes a block each
  const double nn = p.n > 1 ? static_cast<double>(p.n) : 1.0;
  double* parts = reinterpret_cast<double*>(p.stat + 2 + 3 * static_cast<int64_t>(p.cap));
  double prev_nf = p.nf0;  // thread 0's

  // the warp classes, widest first: P slots a node, out-degree <= 4 P (the
  // widest up to 16 P), 32 / (G P) nodes a warp; each class starts on the
  // warp after the last one the classes before it took
  if (threadIdx.x == 0) {
    int64_t w = (big < gridDim.x ? big : gridDim.x) * WARPS;
    for (int c = 5 - LG; c >= 0; --c) {
      const int per = 32 >> (LG + c);
      const int64_t lo = c == 0 ? 0 : p.bounds[c + 1];
      const int64_t hi = c == 5 - LG ? nblock : p.bounds[c + 2];
      s_first[c] = w % nwarps;
      w += (hi - lo + per - 1) / per;
    }
    s_sys = p.systolic && static_cast<double>(p.mod0) / nn < p.sys_thr;
  }
  __syncthreads();

  int t = 0;
  for (;; ++t) {
    const uint4* src = t == 0 ? p.in : ((t & 1) ? p.a : p.b);
    uint4* dst = (t & 1) ? p.b : p.a;
    const uint8_t* fsrc = t == 0 ? p.fin : ((t & 1) ? p.fa : p.fb);
    uint8_t* fdst = (t & 1) ? p.fb : p.fa;
    const bool sys = s_sys;
    u64 modc = 0;
    double nfp = 0.0;

    // out-degree > 16 slots a warp: a block a node
    const int bslots = THREADS >> LG, bslot = threadIdx.x >> LG;
    for (int64_t i = nblock + blockIdx.x; i < p.n; i += gridDim.x) {
      const int64_t x = p.order[i];
      const longlong2 r = __ldg(p.span + i);
      const bool mine = warp == 0 && lane < G;  // slot 0 of the block
      uint4 was[VPL], acc[VPL];
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        was[v] = mine ? __ldcg(src + x * R::V + j + v * G) : make_uint4(0, 0, 0, 0);
        acc[v] = was[v];
      }
      gather_max<LOG2M>(p.succ, src, fsrc, sys, r.x + bslot, r.y, bslots, j, acc);
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        for (int o = G; o < 32; o <<= 1) acc[v] = shfl_max(acc[v], o);
      if (lane < G)
#pragma unroll
        for (int v = 0; v < VPL; ++v) s_red[warp][j + v * G] = acc[v];
      __syncthreads();
      if (warp == 0) {
        if (mine)
          for (int w = 1; w < WARPS; ++w)
#pragma unroll
            for (int v = 0; v < VPL; ++v) acc[v] = vmax(acc[v], s_red[w][j + v * G]);
        finish<LOG2M>(p, dst, fdst, x, j, mine, was, acc, t, modc, nfp);
      }
      __syncthreads();
    }

    // the warp classes
    for (int c = 5 - LG; c >= 0; --c) {
      const int P = 1 << c, S = G << c;  // slots, lanes a node
      const int64_t lo = c == 0 ? 0 : p.bounds[c + 1];
      const int64_t hi = c == 5 - LG ? nblock : p.bounds[c + 2];
      const int per = 32 / S, slot = (lane & (S - 1)) >> LG;
      int64_t w = gwarp - s_first[c];
      if (w < 0) w += nwarps;
      for (int64_t base = lo + w * per; base < hi; base += nwarps * per) {
        const int64_t i = base + lane / S;
        const bool mine = i < hi && slot == 0;
        uint4 was[VPL], acc[VPL];
        int64_t x = 0;
#pragma unroll
        for (int v = 0; v < VPL; ++v) was[v] = make_uint4(0, 0, 0, 0);
        if (i < hi) {
          x = p.order[i];
          const longlong2 r = __ldg(p.span + i);
          if (mine)
#pragma unroll
            for (int v = 0; v < VPL; ++v) was[v] = __ldcg(src + x * R::V + j + v * G);
#pragma unroll
          for (int v = 0; v < VPL; ++v) acc[v] = was[v];
          gather_max<LOG2M>(p.succ, src, fsrc, sys, r.x + slot, r.y, P, j, acc);
        } else {
#pragma unroll
          for (int v = 0; v < VPL; ++v) acc[v] = was[v];
        }
        __syncwarp();
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          for (int o = G; o < S; o <<= 1) acc[v] = shfl_max(acc[v], o);
        finish<LOG2M>(p, dst, fdst, x, j, mine, was, acc, t, modc, nfp);
      }
    }

    // the iteration's counts: the modified nodes (an atomic a block) and
    // the NF (a partial a block in its slot, summed in a fixed order)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      modc += __shfl_xor_sync(FULL, modc, o);
      nfp += __shfl_xor_sync(FULL, nfp, o);
    }
    if (lane == 0) {
      s_mod[warp] = modc;
      s_nf[warp] = nfp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      u64 mb = 0;
      double nb = 0.0;
      for (int w = 0; w < WARPS; ++w) {
        mb += s_mod[w];
        nb += s_nf[w];
      }
      if (mb) atomicAdd(p.stat + 2 + t, mb);
      parts[(t & 1) * MAXB + blockIdx.x] = nb;
    }
    grid_sync(p.stat + 1, static_cast<u64>(t + 1) * gridDim.x);
    if (threadIdx.x == 0) {
      const u64 mod = __ldcg(p.stat + 2 + t);
      double nf = 0.0;
      for (unsigned b = 0; b < gridDim.x; ++b) nf += __ldcg(parts + (t & 1) * MAXB + b);
      if (blockIdx.x == 0) {
        reinterpret_cast<double*>(p.stat + 2 + p.cap)[t] = nf;
        p.stat[2 + 2 * p.cap + t] = sys;
      }
      s_stop = t + 1 == p.cap || mod == 0 ||
               (p.thr >= 0.0 && prev_nf != 0.0 && (nf - prev_nf) / prev_nf < p.thr);
      s_sys = p.systolic && static_cast<double>(mod) / nn < p.sys_thr;
      prev_nf = nf;
    }
    __syncthreads();
    if (s_stop) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.stat[0] = static_cast<u64>(t + 1);
}

const void* const KERNELS[] = {
    reinterpret_cast<const void*>(hll_pull<4>), reinterpret_cast<const void*>(hll_pull<5>),
    reinterpret_cast<const void*>(hll_pull<6>), reinterpret_cast<const void*>(hll_pull<7>),
    reinterpret_cast<const void*>(hll_pull<8>), reinterpret_cast<const void*>(hll_pull<9>),
    reinterpret_cast<const void*>(hll_pull<10>)};
constexpr int NKERNELS = LOG2M_MAX - LOG2M_MIN + 1;
static_assert(sizeof(KERNELS) / sizeof(KERNELS[0]) == NKERNELS, "one instance a log2m");

// blocks a launch of each instance on each device: SMs x occupancy, found
// at the first launch
int g_blocks[64][NKERNELS];

}  // namespace

// Up to `cap` iterations over n nodes of 2^log2m registers from `in` and
// its flags `fin` (uint8[n]), into a and b (fa and fb) alternately (the
// result of L iterations in a when L is odd, else b; b may be `in`, fb
// `fin`: iteration 1 writes them after every block has read them); cur,
// sod, soi: device float64[n] (cur null: registers and flags only, the
// others null when not kept); w: float64[n] or null; disc: float64[nd][n];
// factors: float64[cap][nd]; stat: device int64[2 + 3 cap + 2 MAXB],
// zeroed; order, bounds, span: the out-degree order.
extern "C" int wgt_hll_pull(const void* succ, const void* order, const void* bounds,
                            const void* span, int64_t n, int log2m, const void* in, void* a,
                            void* b, const void* fin, void* fa, void* fb, void* cur,
                            const void* w, void* sod, void* soi, void* disc, int nd,
                            const void* factors, double alpha_mm, int64_t mod0, double nf0,
                            double thr, int systolic, double sys_thr, int it0, int cap,
                            void* stat, void* stream) {
  if (log2m < LOG2M_MIN || log2m > LOG2M_MAX || cap < 1 || nd < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int ki = log2m - LOG2M_MIN;
  const void* kernel = KERNELS[ki];
  if (g_blocks[dev][ki] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (sms * per_sm > MAXB) return static_cast<int>(cudaErrorInvalidConfiguration);
    g_blocks[dev][ki] = sms * per_sm;
  }
  const int lg = log2m - 4 < 5 ? log2m - 4 : 5;
  Args p{static_cast<const int32_t*>(succ),
         static_cast<const int32_t*>(order),
         static_cast<const int64_t*>(bounds),
         static_cast<const longlong2*>(span),
         n,
         static_cast<const uint4*>(in),
         static_cast<uint4*>(a),
         static_cast<uint4*>(b),
         static_cast<const uint8_t*>(fin),
         static_cast<uint8_t*>(fa),
         static_cast<uint8_t*>(fb),
         static_cast<double*>(cur),
         static_cast<const double*>(w),
         static_cast<double*>(sod),
         static_cast<double*>(soi),
         static_cast<double*>(disc),
         static_cast<const double*>(factors),
         nd,
         alpha_mm,
         static_cast<u64>(mod0),
         nf0,
         thr,
         sys_thr,
         systolic,
         it0,
         cap,
         static_cast<u64*>(stat)};
  // at most SMs x occupancy blocks; fewer where the graph cannot fill them
  // (4 slots a node), so a small graph's barrier waits on fewer blocks
  const int64_t want = (n * (1 << lg) * 4 + THREADS - 1) / THREADS;
  const unsigned blocks = static_cast<unsigned>(
      want < 1 ? 1 : (want < g_blocks[dev][ki] ? want : g_blocks[dev][ki]));
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args, 0,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch is not blamed
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Most blocks a launch of hll_pull at log2m takes on the current device (0
// before the first launch at that log2m, or for a log2m it does not take).
extern "C" int wgt_hll_pull_blocks(int log2m) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || log2m < LOG2M_MIN || log2m > LOG2M_MAX) return 0;
  return g_blocks[dev][log2m - LOG2M_MIN];
}
