// K1: the BVGraph bulk decode for Hopper (sm_90a), record-parallel,
// straight into CSR, and the K0 probe kernel.
//
// Replaces webgraph_tpu/pallas/decode2.py::build_kernel2 (:617, launched
// by _compiled2 through pl.pallas_call at :1452), the route of
// decode_to_csr_auto for graphs whose reference chains reach back a bounded
// distance (decode2.supports).  The TPU kernel gives each of 1,024 lanes a
// planned node range, primed with the range's ancestor overlap, and has the
// lane decode its records one after another into its row of a slab that the
// host then gathers into CSR.  That layout served Mosaic's row-local
// gathers; on this card it left 1,024 threads on 8 of 132 SMs, each a chain
// of dependent code reads, and no lane could go below the longest record.
// Here the lanes, the ancestor overlap and the slab are gone.  The graph is
// decoded as K2 decodes it (decode.cu), in the depth plan of
// kernels/levels.py::plan_levels, by two kernels:
//
// k1_parse: every record, in one launch of 1,024-thread blocks, straight
//   into CSR positions.  The first `nlong` blocks take the long records
//   (those listed in `longv`: outdegree >= long_arcs at plan time), a block
//   each; the other blocks take every record not listed, a thread each
//   (wgt::parse_record, records.cuh, shared with k2_parse), so every record
//   is parsed whatever the list holds.  Each writes its block ends to
//   bend[bstart[x] ..) and its extras (interval runs merged with residuals)
//   to ext[offsets[x] ..), or straight to succ at depth 0, and sets the
//   ready flag k2_resolve waits on.  In a long-record block one thread reads
//   the header (wgt::parse_head) and the intervals into shared memory; then
//   the residual section is decoded in 8,192-bit tiles staged in shared
//   memory with a 64-bit tail, so that a code may cross the tile's end:
//   (a) the code length at every bit position of the tile (K0's readers,
//   length 65 invalid), a thread per 8 positions; (b) the code starts by
//   doubling: J0(i) = i + len(i), S0 = {0}, S_r+1 = S_r u J_r(S_r),
//   J_r+1 = J_r o J_r, until J_r(0) leaves the tile, so that S holds every
//   code start of the tile (at most 13 rounds) and a start's index is its
//   rank in S (a block prefix count); the chain's exit is the next tile's
//   first start, and only an invalid length on the chain within the
//   record's residual count is an error; (c) the values by a block prefix
//   sum of the gaps, carried from tile to tile; (d) each residual goes to
//   its index plus the interval values below it (a binary search over the
//   intervals), and each interval run to its index plus the residuals below
//   its left end (counted per interval), so the merge is by rank, with no
//   serial step.  A residual inside an interval run fails the node, as in
//   the serial merge.  A long record of more than MAX_IV intervals is merged
//   by the block's first thread alone.
//   Bound: the short records, ~10 codes of dependent bit reads a thread
//   over 325,000 threads, about 1.2 waves of the card; a long record's
//   tiles (a block of 256 threads took ~60 us a tile on a hub, 1,024 take
//   ~15).  Bytes (the stream in, the extras out) are a fraction of either.
//
// k2_resolve (decode.cu, its own C entry point wgt_k2_resolve): the copies,
//   one persistent launch, a warp a node in depth order, as on K2's route.
//   K1's chains are short (3 links on cnr-2000's maxref 3), so a launch per
//   chain depth with no tickets or flags was built first; it measured no
//   faster than k2_resolve on the K1 cell (PERF.md, PR 4), and one resolve
//   kernel now serves both routes.
//
// Every error goes to a per-node array that the wrapper checks once after
// the launches.  Every C entry point returns cudaGetLastError() after its
// launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "records.cuh"

namespace {

using wgt::ERR_CODE;
using wgt::ERR_COUNT;
using wgt::FAILED;
using wgt::FULL;
using wgt::NOT_READY;
using wgt::READY;

constexpr int THREADS = 128;         // the probe
constexpr int PARSE_THREADS = 1024;  // k1_parse: a record a thread, or a block
constexpr int PARSE_WARPS = PARSE_THREADS / 32;
constexpr int TILE = 8192;           // bits of a long record's tile
constexpr int POS = TILE / PARSE_THREADS;  // tile positions a thread: 8
constexpr uint32_t POS_MASK = POS == 32 ? 0xffffffffu : (1u << POS) - 1u;
constexpr int TILE_WORDS = TILE / 64 + 3;  // staged: the tile, the tail, a shift
constexpr int MAX_IV = 512;          // intervals of a long record in shared memory

static_assert(32 % POS == 0 && TILE == POS * PARSE_THREADS,
              "a thread's positions lie in one 32-bit word of S");

// A long-record block's shared memory (41 KB).
struct LongShared {
  int16_t jmp[2][TILE];         // J_r and J_r+1: a position in or past the tile, -1 invalid
  uint32_t start[TILE / 32];    // S: the code starts found, bit i of word i / 32
  uint64_t w[TILE_WORDS];       // the tile's stream words
  int32_t ivl[MAX_IV];          // interval left ends
  int32_t ivc[MAX_IV + 1];      // interval values before each interval
  int32_t ivn[MAX_IV];          // residuals below each interval's left end
  int64_t wsum[PARSE_WARPS];    // block scan
  int64_t x, j, base, extras, icnt, iarcs, rc, pos;
  int32_t* dst;
  int e, serial, code_err, clash, depth0, skip;
};

// A record's error, and its ready flag: set at depth 0, NOT_READY deeper,
// for k2_resolve.
__device__ __forceinline__ void finish(int32_t* __restrict__ err, int32_t* __restrict__ flags,
                                       int64_t j, int64_t x, bool depth0, int e) {
  err[j] = e;
  flags[x] = depth0 ? (e ? FAILED : READY) : NOT_READY;
}

// Exclusive prefix sum over the block of one int64 a thread, and the total.
// Every thread of the block must call it.
__device__ int64_t block_excl_scan(int64_t v, int64_t* wsum, int64_t& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int64_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  int64_t pre = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < PARSE_WARPS; ++k) {
    const int64_t s = wsum[k];
    if (k < w) pre += s;
    total += s;
  }
  __syncthreads();
  return pre + inc - v;
}

// Thread t's bits of S: positions t * POS .. t * POS + POS - 1.
__device__ __forceinline__ uint32_t own_starts(const LongShared& s, int t) {
  const int b = t * POS;
  return (s.start[b >> 5] >> (b & 31)) & POS_MASK;
}

// The residual code at tile position i (stream bit t0 + i, the staged words
// start at bit t0 - sh).
__device__ __forceinline__ uint32_t tile_code(const LongShared& s, int sh, int i,
                                              const wgt::Codings& c, int& len) {
  const int o = sh + i;
  const int wi = o >> 6, b = o & 63;
  const uint64_t x = b ? (s.w[wi] << b) | (s.w[wi + 1] >> (64 - b)) : s.w[wi];
  return wgt::read_code(x, c.res, c.k, len);
}

// Record order[longv[blockIdx.x]] by the whole block.
__device__ void parse_long(LongShared& s, const uint64_t* __restrict__ words,
                           int64_t nbits, const int64_t* __restrict__ bo,
                           const int64_t* __restrict__ off, const int32_t* __restrict__ order,
                           const int64_t* __restrict__ bstart, int64_t n, int64_t b1,
                           const int32_t* __restrict__ longv, const wgt::Codings& c,
                           int32_t* ext, int32_t* __restrict__ bend,
                           int32_t* __restrict__ rank, int32_t* __restrict__ pref,
                           int32_t* __restrict__ nex, int32_t* __restrict__ flags,
                           int32_t* succ, int32_t* __restrict__ err) {
  const int t = threadIdx.x;
  if (t == 0) s.skip = longv[blockIdx.x] < 0 || longv[blockIdx.x] >= n;
  __syncthreads();
  if (s.skip) return;  // a position past order: no record of its own
  if (t == 0) {
    const int64_t j = longv[blockIdx.x];
    const int64_t x = order[j];
    const bool depth0 = j < b1;
    rank[x] = static_cast<int32_t>(j);
    wgt::BufReader rd;
    rd.init(words, nbits, bo[x]);
    wgt::Head h = {};
    int e = rd.err;
    if (!e) e = wgt::parse_head(rd, c, x, depth0, off, bstart, bend, h);
    pref[x] = h.ref;
    nex[x] = static_cast<int32_t>(h.extras);
    int32_t* const dst = depth0 ? succ : ext;
    s.serial = 0;
    if (!e && h.extras > 0 && h.icnt > MAX_IV) {
      e = wgt::merge_serial(rd, c, x, h, dst);
      s.serial = 1;
    } else if (!e && h.extras > 0) {
      // the intervals, read again (their codes were checked by the head)
      wgt::BufReader iv = h.iv;
      int64_t prev = 0, cum = 0;
      for (int64_t k = 0; k < h.icnt; ++k) {
        const int64_t v = iv.read(wgt::GAMMA, c.k);
        const int64_t left = k == 0 ? x + wgt::nat2int(static_cast<uint32_t>(v))
                                    : prev + 1 + v;
        const int64_t len = iv.read(wgt::GAMMA, c.k) + c.minint;
        s.ivl[k] = static_cast<int32_t>(left);
        s.ivc[k] = static_cast<int32_t>(cum);
        s.ivn[k] = 0;
        cum += len;
        prev = left + len;
      }
      s.ivc[h.icnt] = static_cast<int32_t>(cum);
    }
    s.x = x;
    s.j = j;
    s.base = h.base;
    s.extras = h.extras;
    s.icnt = h.icnt;
    s.iarcs = h.iarcs;
    s.rc = h.extras - h.iarcs;
    s.pos = (rd.i << 6) + rd.s;
    s.dst = dst;
    s.e = e;
    s.code_err = s.clash = 0;
    s.depth0 = depth0;
  }
  __syncthreads();
  if (s.e || s.serial || s.extras == 0) {
    if (t == 0) finish(err, flags, s.j, s.x, s.depth0, s.e);
    return;
  }
  const int64_t x = s.x, base = s.base, rc = s.rc, icnt = s.icnt;
  int32_t* const dst = s.dst;
  const int64_t wlast = nbits / 64 + 1;  // the last pad word
  int64_t t0 = s.pos, got = 0, carry = 0;
  while (got < rc) {
    // (a) code lengths at every position of the tile
    const int64_t w0 = t0 >> 6;
    const int sh = static_cast<int>(t0 & 63);
    for (int k = t; k < TILE_WORDS; k += PARSE_THREADS)
      s.w[k] = w0 + k <= wlast ? words[w0 + k] : 0;
    if (t < TILE / 32) s.start[t] = t == 0 ? 1u : 0u;
    __syncthreads();
    uint32_t badw = 0;  // this thread's positions whose code is invalid
    for (int q = 0; q < POS; ++q) {
      const int i = t * POS + q;
      const int64_t a = t0 + i;
      int jv = -1;
      if (a < nbits) {
        int len;
        tile_code(s, sh, i, c, len);
        if (len <= 64 && a + len <= nbits) jv = i + len;
      }
      if (jv < 0) badw |= 1u << q;
      s.jmp[0][i] = static_cast<int16_t>(jv);
    }
    __syncthreads();

    // (b) the code starts of the chain from position 0, by doubling
    int cur = 0;
    for (;;) {
      const int e0 = s.jmp[cur][0];
      if (e0 < 0 || e0 >= TILE) break;
      for (uint32_t sw = own_starts(s, t); sw; sw &= sw - 1) {
        const int tg = s.jmp[cur][t * POS + __ffs(sw) - 1];
        if (tg >= 0 && tg < TILE) atomicOr(&s.start[tg >> 5], 1u << (tg & 31));
      }
      for (int q = 0; q < POS; ++q) {
        const int i = t * POS + q;
        const int v = s.jmp[cur][i];
        s.jmp[cur ^ 1][i] = v >= 0 && v < TILE ? s.jmp[cur][v] : static_cast<int16_t>(v);
      }
      __syncthreads();
      cur ^= 1;
    }
    const int leave = s.jmp[cur][0];

    // (c) each start's index, and the gaps' prefix sum: the first residual
    // is x + nat2int(v), later ones prev + 1 + v
    const uint32_t sw = own_starts(s, t);
    int64_t found;
    const int64_t pre = block_excl_scan(__popc(sw), s.wsum, found);
    const int64_t need = rc - got;
    int64_t gsum = 0, k = pre;
    for (uint32_t m = sw; m && k < need; m &= m - 1, ++k) {
      const int q = __ffs(m) - 1;
      if ((badw >> q) & 1) {
        s.code_err = 1;
        break;
      }
      int len;
      const uint32_t v = tile_code(s, sh, t * POS + q, c, len);
      gsum += got + k == 0 ? x + wgt::nat2int(v) : static_cast<int64_t>(v) + 1;
    }
    int64_t gtotal;
    int64_t val = carry + block_excl_scan(gsum, s.wsum, gtotal);

    // (d) each residual at its index plus the interval values below it
    k = pre;
    for (uint32_t m = sw; m && k < need; m &= m - 1, ++k) {
      const int q = __ffs(m) - 1;
      if ((badw >> q) & 1) break;
      int len;
      const uint32_t v = tile_code(s, sh, t * POS + q, c, len);
      val += got + k == 0 ? x + wgt::nat2int(v) : static_cast<int64_t>(v) + 1;
      int64_t lo = 0, hi = icnt;  // first interval whose left end is past val
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (s.ivl[mid] <= val) lo = mid + 1; else hi = mid;
      }
      if (lo > 0 && val < static_cast<int64_t>(s.ivl[lo - 1]) + (s.ivc[lo] - s.ivc[lo - 1]))
        s.clash = 1;
      dst[base + got + k + s.ivc[lo]] = static_cast<int32_t>(val);
      if (lo < icnt) atomicAdd(&s.ivn[lo], 1);
    }
    got += found < need ? found : need;
    carry += gtotal;
    __syncthreads();
    if (s.code_err) break;
    t0 += leave;  // >= TILE here: an invalid end was a taken start
  }

  // the interval runs: value q of them at q plus the residuals below its run
  if (!s.code_err && icnt > 0) {
    if (t == 0)
      for (int64_t k = 1; k < icnt; ++k) s.ivn[k] += s.ivn[k - 1];
    __syncthreads();
    for (int64_t q = t; q < s.iarcs; q += PARSE_THREADS) {
      int64_t lo = 0, hi = icnt - 1;  // last interval starting at or before q
      while (lo < hi) {
        const int64_t mid = (lo + hi + 1) >> 1;
        if (s.ivc[mid] <= q) lo = mid; else hi = mid - 1;
      }
      dst[base + q + s.ivn[lo]] = static_cast<int32_t>(s.ivl[lo] + (q - s.ivc[lo]));
    }
  }
  if (t == 0)
    finish(err, flags, s.j, x, s.depth0, s.code_err ? ERR_CODE : s.clash ? ERR_COUNT : 0);
}

// Every record: the first nlong blocks take the records at the positions
// longv lists (ascending), a block each; the rest take order[j] for every
// other j, a thread each.  `succ` may be `ext` (the parse alone, as
// parse_records_plain lays it out).
__global__ void __launch_bounds__(PARSE_THREADS)
k1_parse(const uint64_t* __restrict__ words, int64_t nbits,
         const int64_t* __restrict__ bo, const int64_t* __restrict__ off,
         const int32_t* __restrict__ order, const int64_t* __restrict__ bstart,
         int64_t n, int64_t b1, const int32_t* __restrict__ longv, int64_t nlong,
         wgt::Codings c, int32_t* ext, int32_t* __restrict__ bend,
         int32_t* __restrict__ rank, int32_t* __restrict__ pref,
         int32_t* __restrict__ nex, int32_t* __restrict__ flags, int32_t* succ,
         int32_t* __restrict__ err) {
  __shared__ LongShared s;
  if (blockIdx.x < nlong) {
    parse_long(s, words, nbits, bo, off, order, bstart, n, b1, longv, c, ext, bend, rank,
               pref, nex, flags, succ, err);
    return;
  }
  const int64_t j =
      static_cast<int64_t>(blockIdx.x - nlong) * PARSE_THREADS + threadIdx.x;
  if (j >= n) return;
  const int64_t at = wgt::lower_bound(longv, nlong, static_cast<int32_t>(j));
  if (at < nlong && longv[at] == j) return;  // a block takes it
  const int64_t x = order[j];
  const bool depth0 = j < b1;
  rank[x] = static_cast<int32_t>(j);
  wgt::BufReader rd;
  rd.init(words, nbits, bo[x]);
  int32_t r = 0, ne = 0;
  const int e = rd.err ? rd.err
                       : wgt::parse_record(rd, c, x, depth0, off, bstart, bend,
                                           depth0 ? succ : ext, r, ne);
  pref[x] = r;
  nex[x] = ne;
  finish(err, flags, j, x, depth0, e);
}

// K0 probe: one code of one coding at each bit position.  coding -1 reads a
// minimal binary code in the universe b[i].
__global__ void k0_probe(const uint64_t* __restrict__ words, int64_t nbits,
                         const int64_t* __restrict__ pos,
                         const int64_t* __restrict__ b, int n, int coding, int k,
                         int64_t* __restrict__ val, int32_t* __restrict__ len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t p = pos[i];
  if (p < 0 || p >= nbits) {
    val[i] = 0;
    len[i] = wgt::BAD_LEN;
    return;
  }
  const uint64_t x = wgt::window64(words, p);
  int ln;
  const uint32_t v = coding == -1
                         ? wgt::read_minimal_binary(x, static_cast<uint32_t>(b[i]), ln)
                         : wgt::read_code(x, coding, k, ln);
  val[i] = static_cast<int64_t>(v);
  len[i] = ln;
}

}  // namespace

extern "C" int wgt_k0_probe(const void* words, int64_t nbits, const void* pos,
                            const void* b, int n, int coding, int k, void* val,
                            void* len, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  k0_probe<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(words), nbits, static_cast<const int64_t*>(pos),
      static_cast<const int64_t*>(b), n, coding, k, static_cast<int64_t*>(val),
      static_cast<int32_t*>(len));
  return static_cast<int>(cudaGetLastError());
}

// k1_parse over all n records (the nlong listed in longv, as ascending
// positions in order, a block each); order[0 .. b1) is depth 0, whose lists
// go straight to succ.  With succ == ext it is the parse alone.  K1's decode
// then launches k2_resolve through decode.cu's wgt_k2_resolve.  launched[0]
// gets the launches of k1_parse.
extern "C" int wgt_k1_parse(const void* words, int64_t nbits, const void* bo,
                            const void* off, const void* order, const void* bstart,
                            int64_t n, int64_t b1, const void* longv, int64_t nlong,
                            int outd, int ref, int bcnt, int blk, int res, int zeta_k,
                            int window, int minint, void* ext, void* bend, void* rank,
                            void* pref, void* nex, void* flags, void* succ, void* err,
                            int* launched, void* stream) {
  const wgt::Codings c{outd, ref, bcnt, blk, res, zeta_k, window, minint};
  launched[0] = 0;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto o32 = [](void* p) { return static_cast<int32_t*>(p); };
  const int64_t blocks = nlong + (n + PARSE_THREADS - 1) / PARSE_THREADS;
  k1_parse<<<static_cast<unsigned>(blocks), PARSE_THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(words), nbits, i64(bo), i64(off), i32(order),
      i64(bstart), n, b1, i32(longv), nlong, c, o32(ext), o32(bend), o32(rank),
      o32(pref), o32(nex), o32(flags), o32(succ), o32(err));
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) launched[0] = 1;
  return static_cast<int>(e);
}
