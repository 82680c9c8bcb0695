// K2: the long-reference-chain BVGraph decode kernel for Hopper (sm_90a).
//
// Replaces webgraph_tpu/pallas/decode.py::build_kernel (:423, launched by
// _compiled through pl.pallas_call at :1333), the route of
// decode_to_csr_auto for graphs whose reference chains reach back further
// than K1's lanes cover.  The TPU kernel walks 1,024-node blocks in a
// sequential grid, each in four phases (parse, extras, one merge round per
// in-block chain depth, output with a halo of the last `window` lists for
// the next block), through a VMEM pool, a bf16 byte-plane mirror and
// one-hot MXU fetches and compaction.  All of that serves Mosaic and has no
// place here.  What it computes is the CSR of the graph, with each list the
// sorted union of the parent's copied arcs, the interval runs and the
// gap-coded residuals.
//
// Here the nodes are cut by their global chain depth (kernels/decode.py
// plans the levels): depth 0 has no reference, depth k + 1 copies from a
// parent of depth k.  One launch per level, one thread per node of the
// level.  A thread parses its record (outdegree, reference, copy blocks,
// intervals), re-reads blocks and intervals from saved cursors during the
// 3-way merge (the body of K1 in decode2.cu), and writes its list straight
// into the final CSR at offsets[x].  The parent's list is read from
// succ[offsets[p] ..), final since the previous level's launch: launches on
// one stream run in order.  Every parent is final, so K1's rule for copies
// from parents before a lane's range (read 0) has no counterpart; a copy
// past the parent's outdegree is an error.
//
// What bounds it: a dependent chain of bit extracts per node, plus one
// launch per level, not bytes.  The stream, bit offsets and CSR offsets are
// read once and the CSR written once (~22 MB at cnr-2000 size, ~7 us at
// 3.35 TB/s), but a graph stored with unbounded maxref has hundreds to
// thousands of levels, most of them a handful of nodes, so most launches
// keep a few SMs busy and the launch gap adds up.  The design keeps each
// launch short (no per-level host sync; errors go to a per-node array the
// wrapper checks once after the last level) and issues all levels from one
// C loop.  One launch for all levels (a persistent kernel with per-node
// ready flags, or a grid sync per level) is the next step.
//
// Every C entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

#include "pcodes.cuh"

namespace {

constexpr int THREADS = 128;

// Decodes node x's list into succ[base .. base + d); returns an error code.
__device__ int decode_node(wgt::Reader& rd, const wgt::Codings& c, int64_t x,
                           const int64_t* __restrict__ off, int64_t cur,
                           int64_t d, int64_t base, int32_t* __restrict__ succ) {
  const int64_t INF = INT64_MAX;
  // ---- parse: reference, copy blocks, intervals ----------------------------
  int64_t pb = 0, dp = 0, bc = 0, copied = 0, bpos0 = 0;
  if (c.window > 0) {
    const int64_t r = rd.read(cur, c.ref, c.k);
    if (r > 0) {
      if (r > c.window || r > x) return wgt::ERR_REF;
      pb = off[x - r];
      dp = off[x - r + 1] - pb;
      bc = rd.read(cur, c.bcnt, c.k);
      bpos0 = cur;
      int64_t cum = 0;
      for (int64_t k = 0; k < bc && !rd.err; ++k) {
        const int64_t v = rd.read(cur, c.blk, c.k) + (k > 0);
        cum += v;
        if (!(k & 1)) copied += v;
      }
      if (!(bc & 1)) copied += dp > cum ? dp - cum : 0;
    }
  }
  int64_t icnt = 0, ipos = 0, iarcs = 0;
  if (c.minint != 0 && d - copied > 0) {
    icnt = rd.read(cur, wgt::GAMMA, c.k);
    ipos = cur;
    for (int64_t j = 0; j < icnt && !rd.err; ++j) {
      rd.read(cur, wgt::GAMMA, c.k);
      iarcs += rd.read(cur, wgt::GAMMA, c.k) + c.minint;
    }
  }
  if (rd.err) return rd.err;

  // ---- merge -----------------------------------------------------------------
  // copy runs [cp, cend) of the parent's list: even blocks, then with an even
  // block count the tail up to the parent's outdegree
  int64_t crem = copied, cp = 0, cend = 0, mbk = 0, mcum = 0, bpos = bpos0;
  // interval runs [ival, ival + irem)
  int64_t ileft = icnt, ival = 0, irem = 0, iprev = 0;
  bool ifirst = true;
  // residuals, read at the main cursor
  int64_t rleft = d - copied - iarcs, rv = 0;
  bool rvok = false, rfirst = true;
  if (rleft < 0) rleft = 0;

  for (int64_t em = 0; em < d; ++em) {
    while (crem > 0 && cp >= cend && !rd.err) {
      if (mbk < bc) {
        const int64_t v = rd.read(bpos, c.blk, c.k) + (mbk > 0);
        if (!(mbk & 1)) { cp = mcum; cend = mcum + v; }
        mcum += v;
        ++mbk;
      } else if (mbk == bc && !(bc & 1)) {
        cp = mcum;
        cend = dp;
        ++mbk;
      } else {
        return wgt::ERR_COUNT;
      }
    }
    if (irem == 0 && ileft > 0) {
      const int64_t v = rd.read(ipos, wgt::GAMMA, c.k);
      ival = ifirst ? x + wgt::nat2int(static_cast<uint32_t>(v)) : iprev + 1 + v;
      ifirst = false;
      irem = rd.read(ipos, wgt::GAMMA, c.k) + c.minint;
      iprev = ival + irem;
      --ileft;
    }
    if (!rvok && rleft > 0) {
      const int64_t v = rd.read(cur, c.res, c.k);
      rv = rfirst ? x + wgt::nat2int(static_cast<uint32_t>(v)) : rv + 1 + v;
      rfirst = false;
      rvok = true;
      --rleft;
    }
    if (rd.err) return rd.err;
    int64_t ch = INF;
    if (crem > 0) {
      if (cp >= dp) return wgt::ERR_COUNT;
      ch = succ[pb + cp];
    }
    const int64_t ih = irem > 0 ? ival : INF;
    const int64_t rh = rvok ? rv : INF;
    int64_t val;
    if (ch <= ih && ch <= rh) {
      val = ch;
      --crem;
      ++cp;
    } else if (ih <= rh) {
      val = ih;
      --irem;
      ++ival;
    } else {
      val = rh;
      rvok = false;
    }
    if (val == INF) return wgt::ERR_COUNT;
    succ[base + em] = static_cast<int32_t>(val);
  }
  return 0;
}

// One chain-depth level: thread i decodes node nodes[i].
__global__ void __launch_bounds__(THREADS)
k2_level(const uint64_t* __restrict__ words, int64_t nbits,
         const int64_t* __restrict__ bo, const int64_t* __restrict__ off,
         const int32_t* __restrict__ nodes, int count, wgt::Codings c,
         int32_t* __restrict__ succ, int32_t* __restrict__ err_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int64_t x = nodes[i];
  wgt::Reader rd{words, nbits, 0};
  const int64_t base = off[x];
  int64_t cur = bo[x];
  const int64_t d = rd.read(cur, c.outd, c.k);
  int e = rd.err;
  if (!e && d != off[x + 1] - base) e = wgt::ERR_COUNT;
  if (!e && d > 0) e = decode_node(rd, c, x, off, cur, d, base, succ);
  err_out[i] = e;
}

}  // namespace

// Launches k2_level once per non-empty level l, over order[bounds[l] ..
// bounds[l + 1]); `bounds` is a host array of levels + 1 entries.
extern "C" int wgt_k2_decode(const void* words, int64_t nbits, const void* bo,
                             const void* off, const void* order,
                             const int64_t* bounds, int levels, int outd, int ref,
                             int bcnt, int blk, int res, int zeta_k, int window,
                             int minint, void* succ, void* err, void* stream) {
  const wgt::Codings c{outd, ref, bcnt, blk, res, zeta_k, window, minint};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < levels; ++l) {
    const int64_t lo = bounds[l];
    const int count = static_cast<int>(bounds[l + 1] - lo);
    if (count <= 0) continue;
    k2_level<<<(count + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        static_cast<const uint64_t*>(words), nbits, static_cast<const int64_t*>(bo),
        static_cast<const int64_t*>(off), static_cast<const int32_t*>(order) + lo,
        count, c, static_cast<int32_t*>(succ), static_cast<int32_t*>(err) + lo);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
