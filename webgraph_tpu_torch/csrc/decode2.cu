// K1: the streaming lane-range BVGraph decode kernel for Hopper (sm_90a),
// and the K0 probe kernel.
//
// Replaces webgraph_tpu/pallas/decode2.py::build_kernel2 (launched by
// _compiled2).  One thread per lane, 128 threads a block.  Each lane decodes
// up to two planned node ranges, A then B, each primed with its ancestor
// overlap and the outdegrees of the 7 nodes before it (kernels/decode2.py
// plans them).  For every node the thread parses the record (outdegree,
// reference, copy blocks, intervals; BVGraph record layout) and then writes
// the successor list to its own slab row as the 3-way merge of the parent's
// copied arcs, the interval runs and the gap-coded residuals.  The parent's
// list is read back from the thread's own row.  Copy blocks and intervals
// are read twice, once to count and once to merge, from cursors saved by
// the parse, so the thread needs no side buffer.
//
// What bounds it: a dependent chain of bit extracts per lane, not bytes.
// At cnr-2000 scale the stream is ~1.4 MB in and the slab ~13 MB out, far
// below what the card moves in the kernel's time; the longest lane (the
// largest ancestor closure, decoded in order by one thread) sets the time.
// The TPU kernel's register windows, queues, append groups, staging ring
// and flush bands existed to feed Mosaic's row-local gathers and are gone:
// a thread rebuilds its 64-bit window from two stream words per code.
//
// Every C entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "pcodes.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ERR_SLAB = 2;   // the lane's slab row is full

__global__ void __launch_bounds__(THREADS)
k1_decode2(const uint64_t* __restrict__ words, int64_t nbits,
           const int64_t* __restrict__ bo, const int32_t* __restrict__ gid0v,
           const int32_t* __restrict__ gid0bv, const int32_t* __restrict__ cntv,
           const int32_t* __restrict__ cntav, const int32_t* __restrict__ d7,
           const int32_t* __restrict__ d7b, int lanes, int64_t slabw, wgt::Codings c,
           int32_t* __restrict__ slab, int32_t* __restrict__ wp_out,
           int32_t* __restrict__ err_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int32_t* __restrict__ row = slab + static_cast<int64_t>(lane) * slabw;
  wgt::Reader rd{words, nbits, 0};
  const int64_t INF = INT64_MAX;

  const int cnt = cntv[lane];
  const int cnta = cntav[lane];
  int64_t gid = gid0v[lane];
  int64_t cur = 0;
  int64_t wp = 0;
  // outdegree and list start of the nodes gid-1 .. gid-7
  int64_t dring[7], fring[7];

  for (int loc = 0; loc < cnt && !rd.err; ++loc) {
    if (loc == 0 || loc == cnta) {
      // range start: A at loc 0, B at loc cnta.  Parents before the range
      // get list starts that make their copies read as junk (see below).
      const bool b = loc == cnta;
      const int32_t* dsrc = b ? d7b : d7;
      if (b) gid = gid0bv[lane];
      cur = bo[gid];
      for (int j = 0; j < 7; ++j) {
        dring[j] = dsrc[j * lanes + lane];
        fring[j] = b ? wp : 0;
      }
    }
    const int64_t base = wp;
    const int64_t d = rd.read(cur, c.outd, c.k);
    if (d > 0) {
      // ---- parse: reference, copy blocks, intervals ----------------------
      int64_t r = 0, dp = 0, pb = 0, bc = 0, copied = 0, bpos0 = 0;
      if (c.window > 0) {
        r = rd.read(cur, c.ref, c.k);
        if (r > 0) {
          if (r > c.window || r > 7) { rd.err = wgt::ERR_REF; break; }
          dp = dring[r - 1];
          pb = fring[r - 1];
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
      if (rd.err) break;

      // ---- merge ---------------------------------------------------------
      // copy runs [cp, cend) of the parent's list: even blocks, then with an
      // even block count the tail up to the parent's outdegree
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
            rd.err = wgt::ERR_COUNT;
          }
        }
        if (irem == 0 && ileft > 0) {
          const int64_t v = rd.read(ipos, wgt::GAMMA, c.k);
          ival = ifirst ? gid + wgt::nat2int(static_cast<uint32_t>(v))
                        : iprev + 1 + v;
          ifirst = false;
          irem = rd.read(ipos, wgt::GAMMA, c.k) + c.minint;
          iprev = ival + irem;
          --ileft;
        }
        if (!rvok && rleft > 0) {
          const int64_t v = rd.read(cur, c.res, c.k);
          rv = rfirst ? gid + wgt::nat2int(static_cast<uint32_t>(v)) : rv + 1 + v;
          rfirst = false;
          rvok = true;
          --rleft;
        }
        if (rd.err) break;
        // a copy position at or past this node's start belongs to a parent
        // before the lane's range: such a node is never used, read 0
        int64_t ch = INF;
        if (crem > 0) {
          const int64_t q = pb + cp;
          ch = q < base ? row[q] : 0;
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
        if (val == INF) { rd.err = wgt::ERR_COUNT; break; }
        if (wp >= slabw) { rd.err = ERR_SLAB; break; }
        row[wp++] = static_cast<int32_t>(val);
      }
    }
    for (int j = 6; j > 0; --j) {
      dring[j] = dring[j - 1];
      fring[j] = fring[j - 1];
    }
    dring[0] = d;
    fring[0] = base;
    ++gid;
  }
  wp_out[lane] = static_cast<int32_t>(wp);
  err_out[lane] = rd.err;
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

extern "C" int wgt_k1_decode2(const void* words, int64_t nbits, const void* bo,
                              const void* gid0, const void* gid0b, const void* cnt,
                              const void* cnta, const void* d7, const void* d7b,
                              int lanes, int64_t slabw, int outd, int ref, int bcnt,
                              int blk, int res, int zeta_k, int window, int minint,
                              void* slab, void* wp, void* err, void* stream) {
  const wgt::Codings c{outd, ref, bcnt, blk, res, zeta_k, window, minint};
  const int blocks = (lanes + THREADS - 1) / THREADS;
  k1_decode2<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(words), nbits, static_cast<const int64_t*>(bo),
      static_cast<const int32_t*>(gid0), static_cast<const int32_t*>(gid0b),
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(cnta),
      static_cast<const int32_t*>(d7), static_cast<const int32_t*>(d7b), lanes, slabw,
      c, static_cast<int32_t*>(slab), static_cast<int32_t*>(wp),
      static_cast<int32_t*>(err));
  return static_cast<int>(cudaGetLastError());
}
