"""Chain-depth level BVGraph decoder (K2): host planning, the plain PyTorch
decoder and the wrapper of the Hopper kernel.

Counterpart of ``webgraph_tpu/pallas/decode.py``, the route of
``decode_to_csr_auto`` for graphs whose reference chains reach back
further than K1's lanes cover (maxref unbounded, ``decode2.supports``
False).  The TPU kernel walks 1,024-node blocks in a sequential grid and
resolves chains inside a block in rounds, carrying a halo of the last
``window`` lists to the next block.  Here the whole graph is cut by the
global chain depth of the host structure scan instead
(:func:`plan_levels`): depth 0 is every node without a reference, depth
k + 1 every node whose parent has depth k.  Levels are decoded in order,
each straight into the final CSR ``succ`` at the node's offset, so a node
of level k + 1 copies from its parent's final list, which level k wrote.

:func:`decode_levels` launches the kernel of ``csrc/decode.cu`` once per
level for CUDA tensors and takes :func:`decode_levels_plain` for CPU
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.kernels import _build
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels import pcodes as P
from webgraph_tpu_torch.kernels.plan import scan_structure

MAX_WINDOW = 7  # the TPU kernel's halo carries 7 lists; K2 keeps its domain

# per-node error codes, shared with K1 (raised by decode_levels)
ERR_CODE, ERR_REF, ERR_COUNT = D2.ERR_CODE, D2.ERR_REF, D2.ERR_COUNT
_ERR_TEXT = {ERR_CODE: "invalid code", ERR_REF: "reference beyond the window",
             ERR_COUNT: "record counts disagree"}


def supports(g) -> bool:
    """Whether K2 can decode ``g``: window <= 7, and every coding of the
    outdegrees, references, block counts, blocks and residuals has a window
    reader (GAMMA/DELTA/ZETA/UNARY).  The predicate of the JAX package's
    ``decode_to_csr_auto`` for its block-phase kernel."""
    s = g.settings
    return s.window_size <= MAX_WINDOW and all(
        c in (C.GAMMA, C.DELTA, C.ZETA, C.UNARY) for c in (
            s.outdegree_coding, s.reference_coding, s.block_count_coding,
            s.block_coding, s.residual_coding))


# ----------------------------------------------------------------------
# planning
# ----------------------------------------------------------------------


@dataclass
class LevelPlan:
    """Nodes ordered by global chain depth, with each depth's range."""

    order: torch.Tensor    # int32 (n,) node ids, stable-sorted by depth
    bounds: np.ndarray     # int64 (levels + 1,) depth k is order[b[k]:b[k+1]]
    offsets: torch.Tensor  # int64 (n + 1,) CSR offsets, prefix sum of d

    @property
    def levels(self) -> int:
        return len(self.bounds) - 1


def plan_levels(g, scan) -> LevelPlan:
    """The depth levels of ``g`` from its structure scan (CPU tensors).
    Every depth from 0 to the maximum holds a node (a node's parent is one
    level up), so a decode launches ``levels`` times."""
    depth = scan.depth.astype(np.int64)
    order = np.argsort(depth, kind="stable")
    levels = int(depth.max(initial=-1)) + 1
    bounds = np.searchsorted(depth[order], np.arange(levels + 1),
                             side="left").astype(np.int64)
    offsets = np.zeros(g.num_nodes() + 1, dtype=np.int64)
    np.cumsum(scan.d.astype(np.int64), out=offsets[1:])
    return LevelPlan(order=torch.from_numpy(order.astype(np.int32)),
                     bounds=bounds, offsets=torch.from_numpy(offsets))


@dataclass
class LevelPrepared:
    """A graph planned for K2 on one device."""

    device: torch.device
    words: torch.Tensor    # stream words (int64 bit patterns), 2 zero pads
    bo: torch.Tensor       # node bit offsets (int64, n + 1)
    order: torch.Tensor    # int32 (n,)
    bounds: np.ndarray     # int64 (levels + 1,), on the host
    offsets: torch.Tensor  # int64 (n + 1,)
    skey: tuple


def prepare(g, device="cuda", *, scan=None) -> LevelPrepared:
    """Scan (unless ``scan`` is given), plan and move to ``device``
    everything a K2 decode needs."""
    if not supports(g):
        raise NotImplementedError(
            f"K2 does not decode this graph (codings "
            f"{g.settings.flags_string()!r}, window {g.settings.window_size})")
    device = torch.device(device)
    plan = plan_levels(g, scan if scan is not None else scan_structure(g))
    return LevelPrepared(
        device=device,
        words=D2.stream_words(g, device),
        bo=torch.from_numpy(np.asarray(g.bit_offsets, np.int64)).to(device),
        order=plan.order.to(device),
        bounds=plan.bounds,
        offsets=plan.offsets.to(device),
        skey=D2.coding_key(g.settings),
    )


def decode_prepared(prep: LevelPrepared):
    """``(offsets int64[n+1], successors int32[m])`` on the prepared
    device."""
    succ = decode_levels(prep.words, prep.bo, prep.order, prep.bounds,
                         prep.offsets, prep.skey)
    return prep.offsets, succ


def check_errors(err: torch.Tensor, order: torch.Tensor) -> None:
    """Raise if any node reported an error (``err`` is indexed like
    ``order``)."""
    if bool((err != 0).any()):
        bad = torch.nonzero(err).flatten()[:8]
        codes = sorted({int(c) for c in err[bad].tolist()})
        raise RuntimeError(
            f"decode failed at nodes {order[bad].tolist()}: "
            + ", ".join(_ERR_TEXT.get(c, str(c)) for c in codes))


# ----------------------------------------------------------------------
# plain PyTorch decoder
# ----------------------------------------------------------------------


def _segments(counts):
    """(segment id, position in segment) of every slot of ragged segments
    of ``counts`` (int64)."""
    total = int(counts.sum())
    seg = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts,
        output_size=total)
    start = torch.cumsum(counts, 0) - counts
    return seg, torch.arange(total, device=counts.device) - start[seg]


def _seg_cumsum(vals, seg, counts):
    """Inclusive cumulative sums of ``vals`` inside each segment."""
    c = torch.cumsum(vals, 0)
    before = torch.cumsum(counts, 0) - counts  # first slot of each segment
    base = torch.where(before > 0, c[(before - 1).clamp(min=0)],
                       torch.zeros_like(before)) if c.numel() else before
    return c - base[seg]


def decode_levels_plain(words, bo, order, bounds, offsets, skey):
    """Plain version of :func:`decode_levels`.  Returns ``(succ, err)``,
    ``err`` int32 indexed like ``order`` (0 where the node decoded).

    Every record is parsed at once, vectorised over all nodes, one code
    index per step (outdegree, reference, block count, blocks, intervals,
    residuals): those parts do not depend on other lists.  Then the levels
    are resolved in order: a level's nodes take their parents' final lists
    from ``succ``, keep the copy blocks (even blocks, and the tail when the
    block count is even), join them with their intervals and residuals and
    write the sorted union at their offsets."""
    outd_c, ref_c, bcnt_c, blk_c, res_c, zk, window, minint = skey
    dev = words.device
    n = bo.numel() - 1
    m = int(offsets[-1])
    nbits = (words.numel() - 2) * 64
    w32 = P.split_words(words)
    readers = {cd: P.make_window_reader(cd, zk)
               for cd in {outd_c, ref_c, bcnt_c, blk_c, C.GAMMA, res_c}}
    i64 = dict(dtype=torch.int64, device=dev)
    x = torch.arange(n, **i64)
    err = torch.zeros(n, **i64)

    def flag(idx, bad, code):
        i = idx[bad]
        err[i] = torch.where(err[i] == 0, code, err[i])

    def read(idx, pos, coding):
        """One code at each cursor; flags bad codes on nodes ``idx``."""
        hi, lo = P.window_at(w32, pos.clamp(0, nbits))
        v, ln = readers[coding](hi, lo)
        flag(idx, (ln > 64) | (pos + ln > nbits), ERR_CODE)
        return v, pos + ln

    def lockstep(idx, pos, counts, coding, per=1):
        """Read ``per`` codes for each of ``counts[i]`` items of node
        ``idx[i]``, item k of every node in step k.  Returns the codes
        (``per`` flat arrays in node-major item order) and the cursors."""
        out = [torch.zeros(int(counts.sum()), **i64) for _ in range(per)]
        if not out[0].numel():
            return out, pos
        start = torch.cumsum(counts, 0) - counts
        by = torch.argsort(-counts, stable=True)
        cs = counts[by]
        pos = pos.clone()
        for k in range(int(cs[0])):
            a = by[: int((cs > k).sum())]
            for j in range(per):
                v, pos[a] = read(idx[a], pos[a], coding)
                out[j][start[a] + k] = v
        return out, pos

    d, pos = read(x, bo[:n], outd_c)
    dx = offsets[1:] - offsets[:-1]
    flag(x, d != dx, ERR_COUNT)
    ref = torch.zeros(n, **i64)
    if window > 0:
        idx = torch.nonzero(d > 0).flatten()
        ref[idx], pos[idx] = read(idx, pos[idx], ref_c)
    hasr = ref > 0
    flag(x, hasr & ((ref > window) | (ref > x)), ERR_REF)
    parent = torch.where(hasr, (x - ref).clamp(min=0), x)
    dp = torch.where(hasr, dx[parent].clamp(min=0), 0)

    # copy blocks: the first as is, later ones + 1; even blocks copy
    ridx = torch.nonzero(hasr).flatten()
    bc = torch.zeros(n, **i64)
    bc[ridx], pos[ridx] = read(ridx, pos[ridx], bcnt_c)
    (blk,), pos[ridx] = lockstep(ridx, pos[ridx], bc[ridx], blk_c)
    bseg, bk = _segments(bc[ridx])
    blk = blk + (bk > 0)
    bnode = ridx[bseg]
    # each block's end in its parent's list, and each node's first block
    bends = _seg_cumsum(blk, bseg, bc[ridx])
    bfirst = torch.zeros(n, **i64)
    bfirst[ridx] = torch.cumsum(bc[ridx], 0) - bc[ridx]
    cum = torch.zeros(n, **i64).index_add_(0, bnode, blk)
    copied = torch.zeros(n, **i64).index_add_(0, bnode, blk * (bk % 2 == 0))
    copied += torch.where(hasr & (bc % 2 == 0), (dp - cum).clamp(min=0), 0)
    extra = torch.where(d > 0, d - copied, 0)

    # intervals: first left = x + nat2int(v), later prev end + 1 + v
    ivals = torch.zeros(0, **i64)
    inode = torch.zeros(0, **i64)
    iarcs = torch.zeros(n, **i64)
    if minint != 0:
        eidx = torch.nonzero(extra > 0).flatten()
        icnt = torch.zeros(n, **i64)
        icnt[eidx], pos[eidx] = read(eidx, pos[eidx], C.GAMMA)
        (lcode, lncode), pos[eidx] = lockstep(eidx, pos[eidx], icnt[eidx],
                                              C.GAMMA, per=2)
        iseg, ik = _segments(icnt[eidx])
        ilen = lncode + minint
        prev_len = torch.cat([torch.zeros(1, **i64), ilen[:-1]])
        gap = torch.where(ik == 0, eidx[iseg] + P.nat2int_u(lcode),
                          prev_len + 1 + lcode)
        left = _seg_cumsum(gap, iseg, icnt[eidx])
        iarcs.index_add_(0, eidx[iseg], ilen)
        aseg, ak = _segments(ilen)
        ivals = left[aseg] + ak
        inode = eidx[iseg][aseg]

    # residuals: first x + nat2int(v), later prev + 1 + v
    rc = (extra - iarcs).clamp(min=0)
    cidx = torch.nonzero(rc > 0).flatten()
    (rcode,), _ = lockstep(cidx, pos[cidx], rc[cidx], res_c)
    rseg, rk = _segments(rc[cidx])
    rgap = torch.where(rk == 0, cidx[rseg] + P.nat2int_u(rcode), rcode + 1)
    rvals = _seg_cumsum(rgap, rseg, rc[cidx])
    rnode = cidx[rseg]

    # every node's extras (intervals and residuals), sorted by (node, value)
    enode = torch.cat([inode, rnode])
    evals = torch.cat([ivals, rvals])
    _, perm = torch.sort(enode * (1 << 33) + (evals + (1 << 32)))
    enode, evals = enode[perm], evals[perm]
    ecnt = torch.bincount(enode, minlength=n)
    estart = torch.cumsum(ecnt, 0) - ecnt

    # level by level: copies from final parent lists, joined with extras
    succ = torch.zeros(m, dtype=torch.int32, device=dev)
    for lvl in range(len(bounds) - 1):
        nodes = order[int(bounds[lvl]):int(bounds[lvl + 1])].long()
        k = nodes.numel()
        # extras of the level's nodes, as (rank in level, value)
        sseg, sk = _segments(ecnt[nodes])
        vals = [evals[estart[nodes][sseg] + sk]]
        segs = [sseg]
        if lvl > 0:
            # the parent's list, masked by the block boundaries: a slot is
            # kept when an even number of boundaries lie at or before it
            ndp = dp[nodes]
            cseg, cj = _segments(ndp)
            pseg, pk = _segments(bc[nodes])
            ends = bends[bfirst[nodes][pseg] + pk]
            cstart = torch.cumsum(ndp, 0) - ndp
            inside = ends < ndp[pseg]
            tog = torch.zeros(cseg.numel(), **i64).index_add_(
                0, (cstart[pseg] + ends)[inside],
                torch.ones(int(inside.sum()), **i64))
            par = _seg_cumsum(tog, cseg, ndp)
            keep = par % 2 == 0
            src = offsets[parent[nodes]][cseg] + cj
            vals.append(succ[src[keep]].long())
            segs.append(cseg[keep])
        seg = torch.cat(segs)
        val = torch.cat(vals)
        cnt = torch.bincount(seg, minlength=k)
        ok = cnt == dx[nodes]
        flag(nodes, ~ok, ERR_COUNT)
        _, perm = torch.sort(seg * (1 << 33) + (val + (1 << 32)))
        seg, val = seg[perm], val[perm]
        sel = ok[seg]
        first = torch.cumsum(cnt, 0) - cnt
        dst = offsets[nodes][seg] + (torch.arange(seg.numel(), device=dev)
                                     - first[seg])
        succ[dst[sel]] = val[sel].to(torch.int32)
    return succ, err[order.long()].to(torch.int32)


# ----------------------------------------------------------------------
# kernel wrapper
# ----------------------------------------------------------------------


def decode_levels(words, bo, order, bounds, offsets, skey):
    """Decode every node into CSR, level by level: returns the int32
    successors ``succ[offsets[x]:offsets[x+1]]`` of every node ``x``.
    Raises if a node reports an error.

    ``words``: int64 stream words from ``decode2.stream_words``; ``bo``:
    int64 bit offsets of the graph's nodes (n + 1); ``order``: int32 node
    ids by depth; ``bounds``: host int64 level bounds into ``order``;
    ``offsets``: int64 CSR offsets (n + 1); ``skey``: ``decode2.coding_key``.

    CPU tensors take :func:`decode_levels_plain`; CUDA tensors launch the
    K2 kernel of ``csrc/decode.cu`` once per level, on one stream, and are
    checked once after the last level."""
    dev = words.device
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    if dev.type == "cpu":
        succ, err = decode_levels_plain(words, bo, order, bounds, offsets,
                                        skey)
        check_errors(err, order)
        return succ
    if dev.type != "cuda":
        raise ValueError(f"decode_levels: unsupported device {dev}")
    for c in skey[:5]:
        P.make_window_reader(c, skey[5])  # rejects GOLOMB / NIBBLE
    if skey[6] > MAX_WINDOW:
        raise ValueError(f"decode_levels supports window_size <= {MAX_WINDOW}")
    n = order.numel()

    def need(name, t, dtype, shape):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"decode_levels: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {dev}")

    need("words", words, torch.int64, (words.numel(),))
    need("bo", bo, torch.int64, (n + 1,))
    need("order", order, torch.int32, (n,))
    need("offsets", offsets, torch.int64, (n + 1,))
    if bounds.ndim != 1 or bounds[0] != 0 or bounds[-1] != n \
            or (np.diff(bounds) < 0).any():
        raise ValueError("decode_levels: bounds must rise from 0 to n")
    m = int(offsets[-1])
    succ = torch.empty(m, dtype=torch.int32, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    levels = int((np.diff(bounds) > 0).sum())
    if levels == 0:
        return succ
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wgt_k2_decode(
            words.data_ptr(), (words.numel() - 2) * 64, bo.data_ptr(),
            offsets.data_ptr(), order.data_ptr(), bounds.ctypes.data,
            len(bounds) - 1, *skey, succ.data_ptr(), err.data_ptr(), stream)
    _build.check_launch("wgt_k2_decode", rc)
    decode_levels.launches += levels
    check_errors(err, order)
    return succ


decode_levels.launches = 0
