"""K2, the long-reference-chain BVGraph decoder: host planning, the plain
PyTorch versions of its two kernels and their wrapper.

Counterpart of ``webgraph_tpu/pallas/decode.py``, the route of
``decode_to_csr_auto`` for graphs whose reference chains reach back
further than K1's lanes cover (maxref unbounded, ``decode2.supports``
False).  The TPU kernel parses each 1,024-node block's records
(``_p1b_blocks``, ``_p2_extras``), resolves the copies one in-block chain
depth at a time (``_p3_round``) and carries a halo of the last ``window``
lists to the next block.  Here the same split covers the whole graph:

1. :func:`parse_records_plain`, kernel ``k2_parse``: every record at once,
   since nothing in it depends on another list: each node's copy-block ends
   (``bend``, at the exclusive prefix sum ``bstart`` of the block counts),
   its extras (interval runs merged with residuals, ascending, in ``ext`` at
   its CSR offset) and its reference.
2. :func:`resolve_copies_plain`, kernel ``k2_resolve``: the copies, in the
   order of the global chain depth of the host structure scan
   (:func:`plan_levels`): depth 0 is every node without a reference, depth
   k + 1 every node whose parent has depth k.  A node keeps the parent's
   slots that have an even number of block ends at or before them and
   merges them with its extras by rank (:func:`merge_copies_plain`).

:func:`decode_levels` launches both kernels of ``csrc/decode.cu`` for CUDA
tensors (one C call, two launches) and takes :func:`decode_levels_plain`,
the composition of the two plain versions, for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.kernels import _build
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels import pcodes as P
from webgraph_tpu_torch.kernels.plan import scan_structure

# K2 takes the graphs that the JAX package's decode_to_csr_auto routes to
# its block kernel, whose halo carries 7 lists: window <= 7
MAX_WINDOW = 7

# per-node error codes: K1's, and K2's own (csrc/decode.cu)
ERR_CODE, ERR_REF, ERR_COUNT = D2.ERR_CODE, D2.ERR_REF, D2.ERR_COUNT
ERR_PLAN = 5    # the record's reference disagrees with the depth plan
ERR_PARENT = 6  # the parent's list failed
ERR_WAIT = 7    # the parent's ready flag never came (card only)
_ERR_TEXT = {ERR_CODE: "invalid code", ERR_REF: "reference beyond the window",
             ERR_COUNT: "record counts disagree",
             ERR_PLAN: "reference disagrees with the depth plan",
             ERR_PARENT: "parent failed",
             ERR_WAIT: "timed out waiting for the parent"}


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
    bstart: torch.Tensor   # int64 (n + 1,) prefix sum of the block counts

    @property
    def levels(self) -> int:
        return len(self.bounds) - 1


def plan_levels(g, scan) -> LevelPlan:
    """The depth levels of ``g`` from its structure scan (CPU tensors).
    Every depth from 0 to the maximum holds a node (a node's parent is one
    level up), so a chain of ``levels`` nodes is the longest."""
    n = g.num_nodes()
    depth = scan.depth.astype(np.int64)
    order = np.argsort(depth, kind="stable")
    levels = int(depth.max(initial=-1)) + 1
    bounds = np.searchsorted(depth[order], np.arange(levels + 1),
                             side="left").astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(scan.d.astype(np.int64), out=offsets[1:])
    bstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(scan.block_count.astype(np.int64), out=bstart[1:])
    return LevelPlan(order=torch.from_numpy(order.astype(np.int32)),
                     bounds=bounds, offsets=torch.from_numpy(offsets),
                     bstart=torch.from_numpy(bstart))


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
    bstart: torch.Tensor   # int64 (n + 1,)

    def args(self) -> tuple:
        """The arguments of :func:`decode_levels`."""
        return (self.words, self.bo, self.order, self.bounds, self.offsets,
                self.skey, self.bstart)


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
        bstart=plan.bstart.to(device),
    )


def decode_prepared(prep: LevelPrepared):
    """``(offsets int64[n+1], successors int32[m])`` on the prepared
    device."""
    return prep.offsets, decode_levels(*prep.args())


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
# plain PyTorch versions
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


def _kept(ndp, nbc, bend, bs):
    """The parent slots of a batch of nodes, as (node in batch, slot), and
    whether the node keeps each: when an even number of its block ends lie
    at or before the slot.  ``ndp``: the parents' outdegrees; ``nbc``,
    ``bs``: the nodes' block counts and first block in ``bend``.  Past the
    last end a slot is kept when the count is even: the tail rule."""
    i64 = dict(dtype=torch.int64, device=ndp.device)
    cseg, cj = _segments(ndp)
    pseg, pk = _segments(nbc)
    ends = bend[bs[pseg] + pk].long()
    cstart = torch.cumsum(ndp, 0) - ndp
    inside = (ends >= 0) & (ends < ndp[pseg])
    tog = torch.zeros(cseg.numel(), **i64).index_add_(
        0, (cstart[pseg] + ends)[inside],
        torch.ones(int(inside.sum()), **i64))
    return cseg, cj, _seg_cumsum(tog, cseg, ndp) % 2 == 0


def _merge_by_rank(aseg, aval, bseg, bval):
    """Positions in their segments' sorted unions of two runs of values,
    each sorted by (segment, value): a value goes to its index in its own
    run's segment plus the count of the other run's values below it in that
    segment.  One binary search a value, as ``k2_resolve`` merges a node's
    extras and kept copies.  The runs must share no value inside a segment,
    or two values take one position; the third result marks each value of
    the first run that the second run holds too."""
    def key(seg, val):
        return seg * (1 << 33) + (val + (1 << 32))

    ka, kb = key(aseg, aval), key(bseg, bval)

    def pos(seg, k, own, other):
        lo = seg * (1 << 33)
        return (torch.arange(k.numel(), device=k.device)
                - torch.searchsorted(own, lo)
                + torch.searchsorted(other, k) - torch.searchsorted(other, lo))

    clash = torch.searchsorted(kb, ka, right=True) != torch.searchsorted(kb, ka)
    return pos(aseg, ka, ka, kb), pos(bseg, kb, kb, ka), clash


def merge_copies_plain(parent, bend, extras):
    """One node's list, as one warp of ``k2_resolve`` builds it: the slots
    of the parent's list ``parent`` that an even number of the block ends
    ``bend`` lie at or before, merged by rank with the node's ``extras``
    (ascending).  int64 tensors.  Raises ``ValueError`` where an extra is
    also a copied value, as the kernel fails such a node."""
    dev = parent.device
    one = torch.ones(1, dtype=torch.int64, device=dev)
    _, cj, keep = _kept(one * parent.numel(), one * bend.numel(),
                        bend.long(), one * 0)
    kval = parent.long()[cj[keep]]
    ev = extras.long()
    epos, kpos, clash = _merge_by_rank(torch.zeros_like(ev), ev,
                                       torch.zeros_like(kval), kval)
    if bool(clash.any()):
        raise ValueError("merge_copies_plain: an extra is also a copied value")
    out = torch.empty(ev.numel() + kval.numel(), dtype=torch.int64,
                      device=dev)
    out[epos] = ev
    out[kpos] = kval
    return out


class Parsed(NamedTuple):
    """What ``k2_parse`` writes, as :func:`parse_records_plain` gives it."""

    ext: torch.Tensor   # int32 (m,): x's extras at offsets[x] .., else 0
    bend: torch.Tensor  # int32 (bstart[n],): x's block ends at bstart[x] ..
    ref: torch.Tensor   # int32 (n,): x's reference, 0 where it has none
    err: torch.Tensor   # int32 (n,), indexed like order


def parse_records_plain(words, bo, order, bounds, offsets, skey,
                        bstart) -> Parsed:
    """Plain version of ``k2_parse``: every record at once, vectorised over
    all nodes, one code index per step (outdegree, reference, block count,
    blocks, intervals, residuals).  The same checks, in the same order, as
    the kernel: invalid code, outdegree against ``offsets``, reference
    beyond the window, reference against the depth plan (depth 0 exactly
    when there is none), block count against ``bstart``, blocks past the
    parent's list, intervals past the extras."""
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
    depth0 = torch.zeros(n, dtype=torch.bool, device=dev)
    depth0[order[:int(bounds[1]) if len(bounds) > 1 else n].long()] = True
    flag(x, depth0 == hasr, ERR_PLAN)
    parent = torch.where(hasr, (x - ref).clamp(min=0), x)
    dp = torch.where(hasr, dx[parent].clamp(min=0), 0)

    # copy blocks: the first as is, later ones + 1; even blocks copy
    ridx = torch.nonzero(hasr).flatten()
    bc = torch.zeros(n, **i64)
    bc[ridx], pos[ridx] = read(ridx, pos[ridx], bcnt_c)
    nbc = bstart[1:] - bstart[:-1]
    flag(x, hasr & (bc != nbc), ERR_COUNT)
    (blk,), pos[ridx] = lockstep(ridx, pos[ridx], bc[ridx], blk_c)
    bseg, bk = _segments(bc[ridx])
    blk = blk + (bk > 0)
    bnode = ridx[bseg]
    ends = _seg_cumsum(blk, bseg, bc[ridx])
    bend = torch.zeros(int(bstart[-1]), dtype=torch.int32, device=dev)
    okb = (bc == nbc)[bnode]
    bend[(bstart[bnode] + bk)[okb]] = ends[okb].to(torch.int32)
    cum = torch.zeros(n, **i64).index_add_(0, bnode, blk)
    flag(x, hasr & (cum > dp), ERR_COUNT)
    copied = torch.zeros(n, **i64).index_add_(0, bnode, blk * (bk % 2 == 0))
    copied += torch.where(hasr & (bc % 2 == 0), (dp - cum).clamp(min=0), 0)
    extra = torch.where(d > 0, d - copied, 0)
    flag(x, extra < 0, ERR_COUNT)
    extra = extra.clamp(min=0)

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
        flag(x, iarcs > extra, ERR_COUNT)

    # residuals: first x + nat2int(v), later prev + 1 + v
    rc = (extra - iarcs).clamp(min=0)
    cidx = torch.nonzero(rc > 0).flatten()
    (rcode,), _ = lockstep(cidx, pos[cidx], rc[cidx], res_c)
    rseg, rk = _segments(rc[cidx])
    rgap = torch.where(rk == 0, cidx[rseg] + P.nat2int_u(rcode), rcode + 1)
    rvals = _seg_cumsum(rgap, rseg, rc[cidx])
    rnode = cidx[rseg]

    # every node's extras, ascending, at its CSR offset
    enode = torch.cat([inode, rnode])
    evals = torch.cat([ivals, rvals])
    _, perm = torch.sort(enode * (1 << 33) + (evals + (1 << 32)))
    enode, evals = enode[perm], evals[perm]
    ecnt = torch.bincount(enode, minlength=n)
    ek = torch.arange(enode.numel(), device=dev) - (
        torch.cumsum(ecnt, 0) - ecnt)[enode]
    inb = ek < dx[enode]
    ext = torch.zeros(m, dtype=torch.int32, device=dev)
    ext[(offsets[enode] + ek)[inb]] = evals[inb].to(torch.int32)
    return Parsed(ext, bend, ref.to(torch.int32),
                  err[order.long()].to(torch.int32))


def resolve_copies_plain(parsed: Parsed, order, bounds, offsets, bstart):
    """Plain version of ``k2_resolve``, one chain-depth level at a time (the
    kernel's tickets in the same order).  Returns ``(succ, err)``, ``err``
    indexed like ``order``: the parse's, then a node whose parent comes no
    earlier in ``order`` fails with ERR_PLAN, a node whose parent failed
    with ERR_PARENT, and a node with an extra among its kept values with
    ERR_COUNT.  A depth-0 node's list is its extras; a deeper node keeps
    its parent's slots by the toggle rule (:func:`_kept`) and merges them
    with its extras by rank (:func:`_merge_by_rank`)."""
    ext, bend, ref, err = parsed
    dev = ext.device
    n = order.numel()
    m = int(offsets[-1])
    i64 = dict(dtype=torch.int64, device=dev)
    dx = offsets[1:] - offsets[:-1]
    err = err.long().clone()
    order = order.long()
    rank = torch.empty(n, **i64)
    rank[order] = torch.arange(n, **i64)
    succ = torch.zeros(m, dtype=torch.int32, device=dev)
    ref = ref.long()
    for lvl in range(len(bounds) - 1):
        lo, hi = int(bounds[lvl]), int(bounds[lvl + 1])
        nodes = order[lo:hi]
        e = err[lo:hi]
        if lvl > 0:
            at = torch.arange(lo, hi, **i64)
            prank = rank[(nodes - ref[nodes]).clamp(0, n - 1)]
            e = torch.where((e == 0) & (prank >= at), ERR_PLAN, e)
            e = torch.where((e == 0) & (err[prank.clamp(max=n - 1)] != 0),
                            ERR_PARENT, e)
            err[lo:hi] = e
        good = nodes[e == 0]
        base = offsets[good]
        if lvl == 0:
            seg, k = _segments(dx[good])
            src = base[seg] + k
            succ[src] = ext[src]
            continue
        parent = good - ref[good]
        cseg, cj, keep = _kept(dx[parent], bstart[good + 1] - bstart[good],
                               bend, bstart[good])
        kseg = cseg[keep]
        kval = succ[offsets[parent][kseg] + cj[keep]].long()
        ne = dx[good] - torch.bincount(kseg, minlength=good.numel())
        eseg, ek = _segments(ne)
        evals = ext[base[eseg] + ek].long()
        epos, kpos, clash = _merge_by_rank(eseg, evals, kseg, kval)
        succ[base[eseg] + epos] = evals.to(torch.int32)
        succ[base[kseg] + kpos] = kval.to(torch.int32)
        at = torch.arange(lo, hi, **i64)[e == 0]
        err[at[eseg[clash]]] = ERR_COUNT
    return succ, err.to(torch.int32)


def decode_levels_plain(words, bo, order, bounds, offsets, skey, bstart):
    """Plain version of :func:`decode_levels`: :func:`parse_records_plain`
    then :func:`resolve_copies_plain`.  Returns ``(succ, err)``, ``err``
    int32 indexed like ``order`` (0 where the node decoded)."""
    parsed = parse_records_plain(words, bo, order, bounds, offsets, skey,
                                 bstart)
    return resolve_copies_plain(parsed, order, bounds, offsets, bstart)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------


def _check_inputs(fn, words, bo, order, bounds, offsets, skey, bstart):
    dev = words.device
    for c in skey[:5]:
        P.make_window_reader(c, skey[5])  # rejects GOLOMB / NIBBLE
    if skey[6] > MAX_WINDOW:
        raise ValueError(f"{fn} supports window_size <= {MAX_WINDOW}")
    n = order.numel()

    def need(name, t, dtype, shape):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} "
                             f"tensor of shape {shape} on {dev}")

    need("words", words, torch.int64, (words.numel(),))
    need("bo", bo, torch.int64, (n + 1,))
    need("order", order, torch.int32, (n,))
    need("offsets", offsets, torch.int64, (n + 1,))
    need("bstart", bstart, torch.int64, (n + 1,))
    if bounds.ndim != 1 or bounds[0] != 0 or bounds[-1] != n \
            or (np.diff(bounds) < 0).any():
        raise ValueError(f"{fn}: bounds must rise from 0 to n")


def _launch(words, bo, order, bounds, offsets, skey, bstart, ext, bend, succ,
            resolve):
    """One call of ``wgt_k2_decode``; returns the error array, the
    per-node scratch (rank, reference, extras count, ready flag) and the
    launches of ``k2_parse`` and ``k2_resolve`` as the C entry point
    reports them."""
    dev = words.device
    n = order.numel()
    node = torch.empty((4, n), dtype=torch.int32, device=dev)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    b1 = int(bounds[1]) if len(bounds) > 1 else n
    launched = (ctypes.c_int * 2)()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wgt_k2_decode(
            words.data_ptr(), (words.numel() - 2) * 64, bo.data_ptr(),
            offsets.data_ptr(), order.data_ptr(), bstart.data_ptr(), n, b1,
            *skey, ext.data_ptr(), bend.data_ptr(),
            *(node[r].data_ptr() for r in range(4)), ticket.data_ptr(),
            succ.data_ptr(), err.data_ptr(), int(resolve),
            ctypes.addressof(launched), stream)
    _build.check_launch("wgt_k2_decode", rc)
    return err, node, tuple(launched)


def decode_levels(words, bo, order, bounds, offsets, skey, bstart):
    """Decode every node into CSR: returns the int32 successors
    ``succ[offsets[x]:offsets[x+1]]`` of every node ``x``.  Raises if a node
    reports an error.

    ``words``: int64 stream words from ``decode2.stream_words``; ``bo``:
    int64 bit offsets of the graph's nodes (n + 1); ``order``: int32 node
    ids by depth; ``bounds``: host int64 level bounds into ``order``;
    ``offsets``: int64 CSR offsets (n + 1); ``skey``: ``decode2.coding_key``;
    ``bstart``: int64 prefix sum of the block counts (n + 1) (all from
    :func:`plan_levels`).

    CPU tensors take :func:`decode_levels_plain`; CUDA tensors launch
    ``k2_parse`` and, when a node has depth >= 1, ``k2_resolve`` (one C
    call), and are checked once after the launches.
    ``decode_levels.counts`` adds up each kernel's launches."""
    dev = words.device
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    if dev.type == "cpu":
        succ, err = decode_levels_plain(words, bo, order, bounds, offsets,
                                        skey, bstart)
        check_errors(err, order)
        return succ
    if dev.type != "cuda":
        raise ValueError(f"decode_levels: unsupported device {dev}")
    _check_inputs("decode_levels", words, bo, order, bounds, offsets, skey,
                  bstart)
    n = order.numel()
    succ = torch.empty(int(offsets[-1]), dtype=torch.int32, device=dev)
    if n == 0:
        return succ
    ext = torch.empty_like(succ)
    bend = torch.empty(int(bstart[-1]), dtype=torch.int32, device=dev)
    err, _, (parses, resolves) = _launch(words, bo, order, bounds, offsets,
                                         skey, bstart, ext, bend, succ, True)
    decode_levels.counts["k2_parse"] += parses
    decode_levels.counts["k2_resolve"] += resolves
    check_errors(err, order)
    return succ


decode_levels.counts = {"k2_parse": 0, "k2_resolve": 0}


def parse_records(words, bo, order, bounds, offsets, skey,
                  bstart) -> Parsed:
    """``k2_parse`` alone, laid out as :func:`parse_records_plain` gives
    it: every node's extras in ``ext`` (0 elsewhere), depth 0 too.  It does
    not raise on node errors (they are in ``err``).  CPU tensors take
    :func:`parse_records_plain`."""
    dev = words.device
    if dev.type == "cpu":
        return parse_records_plain(words, bo, order, bounds, offsets, skey,
                                   bstart)
    if dev.type != "cuda":
        raise ValueError(f"parse_records: unsupported device {dev}")
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    _check_inputs("parse_records", words, bo, order, bounds, offsets, skey,
                  bstart)
    n = order.numel()
    ext = torch.zeros(int(offsets[-1]), dtype=torch.int32, device=dev)
    bend = torch.zeros(int(bstart[-1]), dtype=torch.int32, device=dev)
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return Parsed(ext, bend, empty, empty)
    err, node, (parses, _) = _launch(words, bo, order, bounds, offsets, skey,
                                     bstart, ext, bend, ext, False)
    parse_records.launches += parses
    return Parsed(ext, bend, node[1], err)


parse_records.launches = 0


# ----------------------------------------------------------------------
# the warp-compaction probe
# ----------------------------------------------------------------------


def compact_probe_plain(vals, cnt, qpos, pool_size: int, depth: int = 16):
    """Plain version of :func:`compact_probe`: lane l's ``cnt[l]`` values
    ``vals[:cnt[l], l]`` go to ``pool[pre[l] ..)``, ``pre`` the exclusive
    prefix sum of ``cnt``; then ``q[k, l] = pool[qpos[l] + k]`` for
    ``k < depth``.  Returns ``(pool, q)``, int32."""
    dev = vals.device
    cnt = cnt.long()
    seg, k = _segments(cnt)
    pre = torch.cumsum(cnt, 0) - cnt
    pool = torch.zeros(pool_size, dtype=torch.int32, device=dev)
    pool[pre[seg] + k] = vals[k, seg]
    q = pool[qpos.long()[None, :] + torch.arange(depth, device=dev)[:, None]]
    return pool, q


def compact_probe(vals, cnt, qpos, pool_size: int, depth: int = 16):
    """The warp-compaction helper of ``k2_resolve`` (``warp_excl_scan``) on
    its own, in ``k2_compact_probe``: the counterpart of the JAX package's
    ``scripts/pallas_compact_chip.py`` probe of ``compact_slab`` and
    ``pool_fetch_queue``.  ``vals`` int32 (rows, lanes), ``cnt`` and
    ``qpos`` int32 (lanes,), lanes a multiple of 32 up to 1,024, counts
    0..31 and at most ``rows``.  CPU tensors take
    :func:`compact_probe_plain`."""
    if vals.device.type == "cpu":
        return compact_probe_plain(vals, cnt, qpos, pool_size, depth)
    rows, lanes = vals.shape
    dev = vals.device
    if lanes % 32 or not 0 < lanes <= 1024 or vals.dtype != torch.int32 \
            or not vals.is_contiguous():
        raise ValueError("compact_probe: vals must be contiguous int32 "
                         "(rows, lanes), lanes a multiple of 32 up to 1024")
    for name, t in (("cnt", cnt), ("qpos", qpos)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (lanes,):
            raise ValueError(f"compact_probe: {name} must be int32 "
                             f"({lanes},) on {dev}")
    c = cnt.long()
    if bool((c < 0).any() | (c > min(31, rows)).any()) \
            or int(c.sum()) > pool_size \
            or bool((qpos < 0).any() | (qpos.long() + depth > pool_size).any()):
        raise ValueError("compact_probe: counts or fetch positions out of "
                         "range")
    cnt, qpos = cnt.contiguous(), qpos.contiguous()
    pool = torch.zeros(pool_size, dtype=torch.int32, device=dev)
    q = torch.empty((depth, lanes), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_k2_compact_probe(
            vals.data_ptr(), cnt.data_ptr(), qpos.data_ptr(), lanes, depth,
            pool.data_ptr(), q.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wgt_k2_compact_probe", rc)
    compact_probe.launches += 1
    return pool, q


compact_probe.launches = 0
