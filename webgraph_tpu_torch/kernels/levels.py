"""What both device routes of the bulk decode share: the depth plan, the
device inputs, the error codes and the plain PyTorch versions of the
record parse and the copy resolve.

K1 (``kernels/decode2.py``) and K2 (``kernels/decode.py``) compute the same
function, a stored BVGraph into CSR, with the same split:

1. :func:`parse_records_plain` (kernels ``k1_parse`` and ``k2_parse``):
   every record at once, since nothing in it depends on another list: each
   node's copy-block ends (``bend``, at the exclusive prefix sum ``bstart``
   of the block counts), its extras (interval runs merged with residuals,
   ascending, in ``ext`` at its CSR offset) and its reference.
2. :func:`resolve_copies_plain` (kernel ``k2_resolve``, on both routes):
   the copies, in the order of the global chain depth of the host structure
   scan (:func:`plan_levels`): depth 0 is every node without a reference,
   depth k + 1 every node whose parent has depth k.  A node keeps the
   parent's slots that have an even number of block ends at or before them
   and merges them with its extras by rank (:func:`merge_copies_plain`).

They differ in how the card parses: K1's parse gives each long record a
block of its own, K2's parses every record by one thread.

The plan may list a subset of the nodes (:func:`level_order` over a
batch's ancestor closure, ``kernels/query2.py``): K1's wrappers and both
plain versions then decode only those records, into the graph's own CSR
slots, while every array indexed by node id still covers the graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits.bitstream import as_u64_words
from webgraph_tpu_torch.kernels import pcodes as P

# both routes read the graphs whose window the JAX package's block kernel
# covers: its halo carries 7 lists
MAX_WINDOW = 7
TILE_BITS = 8192  # k1_parse's long-record residual tile (csrc/decode2.cu TILE)
# the plain parse finds the code starts of a record with at least this many
# residuals by doubling (code_starts_plain), the others one code a step
DOUBLING_CODES = 256

# per-node error codes (csrc/pcodes.cuh, csrc/records.cuh, csrc/decode.cu)
ERR_CODE = 1    # a code does not fit the window, or runs past the stream
ERR_REF = 3     # a reference beyond the window
ERR_COUNT = 4   # the record's counts disagree, or its extras repeat a value
ERR_PLAN = 5    # the record's reference disagrees with the depth plan
ERR_PARENT = 6  # the parent's list failed
ERR_WAIT = 7    # the parent's ready flag never came (k2_resolve only)
_ERR_TEXT = {ERR_CODE: "invalid code", ERR_REF: "reference beyond the window",
             ERR_COUNT: "record counts disagree",
             ERR_PLAN: "reference disagrees with the depth plan",
             ERR_PARENT: "parent failed",
             ERR_WAIT: "timed out waiting for the parent"}


# ----------------------------------------------------------------------
# device inputs
# ----------------------------------------------------------------------


def coding_key(settings) -> tuple:
    """(outd, ref, bcnt, blk, res, zeta_k, window, minint) of a graph."""
    s = settings
    return (s.outdegree_coding, s.reference_coding, s.block_count_coding,
            s.block_coding, s.residual_coding, s.zeta_k, s.window_size,
            s.min_interval_length)


def stream_words(g, device) -> torch.Tensor:
    """The graph's stream as big-endian uint64 words (bit patterns in an
    int64 tensor) plus two zero words, so a window read at the last code
    stays in bounds."""
    w = np.concatenate([as_u64_words(g._words), np.zeros(2, np.uint64)])
    return torch.from_numpy(w.view(np.int64)).to(device)


# ----------------------------------------------------------------------
# planning
# ----------------------------------------------------------------------


@dataclass
class LevelPlan:
    """Nodes ordered by global chain depth, with each depth's range, and
    the sizes a decode needs, kept on the host."""

    order: torch.Tensor    # int32 (n,) node ids, stable-sorted by depth
    bounds: np.ndarray     # int64 (levels + 1,) depth k is order[b[k]:b[k+1]]
    offsets: torch.Tensor  # int64 (n + 1,) CSR offsets, prefix sum of d
    bstart: torch.Tensor   # int64 (n + 1,) prefix sum of the block counts
    m: int = 0             # arcs: offsets[-1]
    nblocks: int = 0       # copy blocks: bstart[-1]
    long: torch.Tensor | None = None  # int32: order positions, long records

    @property
    def levels(self) -> int:
        return len(self.bounds) - 1


def csr_starts(scan) -> tuple[np.ndarray, np.ndarray]:
    """``(offsets, bstart)``: the prefix sums (int64, n + 1) of the
    outdegrees and of the copy-block counts of the scanned graph, where
    each node's list and block ends start in CSR."""
    n = scan.d.size
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(scan.d.astype(np.int64), out=offsets[1:])
    bstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(scan.block_count.astype(np.int64), out=bstart[1:])
    return offsets, bstart


def level_order(depth, d, nodes=None, long_arcs: int | None = None):
    """``(order, bounds, long)`` (int64 NumPy arrays) of the depth plan over
    ``nodes`` (distinct node ids, int64, in any order; every node when
    None): the nodes sorted by their global chain depth ``depth``, then by
    id, the range ``order[bounds[k]:bounds[k+1]]`` of each depth from 0 to
    the largest present, and, with ``long_arcs``, the positions in
    ``order`` of the records of at least that many arcs (``d``: the
    outdegrees), else none.  A set that holds every parent of its nodes
    (an ancestor closure, or the whole graph) has a node at every depth up
    to its largest."""
    n = depth.size
    ids = np.arange(n, dtype=np.int64) if nodes is None else nodes
    # one sort of (depth, id) packed in an int64: depth <= n < 2^31
    ds, order = np.divmod(np.sort(depth[ids] * n + ids), max(n, 1))
    levels = int(ds[-1]) + 1 if ds.size else 0
    bounds = np.searchsorted(ds, np.arange(levels + 1),
                             side="left").astype(np.int64)
    long = np.zeros(0, np.int64) if long_arcs is None else \
        np.flatnonzero(d[order] >= long_arcs)
    return order.astype(np.int64), bounds, long


def plan_levels(g, scan, long_arcs: int | None = None) -> LevelPlan:
    """The depth levels of ``g`` from its structure scan (CPU tensors), over
    every node (:func:`level_order`).  Every depth from 0 to the maximum
    holds a node (a node's parent is one level up), so a chain of
    ``levels`` nodes is the longest.  With ``long_arcs``, ``long`` lists
    the positions in ``order`` of the records of at least that many arcs
    (ascending); else it is empty."""
    order, bounds, long = level_order(scan.depth.astype(np.int64),
                                      scan.d.astype(np.int64), None,
                                      long_arcs)
    offsets, bstart = csr_starts(scan)
    return LevelPlan(order=torch.from_numpy(order.astype(np.int32)),
                     bounds=bounds, offsets=torch.from_numpy(offsets),
                     bstart=torch.from_numpy(bstart), m=int(offsets[-1]),
                     nblocks=int(bstart[-1]),
                     long=torch.from_numpy(long.astype(np.int32)))


@dataclass
class Planned:
    """A graph planned for one route on one device: what the kernels read,
    and the sizes, on the host."""

    device: torch.device
    words: torch.Tensor    # stream words (int64 bit patterns), 2 zero pads
    bo: torch.Tensor       # node bit offsets (int64, n + 1)
    order: torch.Tensor    # int32 (n,)
    bounds: np.ndarray     # int64 (levels + 1,), on the host
    offsets: torch.Tensor  # int64 (n + 1,)
    skey: tuple
    bstart: torch.Tensor   # int64 (n + 1,)
    m: int                 # arcs
    nblocks: int           # copy blocks

    def args(self) -> tuple:
        """The positional arguments of the route's decode wrapper."""
        return (self.words, self.bo, self.order, self.bounds, self.offsets,
                self.skey, self.bstart)

    def sizes(self) -> dict:
        """The host sizes, as keywords of the route's decode wrapper."""
        return dict(m=self.m, nblocks=self.nblocks)


def graph_fields(g, device, offsets, bstart) -> dict:
    """The per-graph fields of :class:`Planned`, whatever records a plan
    lists: the stream, bit offsets, CSR offsets and block starts
    (``offsets``, ``bstart``: int64 prefix sums, NumPy or CPU tensors) on
    ``device``, the coding key and the sizes on the host."""
    device = torch.device(device)
    offsets, bstart = torch.as_tensor(offsets), torch.as_tensor(bstart)
    return dict(
        device=device,
        words=stream_words(g, device),
        bo=torch.from_numpy(np.asarray(g.bit_offsets, np.int64)).to(device),
        offsets=offsets.to(device),
        skey=coding_key(g.settings),
        bstart=bstart.to(device),
        m=int(offsets[-1]),
        nblocks=int(bstart[-1]),
    )


def planned_fields(g, device, plan: LevelPlan) -> dict:
    """The fields of :class:`Planned` for ``g`` and its plan."""
    return dict(graph_fields(g, device, plan.offsets, plan.bstart),
                order=plan.order.to(device), bounds=plan.bounds)


def check_errors(err: torch.Tensor, order: torch.Tensor) -> None:
    """Raise if any node reported an error (``err`` is indexed like
    ``order``)."""
    if bool((err != 0).any()):
        bad = torch.nonzero(err).flatten()[:8]
        codes = sorted({int(c) for c in err[bad].tolist()})
        raise RuntimeError(
            f"decode failed at nodes {order[bad].tolist()}: "
            + ", ".join(_ERR_TEXT.get(c, str(c)) for c in codes))


def check_inputs(fn, words, bo, order, bounds, offsets, skey, bstart, *,
                 m, nblocks):
    """Raise ``ValueError`` where a wrapper's inputs are not what its
    kernels take; shapes and host values only, so nothing waits for the
    card.  ``bo``, ``offsets`` and ``bstart`` cover the graph's n nodes;
    ``order`` lists the records to decode, at most n of them (a subset
    when a batch of queries decodes its ancestor closure)."""
    dev = words.device
    for c in skey[:5]:
        P.make_window_reader(c, skey[5])  # rejects GOLOMB / NIBBLE
    if skey[6] > MAX_WINDOW:
        raise ValueError(f"{fn} supports window_size <= {MAX_WINDOW}")
    n = max(bo.numel() - 1, 0)
    k = order.numel()

    def need(name, t, dtype, shape):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {dtype} "
                             f"tensor of shape {shape} on {dev}")

    need("words", words, torch.int64, (words.numel(),))
    need("bo", bo, torch.int64, (n + 1,))
    need("order", order, torch.int32, (k,))
    need("offsets", offsets, torch.int64, (n + 1,))
    need("bstart", bstart, torch.int64, (n + 1,))
    if k > n:
        raise ValueError(f"{fn}: order lists {k} records of a graph of {n} "
                         f"nodes")
    if bounds.ndim != 1 or bounds[0] != 0 or bounds[-1] != k \
            or (np.diff(bounds) < 0).any():
        raise ValueError(f"{fn}: bounds must rise from 0 to the length of "
                         f"order")
    if m < 0 or nblocks < 0:
        raise ValueError(f"{fn}: m and nblocks must be sizes")


def host_sizes(offsets, bstart, m, nblocks):
    """``(m, nblocks)``, read from the tensors where the caller did not
    give them (a read that waits for the card when they lie there)."""
    return (int(offsets[-1]) if m is None else m,
            int(bstart[-1]) if nblocks is None else nblocks)


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
    extras and kept copies.  The runs must share no value
    inside a segment, or two values take one position; the third result
    marks each value of the first run that the second run holds too."""
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
    """What ``k1_parse`` and ``k2_parse`` write, as
    :func:`parse_records_plain` gives it."""

    ext: torch.Tensor   # int32 (m,): x's extras at offsets[x] .., else 0
    bend: torch.Tensor  # int32 (bstart[n],): x's block ends at bstart[x] ..
    ref: torch.Tensor   # int32 (n,): x's reference, 0 where it has none
    err: torch.Tensor   # int32, indexed like order


def code_starts_plain(words, start: int, count: int, coding: int, k: int = 0,
                      tile_bits: int = TILE_BITS):
    """The first ``count`` code starts of ``coding`` (ζ parameter ``k``)
    read one after another from bit ``start`` of ``words`` (int64 stream
    words, two zero pads), found as ``k1_parse`` finds a long record's
    residual starts: tile by tile of ``tile_bits`` bits, each tile from the
    previous one's exit, by doubling.  With ``J(i) = i + len(i)`` at every
    position of the tile (-1 where the code is invalid: length 65, or past
    the stream), ``S`` starts as {0}; each round adds ``J(S)`` and squares
    ``J``, until ``J(0)`` leaves the tile.  Returns ``(starts, end, err)``:
    the starts (int64, ascending), the bit after the last code, and
    ``ERR_CODE`` where a code among the first ``count`` is invalid (the
    starts then stop before it, and ``end`` is its start), else 0."""
    dev = words.device
    nbits = (words.numel() - 2) * 64
    w32 = P.split_words(words)
    read = P.make_window_reader(coding, k)
    i = torch.arange(tile_bits, device=dev)

    def inside(j):
        return (j >= 0) & (j < tile_bits)

    out, got, t0, end = [], 0, int(start), int(start)
    while got < count:
        a = t0 + i
        _, ln = read(*P.window_at(w32, a.clamp(0, nbits)))
        bad = (a >= nbits) | (ln > 64) | (a + ln > nbits)
        jmp = torch.where(bad, -1, i + ln)
        s = i == 0
        while bool(inside(jmp[0])):
            tg = jmp[s]
            s[tg[inside(tg)]] = True
            jmp = torch.where(inside(jmp), jmp[jmp.clamp(0, tile_bits - 1)],
                              jmp)
        take = torch.nonzero(s).flatten()[:count - got]
        worse = torch.nonzero(bad[take]).flatten()
        if worse.numel():
            take = take[:int(worse[0])]
            out.append(t0 + take)
            end = t0 + int(torch.nonzero(bad & s).flatten()[0])
            return torch.cat(out), end, ERR_CODE
        out.append(t0 + take)
        got += take.numel()
        end = t0 + int(take[-1] + ln[take[-1]])
        t0 += int(jmp[0])
    starts = torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                    device=dev)
    return starts, end, 0



def parse_records_plain(words, bo, order, bounds, offsets, skey, bstart, *,
                        m=None, nblocks=None) -> Parsed:
    """Plain version of ``k1_parse`` and ``k2_parse``: the records of the
    nodes ``order`` lists (every node, or a subset such as a batch's
    ancestor closure) at once, vectorised over them, one code index per
    step (outdegree, reference, block count, blocks, intervals, residuals).
    Nothing is read or written for a node not listed, and the outputs
    indexed by node id cover the graph (``bo.numel() - 1`` nodes), as the
    kernels index them.  The same checks, in the same order, as the
    kernels: invalid code, outdegree against ``offsets``, reference beyond
    the window, reference against the depth plan (depth 0, a position
    before ``bounds[1]``, exactly when there is none), block count against
    ``bstart``, blocks past the parent's list, intervals past the extras,
    a residual equal to an interval value."""
    outd_c, ref_c, bcnt_c, blk_c, res_c, zk, window, minint = skey
    dev = words.device
    n = bo.numel() - 1
    m, nblocks = host_sizes(offsets, bstart, m, nblocks)
    nbits = (words.numel() - 2) * 64
    w32 = P.split_words(words)
    readers = {cd: P.make_window_reader(cd, zk)
               for cd in {outd_c, ref_c, bcnt_c, blk_c, C.GAMMA, res_c}}
    i64 = dict(dtype=torch.int64, device=dev)
    # every per-record array below is indexed by position in order; x maps
    # a position to its node id
    x = order.long()
    nrec = x.numel()
    at = torch.arange(nrec, **i64)
    err = torch.zeros(nrec, **i64)

    def flag(idx, bad, code):
        i = idx[bad]
        err[i] = torch.where(err[i] == 0, code, err[i])

    def read(idx, pos, coding):
        """One code at each cursor; flags bad codes on positions ``idx``."""
        hi, lo = P.window_at(w32, pos.clamp(0, nbits))
        v, ln = readers[coding](hi, lo)
        flag(idx, (ln > 64) | (pos + ln > nbits), ERR_CODE)
        return v, pos + ln

    def lockstep(idx, pos, counts, coding, per=1):
        """Read ``per`` codes for each of ``counts[i]`` items of position
        ``idx[i]``, item k of every record in step k.  Returns the codes
        (``per`` flat arrays in record-major item order) and the
        cursors."""
        out = [torch.zeros(int(counts.sum()), **i64) for _ in range(per)]
        if not out[0].numel():
            return out, pos
        start = torch.cumsum(counts, 0) - counts
        by = torch.argsort(-counts, stable=True)
        cs = counts[by]
        pos = pos.clone()
        # nodes with more than k items: a prefix of ``by``
        nact = torch.searchsorted(-cs, -torch.arange(int(cs[0]), **i64))
        for k, na in enumerate(nact.tolist()):
            a = by[:na]
            for j in range(per):
                v, pos[a] = read(idx[a], pos[a], coding)
                out[j][start[a] + k] = v
        return out, pos

    d, pos = read(at, bo[x], outd_c)
    dx = offsets[x + 1] - offsets[x]
    flag(at, d != dx, ERR_COUNT)
    ref = torch.zeros(nrec, **i64)
    if window > 0:
        idx = torch.nonzero(d > 0).flatten()
        ref[idx], pos[idx] = read(idx, pos[idx], ref_c)
    hasr = ref > 0
    flag(at, hasr & ((ref > window) | (ref > x)), ERR_REF)
    depth0 = at < (int(bounds[1]) if len(bounds) > 1 else nrec)
    flag(at, depth0 == hasr, ERR_PLAN)
    parent = torch.where(hasr, (x - ref).clamp(min=0), x)
    dp = torch.where(hasr, (offsets[parent + 1] - offsets[parent]).clamp(
        min=0), 0)

    # copy blocks: the first as is, later ones + 1; even blocks copy
    ridx = torch.nonzero(hasr).flatten()
    bc = torch.zeros(nrec, **i64)
    bc[ridx], pos[ridx] = read(ridx, pos[ridx], bcnt_c)
    nbc = bstart[x + 1] - bstart[x]
    flag(at, hasr & (bc != nbc), ERR_COUNT)
    (blk,), pos[ridx] = lockstep(ridx, pos[ridx], bc[ridx], blk_c)
    bseg, bk = _segments(bc[ridx])
    blk = blk + (bk > 0)
    bnode = ridx[bseg]
    ends = _seg_cumsum(blk, bseg, bc[ridx])
    bend = torch.zeros(nblocks, dtype=torch.int32, device=dev)
    okb = (bc == nbc)[bnode]
    bend[(bstart[x[bnode]] + bk)[okb]] = ends[okb].to(torch.int32)
    cum = torch.zeros(nrec, **i64).index_add_(0, bnode, blk)
    flag(at, hasr & (cum > dp), ERR_COUNT)
    copied = torch.zeros(nrec, **i64).index_add_(0, bnode, blk * (bk % 2 == 0))
    copied += torch.where(hasr & (bc % 2 == 0), (dp - cum).clamp(min=0), 0)
    extra = torch.where(d > 0, d - copied, 0)
    flag(at, extra < 0, ERR_COUNT)
    extra = extra.clamp(min=0)

    # intervals: first left = x + nat2int(v), later prev end + 1 + v
    ivals = torch.zeros(0, **i64)
    inode = torch.zeros(0, **i64)
    iarcs = torch.zeros(nrec, **i64)
    if minint != 0:
        eidx = torch.nonzero(extra > 0).flatten()
        icnt = torch.zeros(nrec, **i64)
        icnt[eidx], pos[eidx] = read(eidx, pos[eidx], C.GAMMA)
        (lcode, lncode), pos[eidx] = lockstep(eidx, pos[eidx], icnt[eidx],
                                              C.GAMMA, per=2)
        iseg, ik = _segments(icnt[eidx])
        ilen = lncode + minint
        prev_len = torch.cat([torch.zeros(1, **i64), ilen[:-1]])
        gap = torch.where(ik == 0, x[eidx[iseg]] + P.nat2int_u(lcode),
                          prev_len + 1 + lcode)
        left = _seg_cumsum(gap, iseg, icnt[eidx])
        iarcs.index_add_(0, eidx[iseg], ilen)
        aseg, ak = _segments(ilen)
        ivals = left[aseg] + ak
        inode = eidx[iseg][aseg]
        flag(at, iarcs > extra, ERR_COUNT)

    # residuals: first x + nat2int(v), later prev + 1 + v
    rc = (extra - iarcs).clamp(min=0)
    cidx = torch.nonzero(rc > 0).flatten()
    rcnt = rc[cidx]
    rcode = torch.zeros(int(rcnt.sum()), **i64)
    rstart = torch.cumsum(rcnt, 0) - rcnt
    few = rcnt < DOUBLING_CODES
    (sub,), _ = lockstep(cidx[few], pos[cidx[few]], rcnt[few], res_c)
    fseg, fk = _segments(rcnt[few])
    rcode[rstart[few][fseg] + fk] = sub
    for i in torch.nonzero(~few).flatten().tolist():
        starts, _, bad = code_starts_plain(words, int(pos[cidx[i]]),
                                           int(rcnt[i]), res_c, zk)
        if bad:
            flag(cidx[i:i + 1], torch.ones(1, dtype=torch.bool), bad)
        s0 = int(rstart[i])
        rcode[s0:s0 + starts.numel()] = readers[res_c](
            *P.window_at(w32, starts))[0]
    rseg, rk = _segments(rc[cidx])
    rgap = torch.where(rk == 0, x[cidx[rseg]] + P.nat2int_u(rcode),
                       rcode + 1)
    rvals = _seg_cumsum(rgap, rseg, rc[cidx])
    rnode = cidx[rseg]

    # every record's extras, ascending, at its CSR offset; a residual that
    # equals an interval value fails the node
    enode = torch.cat([inode, rnode])
    evals = torch.cat([ivals, rvals])
    _, perm = torch.sort(enode * (1 << 33) + (evals + (1 << 32)))
    enode, evals = enode[perm], evals[perm]
    flag(enode[1:], (enode[1:] == enode[:-1]) & (evals[1:] == evals[:-1]),
         ERR_COUNT)
    ecnt = torch.bincount(enode, minlength=nrec)
    ek = torch.arange(enode.numel(), device=dev) - (
        torch.cumsum(ecnt, 0) - ecnt)[enode]
    inb = ek < dx[enode]
    ext = torch.zeros(m, dtype=torch.int32, device=dev)
    ext[(offsets[x[enode]] + ek)[inb]] = evals[inb].to(torch.int32)
    refs = torch.zeros(n, dtype=torch.int32, device=dev)
    refs[x] = ref.to(torch.int32)
    return Parsed(ext, bend, refs, err.to(torch.int32))


def resolve_copies_plain(parsed: Parsed, order, bounds, offsets, bstart, *,
                         m=None):
    """Plain version of ``k2_resolve``, one chain-depth level at a time,
    over the nodes ``order`` lists (every node, or a subset whose parse
    ``parsed`` holds).  Returns ``(succ, err)``, ``err`` indexed like
    ``order``: the parse's, then a node whose parent comes no earlier in
    ``order`` (or is not in it) fails with ERR_PLAN, a node whose parent
    failed with ERR_PARENT, and a node with an extra among its kept values
    with ERR_COUNT.  A depth-0 node's list is its extras; a deeper node
    keeps its parent's slots by the toggle rule (:func:`_kept`) and merges
    them with its extras by rank (:func:`_merge_by_rank`).  ``succ`` holds
    the graph's m slots, 0 outside the lists of ``order``'s nodes."""
    ext, bend, ref, err = parsed
    dev = ext.device
    n = offsets.numel() - 1
    npos = order.numel()
    m = int(offsets[-1]) if m is None else m
    i64 = dict(dtype=torch.int64, device=dev)
    dx = offsets[1:] - offsets[:-1]
    err = err.long().clone()
    order = order.long()
    # a node's position in order; past every position when it is not there
    rank = torch.full((n,), npos, **i64)
    rank[order] = torch.arange(npos, **i64)
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
            failed = err[prank.clamp(max=npos - 1)] != 0
            e = torch.where((e == 0) & failed, ERR_PARENT, e)
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


def decode_plain(words, bo, order, bounds, offsets, skey, bstart, *, m=None,
                 nblocks=None):
    """:func:`parse_records_plain` then :func:`resolve_copies_plain`.
    Returns ``(succ, err)``, ``err`` int32 indexed like ``order`` (0 where
    the node decoded)."""
    parsed = parse_records_plain(words, bo, order, bounds, offsets, skey,
                                 bstart, m=m, nblocks=nblocks)
    return resolve_copies_plain(parsed, order, bounds, offsets, bstart, m=m)
