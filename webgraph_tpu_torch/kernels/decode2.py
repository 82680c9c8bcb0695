"""Streaming lane-range BVGraph decoder (K1): host planning, the plain
PyTorch decoder and the wrapper of the Hopper kernel.

Counterpart of ``webgraph_tpu/pallas/decode2.py``.  The graph's nodes are
cut into per-lane ranges (:func:`plan_lanes`, the same plan as the
reference's).  Each lane decodes up to two ranges, A then B, each primed
with the ancestor overlap that its reference chains reach back to and with
the outdegrees of the 7 nodes before it, so lanes are independent.  A lane
writes its successor lists one after another into its own row of a
``(lanes, slabw)`` int32 slab; ``plan.prow`` points at each real node's
list there, and ``plan.exp_wp`` is each lane's expected emission count.

The TPU kernel keeps per-lane word rows (``pack2``) because Mosaic gathers
are row-local.  Here every lane reads the one shared stream at an absolute
int64 bit cursor, ``bo[gid0]`` for range A and ``bo[gid0b]`` for range B.

Per node a lane parses the record (outdegree, reference, copy blocks,
intervals) and then emits the successor list as the 3-way merge of the
parent's copied arcs, the interval runs and the gap-coded residuals; the
copy blocks and intervals are re-read during the merge from cursors saved
by the parse, so no side buffer is needed.  A copied arc is read from the
parent's list in the lane's own row; a node of the overlap that is not an
ancestor may name a parent before the lane's first node, and such reads
(the position is at or past the node's own start) give 0: those lists are
never used, but they still emit their outdegree so the counts match.

:func:`decode_lanes` launches the kernel for CUDA tensors and takes
:func:`decode_lanes_plain` for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits.bitstream import as_u64_words
from webgraph_tpu_torch.kernels import _build
from webgraph_tpu_torch.kernels import pcodes as P
from webgraph_tpu_torch.kernels.plan import scan_structure

LANES = 1024
MAX_REACH = 256  # longest reference reach (nodes) a lane's overlap covers

# states of the per-lane record machine of the plain decoder
S_OUTD, S_REF, S_BC, S_BLK, S_ICNT, S_INT, S_MRG, S_DONE = range(8)

# per-lane error codes (raised by check_errors)
ERR_CODE = 1      # a code does not fit the window, or runs past the stream
ERR_SLAB = 2      # the lane's slab row is full
ERR_REF = 3       # a reference beyond the window
ERR_COUNT = 4     # the merge ran out of arcs before the outdegree
_ERR_TEXT = {ERR_CODE: "invalid code", ERR_SLAB: "slab row overflow",
             ERR_REF: "reference beyond the window",
             ERR_COUNT: "record counts disagree"}


# ----------------------------------------------------------------------
# planning
# ----------------------------------------------------------------------


@dataclass
class LanePlan:
    """Partition of the node range [lo, hi) into per-lane streaming ranges.

    Arrays are int64 CPU tensors; ``d7``/``d7b`` are (7, lanes)."""

    gid0: torch.Tensor     # range A first DECODED node (overlap)
    nstart: torch.Tensor   # range A first REAL node
    cnt: torch.Tensor      # TOTAL decoded node count (A + B)
    cnta: torch.Tensor     # range A decoded node count
    gid0b: torch.Tensor    # range B first DECODED node (overlap)
    d7: torch.Tensor       # outdegrees of the 7 nodes before gid0
    d7b: torch.Tensor      # outdegrees of the 7 nodes before gid0b
    slabw: int             # slab width (per-lane arc capacity)
    exp_wp: torch.Tensor   # expected per-lane emission count
    prow: torch.Tensor     # (hi-lo+1,) slab position of each real node's list
    n: int = 0
    m: int = 0             # arcs of the real nodes in [lo, hi)
    max_steps: int = 0     # max per-lane work (codes + emissions)
    lo: int = 0
    hi: int = 0

    @property
    def lanes(self) -> int:
        return self.gid0.numel()


_PLAN_ARRAYS = ("gid0", "nstart", "cnt", "cnta", "gid0b", "d7", "d7b",
                "exp_wp", "prow")
_PLAN_SCALARS = ("slabw", "n", "m", "max_steps", "lo", "hi")


def plan_from_reference(plan) -> LanePlan:
    """The port's plan from a ``webgraph_tpu.pallas.decode2.LanePlan``.

    Its TPU word-row fields (``word0``, ``bit0``, ``bit0b``, ``lw``, ``sb``)
    have no counterpart here."""
    return LanePlan(
        **{f: torch.from_numpy(np.asarray(getattr(plan, f), np.int64))
           for f in _PLAN_ARRAYS},
        **{f: int(getattr(plan, f)) for f in _PLAN_SCALARS})


def _minanc(scan, n):
    """Smallest ancestor id of each node (itself if it has no reference)."""
    ref = scan.ref.astype(np.int64)
    parent = np.where(ref > 0, np.arange(n) - ref, np.arange(n))
    minanc = np.arange(n)
    cur = parent.copy()
    for _ in range(int(scan.depth.max(initial=0)) + 1):
        minanc = np.minimum(minanc, cur)
        cur = parent[cur]
    return minanc


def plan_lanes(g, scan, lanes: int = LANES, slab_cap: int = 8192,
               node_range: tuple[int, int] | None = None,
               slabw_fixed: int | None = None) -> LanePlan:
    """Balance the nodes of ``node_range`` (default: the whole graph) into
    ``lanes`` contiguous ranges plus ancestor overlap.

    Work model: one step per code, one per emitted arc and a constant per
    node, all known exactly from the host structure scan.  The per-lane
    budget is binary-searched, the partition is cut twice as fine and the
    ranges are paired largest with smallest (A and B of one lane) when that
    lowers the worst lane.  Raises ValueError when the range does not fit
    one launch (``decode_to_csr`` then tiles it).  At ``lanes=1024`` the
    plan equals ``webgraph_tpu.pallas.decode2.plan_lanes``'s field by field.
    """
    n = g.num_nodes()
    node_lo, node_hi = node_range if node_range is not None else (0, n)
    d = scan.d.astype(np.int64)
    ref = scan.ref.astype(np.int64)
    bc = scan.block_count.astype(np.int64)
    ic = scan.int_count.astype(np.int64)
    res = scan.res_count.astype(np.int64)
    extra = np.where(ref > 0, d - scan.copied.astype(np.int64), d)
    extra[d == 0] = 0
    mi = g.settings.min_interval_length

    ncodes = (np.ones(n, dtype=np.int64) + (d > 0) + (ref > 0) * (1 + bc)
              + ((extra > 0) & (mi != 0)) * (1 + 2 * ic) + res)
    work = ncodes + (d - res) + 3
    csr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(d, out=csr[1:])

    minanc = _minanc(scan, n)
    reach = int((np.arange(n) - minanc).max(initial=0))

    wc = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(work, out=wc[1:])

    def partition(T: int, k: int, cap: int, balance: bool = False):
        """Greedy: close a lane when its budget T or the slab arc cap is
        hit; ``balance`` also caps each lane at the remaining average.
        Returns (starts, bounds), or None if more than k ranges are needed."""
        starts = np.zeros(k, dtype=np.int64)
        bounds = np.zeros(k, dtype=np.int64)
        a = node_lo
        for l in range(k):
            starts[l] = a
            if a >= node_hi:
                bounds[l] = a
                continue
            # the budget counts from the overlap start
            amin = max(a - reach, 0)
            Tl = T
            if balance:
                rem = int(wc[node_hi] - wc[amin])
                Tl = min(T, max(rem // (k - l) + 1,
                                int(work[amin:amin + 1].max(initial=1))))
            b1 = int(np.searchsorted(wc, wc[amin] + Tl, side="right")) - 1
            b2 = int(np.searchsorted(csr, csr[amin] + cap, side="right")) - 1
            b = max(a + 1, min(b1, b2, node_hi))
            bounds[l] = b
            a = b
        return (starts, bounds) if a >= node_hi else None

    tile_work = int(wc[node_hi] - wc[node_lo])

    def search(cap: int, k: int):
        """Smallest feasible budget for k ranges at arc cap ``cap``."""
        lo = max(int(work[node_lo:node_hi].max(initial=1)), tile_work // k)
        hi = max(int(wc[-1]), lo + 1)
        best = None
        while lo < hi:
            mid = (lo + hi) // 2
            got = partition(mid, k, cap)
            if got is not None:
                best = (mid, got)
                hi = mid
            else:
                lo = mid + 1
        if best is None:
            got = partition(hi, k, cap)
            if got is None:
                return None
            best = (hi, got)
        bal = partition(best[0], k, cap, balance=True)
        if bal is not None:
            best = (best[0], bal)
        return best

    cand = [c for c in (search(cap, lanes) for cap in
                        {slab_cap, slab_cap + 4096, slab_cap + 8192})
            if c is not None]
    if not cand:
        raise ValueError(
            f"node range too large for a single streaming-kernel launch "
            f"({int(csr[node_hi] - csr[node_lo])} arcs > "
            f"~{lanes * (slab_cap + 4096)} slab capacity); decode it "
            f"tile-wise (decode_to_csr does this automatically)")
    nr = 2 * lanes  # partition twice as fine, then pair large with small
    cand2 = [c for c in (search(cap, nr) for cap in
                         {slab_cap // 2, slab_cap // 2 + 1024,
                          slab_cap // 2 + 2048})
             if c is not None]
    if not cand2:
        cand2 = [(1 << 60, cand[0][1])]
    _, (starts2, bounds2) = min(cand2, key=lambda x: x[0])

    def range_gid0(starts_, bounds_):
        g0 = starts_.copy()
        for l in range(len(starts_)):
            a, b = starts_[l], bounds_[l]
            if b > a:
                g0[l] = min(a, int(minanc[a:b].min()))
        return g0

    g2 = range_gid0(starts2, bounds2)
    steps2 = wc[bounds2] - wc[g2]
    order = np.argsort(-steps2, kind="stable")
    pairA = order[:lanes]
    pairB = order[nr - 1: lanes - 1: -1]
    pair_steps = steps2[pairA] + steps2[pairB]
    arcs2 = csr[bounds2] - csr[g2]
    pair_arcs = arcs2[pairA] + arcs2[pairB]

    # keep the single-range partition if pairing did not help
    T1, (starts1, bounds1) = min(cand, key=lambda x: x[0])
    if int(pair_steps.max(initial=1)) < T1:
        startsA, boundsA = starts2[pairA], bounds2[pairA]
        startsB, boundsB = starts2[pairB], bounds2[pairB]
        gid0, gid0b = g2[pairA], g2[pairB]
        lane_arcs = pair_arcs
        max_steps = int(pair_steps.max(initial=1))
    else:
        startsA, boundsA = starts1, bounds1
        startsB = boundsB = np.full(lanes, node_hi, dtype=np.int64)
        gid0 = range_gid0(starts1, bounds1)
        gid0b = np.full(lanes, node_hi, dtype=np.int64)
        lane_arcs = csr[boundsA] - csr[gid0]
        max_steps = int((wc[boundsA] - wc[gid0]).max(initial=1))

    slabw = int(lane_arcs.max(initial=0))
    slabw = max(256, -(-slabw // 128) * 128)
    if slabw_fixed is not None:
        if slabw_fixed < slabw:
            raise ValueError(f"slabw_fixed {slabw_fixed} < needed {slabw}")
        slabw = slabw_fixed

    def d7_of(g0):
        out = np.zeros((7, lanes), dtype=np.int64)
        for j in range(7):
            idx = g0 - 1 - j
            ok = (idx >= 0) & (idx < n)
            out[j, ok] = d[idx[ok]]
        return out

    arcsA = csr[boundsA] - csr[gid0]
    arcsB = np.where(boundsB > startsB, csr[boundsB] - csr[gid0b], 0)
    prow = np.zeros(node_hi - node_lo + 1, dtype=np.int64)
    for l in range(lanes):
        a, b = int(startsA[l]), int(boundsA[l])
        if b > a:
            prow[a - node_lo: b - node_lo] = (
                l * slabw + (csr[a:b] - csr[gid0[l]]))
        a2, b2 = int(startsB[l]), int(boundsB[l])
        if b2 > a2:
            prow[a2 - node_lo: b2 - node_lo] = (
                l * slabw + arcsA[l] + (csr[a2:b2] - csr[gid0b[l]]))
    prow[node_hi - node_lo] = int(csr[node_hi] - csr[node_lo])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))

    return LanePlan(
        gid0=t(gid0),
        nstart=t(startsA),
        cnt=t(boundsA - gid0 + np.maximum(boundsB - gid0b, 0)),
        cnta=t(boundsA - gid0),
        gid0b=t(np.clip(gid0b, 0, n)),
        d7=t(d7_of(gid0)),
        d7b=t(d7_of(np.clip(gid0b, 0, n))),
        slabw=slabw,
        exp_wp=t(arcsA + arcsB),
        prow=t(prow),
        n=n,
        m=int(csr[node_hi] - csr[node_lo]),
        max_steps=max_steps,
        lo=node_lo,
        hi=node_hi,
    )


def plan_tiles(g, scan, *, lanes: int = LANES, slab_cap: int = 8192,
               tile_arcs: int | None = None) -> list[LanePlan]:
    """Split [0, n) into arc-balanced node tiles that each fit one launch,
    planned with a common slab width.  A lane's ancestor overlap may reach
    into the previous tile: no protocol is needed between tiles."""
    n = g.num_nodes()
    csr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(scan.d.astype(np.int64), out=csr[1:])
    m = int(csr[-1])
    cap = tile_arcs if tile_arcs else lanes * (slab_cap // 2)
    num_tiles = max(1, -(-m // cap))
    targets = (np.arange(1, num_tiles) * m) // num_tiles
    bounds = np.unique(np.concatenate(
        [[0], np.searchsorted(csr, targets, side="left"), [n]]))
    ranges = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
    plans = [plan_lanes(g, scan, lanes, slab_cap, node_range=r)
             for r in ranges]
    slabw = max(p.slabw for p in plans)
    # prow depends on the slab width: re-plan the narrower tiles
    return [p if p.slabw == slabw else
            plan_lanes(g, scan, lanes, slab_cap, node_range=r,
                       slabw_fixed=slabw)
            for p, r in zip(plans, ranges)]


def supports(g, scan=None) -> bool:
    """Whether K1 can decode ``g``: every coding has a window reader
    (GAMMA/DELTA/ZETA/UNARY), window <= 7, and the reference-chain reach is
    at most :data:`MAX_REACH` nodes.  ``scan``: the graph's structure scan,
    where the caller has it."""
    s = g.settings
    ok_codings = all(c in (C.GAMMA, C.DELTA, C.ZETA, C.UNARY) for c in (
        s.outdegree_coding, s.reference_coding, s.block_count_coding,
        s.block_coding, s.residual_coding))
    if not (ok_codings and s.window_size <= 7):
        return False
    if s.max_ref_count >= 0 and \
            s.window_size * max(s.max_ref_count, 1) <= MAX_REACH:
        return True
    if scan is None:
        scan = scan_structure(g)
    n = g.num_nodes()
    return int((np.arange(n) - _minanc(scan, n)).max(initial=0)) <= MAX_REACH


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


@dataclass
class LaneInputs:
    """A plan's per-lane kernel inputs on one device: node ids and counts
    int32, the 7-outdegree primes int32 (7, lanes)."""

    gid0: torch.Tensor
    gid0b: torch.Tensor
    cnt: torch.Tensor
    cnta: torch.Tensor
    d7: torch.Tensor
    d7b: torch.Tensor
    slabw: int

    @classmethod
    def of(cls, plan: LanePlan, device) -> "LaneInputs":
        def i32(t):
            return t.to(device=device, dtype=torch.int32).contiguous()

        return cls(i32(plan.gid0), i32(plan.gid0b), i32(plan.cnt),
                   i32(plan.cnta), i32(plan.d7), i32(plan.d7b), plan.slabw)


def check_errors(err: torch.Tensor) -> None:
    """Raise if any lane reported an error."""
    if bool((err != 0).any()):
        bad = torch.nonzero(err).flatten()[:8].tolist()
        codes = sorted({int(err[i]) for i in bad})
        raise RuntimeError(
            f"decode failed in lanes {bad}: "
            + ", ".join(_ERR_TEXT.get(c, str(c)) for c in codes))


# ----------------------------------------------------------------------
# plain PyTorch decoder
# ----------------------------------------------------------------------


def decode_lanes_plain(words, bo, li: LaneInputs, skey: tuple):
    """Plain version of :func:`decode_lanes`, vectorized over lanes.

    Each step advances every active lane by one action: one code read, one
    copy-run start without a code, or one emitted arc.  Returns
    ``(slab, wp, err)``."""
    outd_c, ref_c, bcnt_c, blk_c, res_c, zk, window, minint = skey
    dev = words.device
    L, slabw = li.gid0.numel(), li.slabw
    nbits = (words.numel() - 2) * 64
    w32 = P.split_words(words)
    lane = torch.arange(L, device=dev)

    def zeros():
        return torch.zeros(L, dtype=torch.int64, device=dev)

    gid0, gid0b = li.gid0.long(), li.gid0b.long()
    cnt, cnta = li.cnt.long(), li.cnta.long()
    # one trash column takes the writes of lanes that do not emit
    slab = torch.zeros(L, slabw + 1, dtype=torch.int32, device=dev)
    wp, err, loc = zeros(), zeros(), zeros()
    st = torch.where(cnt > 0, S_OUTD, S_DONE)
    startb = (cnta == 0) & (cnt > 0)
    gid = torch.where(startb, gid0b, gid0)
    cur = bo[gid]
    dring = torch.where(startb, li.d7b.long(), li.d7.long())
    fring = torch.zeros(7, L, dtype=torch.int64, device=dev)
    # record (parse) state
    d, r, dp, pb, base = zeros(), zeros(), zeros(), zeros(), zeros()
    bc, bk, cum, copied, bpos0 = zeros(), zeros(), zeros(), zeros(), zeros()
    icnt, il, iarcs, ipos0 = zeros(), zeros(), zeros(), zeros()
    # merge state: copy runs, interval runs, residuals
    em, crem, cp, cend, mbk, mcum, bpos = (zeros() for _ in range(7))
    ileft, iphase, ifirst, ival, irem, iprev, ipos = (zeros()
                                                      for _ in range(7))
    rleft, rvok, rfirst, rv = zeros(), zeros(), zeros(), zeros()

    coding_of = torch.tensor(
        [outd_c, ref_c, bcnt_c, blk_c, C.GAMMA, C.GAMMA, 0, 0],
        dtype=torch.int64, device=dev)
    readers = {cd: P.make_window_reader(cd, zk)
               for cd in {outd_c, ref_c, bcnt_c, blk_c, C.GAMMA, res_c}}
    inf = torch.iinfo(torch.int64).max

    while bool((st != S_DONE).any()):
        s0 = st  # every mask below reads the state at the start of the step
        in_m = s0 == S_MRG
        c_run = in_m & (crem > 0) & (cp >= cend)
        c_blk = c_run & (mbk < bc)
        c_tail = c_run & ~c_blk
        i_rd = in_m & ~c_run & (irem == 0) & (ileft > 0)
        r_rd = in_m & ~c_run & ~i_rd & (rvok == 0) & (rleft > 0)
        emit = in_m & ~c_run & ~i_rd & ~r_rd
        parse = (s0 != S_DONE) & ~in_m
        rd = parse | c_blk | i_rd | r_rd

        # ---- one code read per reading lane ----------------------------
        pos = torch.where(c_blk, bpos, torch.where(i_rd, ipos, cur))
        cod = torch.where(c_blk, blk_c, torch.where(
            i_rd, C.GAMMA, torch.where(r_rd, res_c,
                                       coding_of[s0])))
        hi, lo = P.window_at(w32, torch.where(rd, pos, 0).clamp(0, nbits))
        v, ln = zeros(), zeros()
        for cd, fn in readers.items():
            rv_, rl_ = fn(hi, lo)
            sel = cod == cd
            v = torch.where(sel, rv_, v)
            ln = torch.where(sel, rl_, ln)
        bad = rd & ((ln > 64) | (pos + ln > nbits))
        err = torch.where(bad & (err == 0), ERR_CODE, err)
        ok = rd & ~bad
        npos = pos + ln
        cur = torch.where(ok & (parse | r_rd), npos, cur)
        bpos = torch.where(ok & c_blk, npos, bpos)
        ipos = torch.where(ok & i_rd, npos, ipos)

        adv = torch.zeros(L, dtype=torch.bool, device=dev)
        go_x = torch.zeros_like(adv)
        bdone = torch.zeros_like(adv)
        minit = torch.zeros_like(adv)

        # OUTD: a new record
        t = ok & (s0 == S_OUTD)
        d = torch.where(t, v, d)
        base = torch.where(t, wp, base)
        for x in (r, bc, copied, icnt, iarcs):
            x.masked_fill_(t, 0)
        adv |= t & (v == 0)
        if window > 0:
            st = torch.where(t & (v > 0), S_REF, st)
        else:
            go_x |= t & (v > 0)

        # REF
        t = ok & (s0 == S_REF)
        r = torch.where(t, v, r)
        hasr = t & (v > 0)
        err = torch.where(hasr & (v > min(window, 7)) & (err == 0),
                          ERR_REF, err)
        ri = (v - 1).clamp(0, 6).unsqueeze(0)
        dp = torch.where(hasr, dring.gather(0, ri)[0], dp)
        pb = torch.where(hasr, fring.gather(0, ri)[0], pb)
        st = torch.where(hasr, S_BC, st)
        go_x |= t & (v == 0)

        # BC
        t = ok & (s0 == S_BC)
        bc = torch.where(t, v, bc)
        bk = torch.where(t, 0, bk)
        cum = torch.where(t, 0, cum)
        bpos0 = torch.where(t, npos, bpos0)
        st = torch.where(t & (v > 0), S_BLK, st)
        bdone |= t & (v == 0)

        # BLK: the first block as is, later ones + 1; even blocks copy
        t = ok & (s0 == S_BLK)
        bval = v + (bk > 0)
        cum = torch.where(t, cum + bval, cum)
        copied = torch.where(t & ((bk & 1) == 0), copied + bval, copied)
        bk = torch.where(t, bk + 1, bk)
        bdone |= t & (bk == bc)

        # blocks done: with an even count the parent's tail is copied too
        copied = torch.where(bdone & ((bc & 1) == 0),
                             copied + (dp - cum).clamp(min=0), copied)
        go_x |= bdone

        if minint != 0:
            st = torch.where(go_x & (d - copied > 0), S_ICNT, st)
            minit |= go_x & (d - copied <= 0)

            # ICNT
            t = ok & (s0 == S_ICNT)
            icnt = torch.where(t, v, icnt)
            il = torch.where(t, 2 * v, il)
            ipos0 = torch.where(t, npos, ipos0)
            st = torch.where(t & (v > 0), S_INT, st)
            minit |= t & (v == 0)

            # INT: left / length codes alternate; count the interval arcs
            t = ok & (s0 == S_INT)
            iarcs = torch.where(t & ((il & 1) == 1), iarcs + v + minint,
                                iarcs)
            il = torch.where(t, il - 1, il)
            minit |= t & (il == 0)
        else:
            minit |= go_x

        # merge init; residuals follow at the main cursor
        st = torch.where(minit, S_MRG, st)
        em = torch.where(minit, 0, em)
        crem = torch.where(minit, torch.where(r > 0, copied, 0), crem)
        for x in (cp, cend, mbk, mcum, irem, iphase, rvok):
            x.masked_fill_(minit, 0)
        bpos = torch.where(minit, bpos0, bpos)
        ileft = torch.where(minit, icnt, ileft)
        ipos = torch.where(minit, ipos0, ipos)
        ifirst = torch.where(minit, 1, ifirst)
        rfirst = torch.where(minit, 1, rfirst)
        rleft = torch.where(minit, (d - torch.where(r > 0, copied, 0)
                                    - iarcs).clamp(min=0), rleft)

        # copy runs: [cum, cum + block) for even blocks, then the tail
        t = ok & c_blk
        bval = v + (mbk > 0)
        even = (mbk & 1) == 0
        cp = torch.where(t & even, mcum, cp)
        cend = torch.where(t & even, mcum + bval, cend)
        mcum = torch.where(t, mcum + bval, mcum)
        mbk = torch.where(t, mbk + 1, mbk)
        tail = c_tail & (mbk == bc) & ((bc & 1) == 0)
        err = torch.where(c_tail & ~tail & (err == 0), ERR_COUNT, err)
        cp = torch.where(tail, mcum, cp)
        cend = torch.where(tail, dp, cend)
        mbk = torch.where(tail, mbk + 1, mbk)

        # interval runs: first left gid + nat2int, later prev_end + 1 + v
        t = ok & i_rd
        is_left = t & (iphase == 0)
        is_len = t & (iphase == 1)
        ival = torch.where(is_left, torch.where(
            ifirst > 0, gid + P.nat2int_u(v), iprev + 1 + v), ival)
        ifirst = torch.where(is_left, 0, ifirst)
        irem = torch.where(is_len, v + minint, irem)
        iprev = torch.where(is_len, ival + v + minint, iprev)
        ileft = torch.where(is_len, ileft - 1, ileft)
        iphase = torch.where(t, 1 - iphase, iphase)

        # residuals: first gid + nat2int, later prev + 1 + v
        t = ok & r_rd
        rv = torch.where(t, torch.where(rfirst > 0, gid + P.nat2int_u(v),
                                        rv + 1 + v), rv)
        rvok = torch.where(t, 1, rvok)
        rfirst = torch.where(t, 0, rfirst)
        rleft = torch.where(t, rleft - 1, rleft)

        # emission: the smallest head; copies, then intervals on ties
        cpos = pb + cp
        cval = slab[lane, cpos.clamp(0, slabw - 1)].long()
        ch = torch.where(crem > 0, torch.where(cpos < base, cval, 0), inf)
        ih = torch.where(irem > 0, ival, inf)
        rh = torch.where(rvok > 0, rv, inf)
        val = torch.minimum(ch, torch.minimum(ih, rh))
        dry = emit & (val == inf)
        full = emit & (wp >= slabw)
        err = torch.where(dry & (err == 0), ERR_COUNT, err)
        err = torch.where(full & (err == 0), ERR_SLAB, err)
        emit = emit & ~dry & ~full
        is_c = emit & (ch <= ih) & (ch <= rh)
        is_i = emit & ~is_c & (ih <= rh)
        is_r = emit & ~is_c & ~is_i
        slab[lane, torch.where(emit, wp, slabw)] = val.to(torch.int32)
        wp = torch.where(emit, wp + 1, wp)
        em = torch.where(emit, em + 1, em)
        crem = torch.where(is_c, crem - 1, crem)
        cp = torch.where(is_c, cp + 1, cp)
        irem = torch.where(is_i, irem - 1, irem)
        ival = torch.where(is_i, ival + 1, ival)
        rvok = torch.where(is_r, 0, rvok)
        adv |= emit & (em == d)

        # node advance: shift the outdegree / list-start rings
        dring = torch.where(adv, torch.cat([d[None], dring[:6]]), dring)
        fring = torch.where(adv, torch.cat([base[None], fring[:6]]), fring)
        loc = torch.where(adv, loc + 1, loc)
        gid = torch.where(adv, gid + 1, gid)
        st = torch.where(adv, S_OUTD, st)
        st = torch.where(adv & (loc >= cnt), S_DONE, st)
        # range switch: jump to range B, re-prime the outdegree ring; B's
        # parents before gid0b are never real, so their starts point at wp
        sw = adv & (loc == cnta) & (loc < cnt)
        gid = torch.where(sw, gid0b, gid)
        cur = torch.where(sw, bo[gid0b], cur)
        dring = torch.where(sw, li.d7b.long(), dring)
        fring = torch.where(sw, wp, fring)
        st = torch.where(err != 0, S_DONE, st)

    return slab[:, :slabw], wp.to(torch.int32), err.to(torch.int32)


# ----------------------------------------------------------------------
# kernel wrapper
# ----------------------------------------------------------------------


def decode_lanes(words, bo, li: LaneInputs, skey: tuple):
    """Decode every lane of one plan: returns ``(slab, wp)``, the
    (lanes, slabw) int32 slab whose row l holds lane l's lists in its first
    ``wp[l]`` slots, and the int32 emission counts.  Slots past ``wp`` are
    unspecified.  Raises if a lane reports an error.

    ``words``: int64 stream words from :func:`stream_words`; ``bo``: int64
    bit offsets of the graph's nodes; ``li``: the plan's lane inputs on the
    same device; ``skey``: :func:`coding_key` of the graph.

    CPU tensors take :func:`decode_lanes_plain`; CUDA tensors launch the K1
    kernel of ``csrc/decode2.cu``."""
    dev = words.device
    if dev.type == "cpu":
        slab, wp, err = decode_lanes_plain(words, bo, li, skey)
        check_errors(err)
        return slab, wp
    if dev.type != "cuda":
        raise ValueError(f"decode_lanes: unsupported device {dev}")
    for c in skey[:5]:
        P.make_window_reader(c, skey[5])  # rejects GOLOMB / NIBBLE
    if skey[6] > 7:
        raise ValueError("decode_lanes supports window_size <= 7")
    L = li.gid0.numel()

    def need(name, t, dtype, shape):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"decode_lanes: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {dev}")

    need("words", words, torch.int64, (words.numel(),))
    need("bo", bo, torch.int64, (bo.numel(),))
    for name in ("gid0", "gid0b", "cnt", "cnta"):
        need(name, getattr(li, name), torch.int32, (L,))
    need("d7", li.d7, torch.int32, (7, L))
    need("d7b", li.d7b, torch.int32, (7, L))
    slab = torch.empty((L, li.slabw), dtype=torch.int32, device=dev)
    wp = torch.empty(L, dtype=torch.int32, device=dev)
    err = torch.empty(L, dtype=torch.int32, device=dev)
    if L == 0:
        return slab, wp
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wgt_k1_decode2(
            words.data_ptr(), (words.numel() - 2) * 64, bo.data_ptr(),
            li.gid0.data_ptr(), li.gid0b.data_ptr(), li.cnt.data_ptr(),
            li.cnta.data_ptr(), li.d7.data_ptr(), li.d7b.data_ptr(), L,
            li.slabw, *skey, slab.data_ptr(), wp.data_ptr(), err.data_ptr(),
            stream)
    _build.check_launch("wgt_k1_decode2", rc)
    decode_lanes.launches += 1
    check_errors(err)
    return slab, wp


decode_lanes.launches = 0
