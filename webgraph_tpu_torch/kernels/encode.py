"""``enc_costs``, ``enc_select``, ``enc_emit``: the BVGraph encoder's kernels,
their plain PyTorch versions and their wrappers.

The encoder (``formats/bvgraph_encode.py``) is the counterpart of the JAX
package's ``webgraph_tpu/formats/bvgraph_jax_encode.py``, which has no
``pallas_call``: its XLA programs become the three kernels of
``csrc/encode.cu``:

* :func:`enc_costs` (``compute_costs`` ``:449``): ``costs int32[n, w+1]``,
  every (node, shift) diffComp cost in bits, and ``valid bool[n, w+1]``,
  whether the shift is a candidate;
* :func:`enc_select` (``select_references`` ``:487``): the greedy choice of
  each node's reference under ``maxRefCount``, ``refs`` and ``depths``
  (``int32[n]``);
* :func:`enc_emit` (``_chosen_structure``, ``emit_graph``, ``emit_offsets``
  ``:520-805``): the ``.graph`` records at their planned bit starts, the
  ``.offsets`` codes, and the stats vector (:data:`NSTATS` counters, the
  successor and residual gap histograms, :data:`NBINS` bins each, then an
  error flag at :data:`ERR`).

The plain versions transcribe the JAX module's arithmetic into torch: the
arc-parallel cost pass (membership by ``torch.searchsorted`` over packed
(node, successor) keys in the place of the JAX ``_member`` search), the
selection scan as a host loop, and the emission as ``index_add_`` of
disjoint-bit int64 contributions, up to three 32-bit words a code (``_emit``
``:623``).  CPU tensors take the plain versions; CUDA tensors launch the
kernel, counted in ``<wrapper>.launches``, or raise.

The streams are 32-bit words, MSB first (the JAX module's ``'>u4'``),
held in int32 tensors.  Codings: γ, δ, ζ_k, unary, Golomb (b = ζ_k) and
nibble (``bits/codes.py``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.kernels import _build

NSTATS = 10  # bits of outdegrees, references, blocks, intervals, residuals;
#              copied, intervalised, residual arcs; sum of depths, of refs
NBINS = 33   # each gap histogram (updateBins, BVGraph.java:1940-1944)
STATS = NSTATS + 2 * NBINS
ERR = STATS  # the kernel's error flag: the stats tensor holds STATS + 1
# enc_select (csrc/encode.cu SEL_C, SEL_ROUNDS, SEL_GAIN, SEL_WORDS):
# nodes a chunk; the most repair rounds; by how many a round must cut the
# chunks still changing for a third or later to run; the int64 words of
# its scratch's head (the three counts, the barrier, the rounds' tallies)
SELECT_CHUNK = 128
SELECT_ROUNDS = 16
SELECT_GAIN = 8
SELECT_WORDS = 32
CODINGS = (C.GAMMA, C.DELTA, C.ZETA, C.UNARY, C.GOLOMB, C.NIBBLE)
_I64 = torch.int64


# ----------------------------------------------------------------------
# Closed-form code lengths and patterns on int64 tensors (values < 2**48)
# ----------------------------------------------------------------------


def _bitlen(v):
    """Significant bits of each value (0 for 0), exact below 2**53."""
    return torch.frexp(v.to(torch.float64)).exponent.to(_I64)


def _pow2(s):
    return torch.bitwise_left_shift(torch.ones_like(s), s)


def _div(v, b):
    return torch.div(v, b, rounding_mode="floor")


def int2nat(x):
    """Zigzag (reference Fast.int2nat)."""
    return torch.where(x >= 0, 2 * x, -2 * x - 1)


def _gamma_len(v):
    return 2 * (_bitlen(v + 1) - 1) + 1


def _delta_len(v):
    h = _bitlen(v + 1) - 1
    return _gamma_len(h) + h


def _zeta_len(v, k):
    hb = _bitlen(v + 1) - 1
    hk = _div(hb, k) * k
    return _div(hb, k) + 1 + hk + k - 1 + (hb != hk).long()


def _golomb_len(v, b):
    s = b.bit_length() - 1
    q = _div(v, b)
    if b == 1 << s:
        return q + 1 + s
    return q + 1 + s + (torch.remainder(v, b) >= (2 << s) - b).long()


def _nibble_len(v):
    return 4 * _div(_bitlen(v).clamp(min=1) + 2, 3)


def make_len_fn(coding: int, k: int):
    """The code length of each value under ``coding`` (ζ_k; Golomb b = k)."""
    fns = {C.GAMMA: _gamma_len, C.DELTA: _delta_len,
           C.ZETA: lambda v: _zeta_len(v, k), C.UNARY: lambda v: v + 1,
           C.GOLOMB: lambda v: _golomb_len(v, k), C.NIBBLE: _nibble_len}
    if coding not in fns:
        raise ValueError(f"unsupported coding {coding}")
    return fns[coding]


def _gamma_pat(v):
    z = v + 1
    return z, 2 * (_bitlen(z) - 1) + 1


def _delta_pat(v):
    z = v + 1
    h = _bitlen(z) - 1
    low = torch.where(h > 0, z - _pow2(h), 0)
    return torch.bitwise_left_shift(h + 1, h) | low, _gamma_len(h) + h


def _zeta_pat(v, k):
    z = v + 1
    hb = _bitlen(z) - 1
    h = _div(hb, k)
    hk = h * k
    left = _pow2(hk)
    is_long = hb != hk
    mlen = hk + k - 1 + is_long.long()
    mb = torch.where(is_long, z, z - left)  # minimal binary, threshold left
    return _pow2(mlen) | mb, h + 1 + mlen


def _golomb_pat(v, b):
    s = b.bit_length() - 1
    q, r = _div(v, b), torch.remainder(v, b)
    if b == 1 << s:
        mb, mlen = r, torch.full_like(r, s)
    else:
        thr = (2 << s) - b
        long = r >= thr
        mb, mlen = torch.where(long, r + thr, r), s + long.long()
    return _pow2(mlen) | mb, q + 1 + mlen


def _nibble_pat(v):
    g = _div(_bitlen(v).clamp(min=1) + 2, 3)
    pat = torch.zeros_like(v)
    for j in range(16):  # v < 2**48: at most 16 groups, most significant first
        grp = g - 1 - j
        bits = torch.where(grp == 0, 8, 0) \
            | (torch.bitwise_right_shift(v, (3 * grp).clamp(min=0)) & 7)
        pat = torch.where(grp >= 0, (pat << 4) | bits, pat)
    return pat, 4 * g


def make_pat_fn(coding: int, k: int):
    """``(pattern, length)`` of each value under ``coding``: the code's last
    min(length, 64) bits, right-aligned (the leading bits past 64 of a long
    unary or Golomb code are zeros)."""
    fns = {C.GAMMA: _gamma_pat, C.DELTA: _delta_pat,
           C.ZETA: lambda v: _zeta_pat(v, k),
           C.UNARY: lambda v: (torch.ones_like(v), v + 1),
           C.GOLOMB: lambda v: _golomb_pat(v, k), C.NIBBLE: _nibble_pat}
    if coding not in fns:
        raise ValueError(f"unsupported coding {coding}")
    return fns[coding]


def _emit(acc, values, lens, positions, pat_fn, active):
    """Add the codes of ``values`` (``lens`` bits each, ending at
    ``positions + lens``) into the int64 word accumulator ``acc``: up to
    three disjoint 32-bit pieces a code (``bvgraph_jax_encode.py:623``)."""
    pat, _ = pat_fn(values)
    q = positions + lens
    last = _div(q + 31, 32) - 1
    for j in range(3):
        widx = last - j
        sh = q - 32 * (widx + 1)  # right shift of the right-aligned pattern
        right = torch.bitwise_right_shift(pat, sh.clamp(0, 63)) & 0xFFFFFFFF
        nsh = (-sh).clamp(0, 31)
        left = torch.bitwise_left_shift(pat & (_pow2(32 - nsh) - 1), nsh)
        piece = torch.where(sh >= 0, right, left)
        ok = active & (widx >= 0) & (sh < 64) & (sh > -32)
        acc.index_add_(0, widx[ok], piece[ok])


def _to_i32(acc):
    """uint32 values held in int64 -> the same bits as int32."""
    return (acc - ((acc >> 31) & 1) * (1 << 32)).to(torch.int32)


# ----------------------------------------------------------------------
# The arc-parallel structure (bvgraph_jax_encode.py:224-426)
# ----------------------------------------------------------------------


def arc_sources(off):
    """The source node of every arc of a CSR (int64)."""
    n = off.numel() - 1
    return torch.repeat_interleave(torch.arange(n, device=off.device),
                                   off[1:] - off[:-1])


def _seg_sum(vals, off):
    cp = torch.cat([vals.new_zeros(1), torch.cumsum(vals, 0)])
    return cp[off[1:]] - cp[off[:-1]]


def _member(keys, seg, q):
    """Is q[i] a successor of node seg[i]?  ``keys``: (node << 32) | succ,
    ascending (the lists are sorted)."""
    want = (seg << 32) | q
    idx = torch.searchsorted(keys, want)
    hit = keys[idx.clamp(max=keys.numel() - 1)] == want
    return (idx < keys.numel()) & hit


def _run_structure(mask, src, off):
    """Runs of equal ``mask`` within each list: (boundary, the run length
    of each arc's run, its run's index within the list)."""
    m = mask.numel()
    is_start = torch.arange(m, device=mask.device) == off[src]
    boundary = is_start | (mask != torch.cat([mask[:1], mask[:-1]]))
    rid1 = torch.cumsum(boundary.long(), 0)
    run_len = torch.zeros(m, dtype=_I64, device=mask.device).index_add_(
        0, rid1 - 1, torch.ones_like(rid1))
    return boundary, run_len[rid1 - 1], rid1 - rid1[off[src]]


def _extras_detail(off, succ, src, extras_mask, skey):
    """Every node's extras under ``extras_mask`` (``_extras_detail``
    ``:273``): counts, bit subtotals, and the intervals and residuals in
    node order, compacted."""
    res_c, zeta_k, minint = skey[4], skey[5], skey[7]
    n = off.numel() - 1
    res_len = make_len_fn(res_c, zeta_k)
    ev, en = succ[extras_mask], src[extras_mask]
    zero = torch.zeros(n, dtype=_I64, device=off.device)
    det = SimpleNamespace(extra_count=_seg_sum(extras_mask.long(), off),
                          int_count=zero, ic_bits=zero, iv_bits=zero,
                          iv_left=ev[:0], iv_len=ev[:0], iv_node=ev[:0])
    if minint != 0:
        p_ev = torch.cat([ev[:1] - 2, ev[:-1]])
        p_en = torch.cat([en[:1] - 1, en[:-1]])
        cons = (en != p_en) | (ev != p_ev + 1)
        crid = torch.cumsum(cons.long(), 0) - 1
        crun = torch.zeros_like(ev).index_add_(0, crid, torch.ones_like(ev))
        run_of_e = crun[crid]
        is_iv = run_of_e >= max(minint, 2)
        rep = cons & is_iv
        left, length, node = ev[rep], run_of_e[rep], en[rep]
        p_left = torch.cat([left[:1], left[:-1]])
        p_len = torch.cat([length[:1], length[:-1]])
        first = node != torch.cat([node.new_full((1,), -1), node[:-1]])
        det.iv_left, det.iv_len, det.iv_node = left, length, node
        det.iv_leftvals = torch.where(first, int2nat(left - node),
                                      left - (p_left + p_len) - 1)
        det.iv_lenvals = length - minint
        cost = _gamma_len(det.iv_leftvals) + _gamma_len(det.iv_lenvals)
        det.int_count = zero.clone().index_add_(0, node, torch.ones_like(node))
        det.iv_bits = zero.clone().index_add_(0, node, cost)
        det.ic_bits = _gamma_len(det.int_count)
        ev, en = ev[~is_iv], en[~is_iv]
    p_ev = torch.cat([ev[:1], ev[:-1]])
    det.res_first = en != torch.cat([en.new_full((1,), -1), en[:-1]])
    det.res_vals = torch.where(det.res_first, int2nat(ev - en), ev - p_ev - 1)
    det.res_gaps = torch.where(det.res_first, int2nat(ev - en), ev - p_ev)
    det.res_node = en
    det.res_count = zero.clone().index_add_(0, en, torch.ones_like(en))
    det.res_bits = zero.clone().index_add_(0, en, res_len(det.res_vals))
    return det


def _extras_cost(det, minint):
    cost = det.res_bits
    if minint != 0:
        cost = cost + det.ic_bits + det.iv_bits
    return torch.where(det.extra_count > 0, cost, 0)


def _blocks_of(mask, src, off, blk_len):
    """The copy blocks each node ``z`` gives a list whose members among
    z's successors are ``mask`` (``_block_cost`` ``:402``): per node the
    block bits, the block count and the copied arcs; per arc the run
    structure (boundary, is_last, jl, the block value) and per node
    virt0 (the list starts with a skip run, so block 0 is an empty copy)."""
    m = mask.numel()
    d = off[1:] - off[:-1]
    boundary, run_len, jl = _run_structure(mask, src, off)
    k = _seg_sum(boundary.long(), off)
    s1 = mask[off[:-1].clamp(max=m - 1)] & (d > 0)
    is_last = jl == k[src] - 1
    bval = run_len - ((jl >= 1) | ~s1[src]).long()
    body = _seg_sum(torch.where(boundary & ~is_last, blk_len(bval), 0), off)
    virt0 = ~s1 & (d > 0)
    bits = body + torch.where(virt0, blk_len(torch.zeros_like(d)), 0)
    count = torch.where(d > 0, k - 1 + virt0.long(), 0)
    return SimpleNamespace(bits=bits, count=count,
                           copied=_seg_sum(mask.long(), off),
                           boundary=boundary, is_last=is_last, jl=jl,
                           bval=bval, virt0=virt0)


def _shifted(arr, r, n):
    """``out[x] = arr[x - r]`` (0 for x < r)."""
    pad = min(r, n)
    return torch.cat([arr.new_zeros(pad), arr[: n - pad]])


def _csr_keys(succ, src):
    """(node << 32) | successor of every arc: ascending over a CSR whose
    lists are sorted, so ``torch.searchsorted`` finds an arc."""
    return (src << 32) | succ.long()


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------


def enc_costs_plain(off, succ, skey, shard_start=0, src=None):
    """:func:`enc_costs` in plain PyTorch, on any device: the JAX
    ``compute_costs`` (``:449``) arc-parallel, shift by shift."""
    ref_c, bcc, blk_c, zeta_k, w = skey[1], skey[2], skey[3], skey[5], skey[6]
    minint = skey[7]
    n = off.numel() - 1
    off = off.long()
    src = arc_sources(off) if src is None else src.long()
    sc = succ.long()
    keys = _csr_keys(sc, src)
    d = off[1:] - off[:-1]
    ref_len = make_len_fn(ref_c, zeta_k)
    bcc_len, blk_len = make_len_fn(bcc, zeta_k), make_len_fn(blk_c, zeta_k)
    nodes = torch.arange(n, device=off.device)
    every = torch.ones_like(sc, dtype=torch.bool)
    ec0 = _extras_cost(_extras_detail(off, sc, src, every, skey), minint)
    base = ref_len(torch.zeros_like(d)) if w > 0 else 0
    costs, valids = [base + ec0], [d > 0]
    for r in range(1, w + 1):
        cand = src - r
        in_ref = _member(keys, cand.clamp(min=0), sc) & (cand >= shard_start)
        ec = _extras_cost(_extras_detail(off, sc, src, ~in_ref, skey), minint)
        tgt = src + r
        copied = _member(keys, tgt.clamp(max=n - 1), sc) & (tgt < n)
        bl = _blocks_of(copied, src, off, blk_len)
        bcost = _shifted(bcc_len(bl.count) + bl.bits, r, n)
        costs.append(ref_len(torch.full_like(d, r)) + bcost + ec)
        valids.append((nodes - r >= shard_start) & (_shifted(d, r, n) > 0)
                      & (d > 0))
    return (torch.stack(costs, 1).to(torch.int32),
            torch.stack(valids, 1))


def enc_select_plain(costs, valid, maxref):
    """:func:`enc_select` as a host loop over the rows (the JAX
    ``select_references`` scan, ``:487``); returns tensors on the input's
    device."""
    n, cbs = costs.shape
    rows = np.where(valid.cpu().numpy(), costs.cpu().numpy(), -1).tolist()
    ring = [0] * cbs
    refs = np.zeros(n, dtype=np.int32)
    depths = np.zeros(n, dtype=np.int32)
    for x, row in enumerate(rows):
        xm = x % cbs
        best, best_r, best_dep = -1, 0, -1
        for r, cr in enumerate(row):
            if cr >= 0 and (best < 0 or cr < best):
                dr = ring[xm - r]  # (x - r) mod cbs, as a negative index
                if r == 0 or dr < maxref:
                    best, best_r, best_dep = cr, r, dr if r else -1
        ring[xm] = best_dep + 1
        refs[x], depths[x] = best_r, best_dep + 1
    return (torch.from_numpy(refs).to(costs.device),
            torch.from_numpy(depths).to(costs.device))


def chosen_structure(off, succ, refs, skey, src=None):
    """Each node's record for its chosen reference (``_chosen_structure``
    ``:520``), arc-parallel: per node the bits of each part (``node_bits``
    their sum), block counts, copied arcs, the extras' detail, and the
    blocks in node order (``blk_node``, ``blk_val``)."""
    outd_c, ref_c, bcc, blk_c, _, zeta_k, w, minint, _ = skey
    n = off.numel() - 1
    off = off.long()
    src = arc_sources(off) if src is None else src.long()
    sc, refs = succ.long(), refs.long()
    keys = _csr_keys(sc, src)
    d = off[1:] - off[:-1]
    blk_len = make_len_fn(blk_c, zeta_k)
    has_ref = (refs > 0) & (d > 0)
    cand = src - refs[src]
    in_ref = _member(keys, cand.clamp(min=0), sc) & has_ref[src]
    det = _extras_detail(off, sc, src, ~in_ref, skey)
    zero = torch.zeros(n, dtype=_I64, device=off.device)
    blk_bits, block_count, copied = zero, zero, zero
    bx, bj, bv = [zero[:0]], [zero[:0]], [zero[:0]]  # node, index, value
    for r in range(1, w + 1):
        tgt = src + r
        tc = tgt.clamp(max=n - 1)
        sel_x = refs == r
        mask = _member(keys, tc, sc) & (tgt < n) & sel_x[tc]
        bl = _blocks_of(mask, src, off, blk_len)
        sel_z = torch.cat([sel_x[r:], sel_x.new_zeros(min(r, n))])
        blk_bits = blk_bits + _shifted(torch.where(sel_z, bl.bits, 0), r, n)
        block_count = block_count + _shifted(torch.where(sel_z, bl.count, 0),
                                             r, n)
        copied = copied + _shifted(torch.where(sel_z, bl.copied, 0), r, n)
        okb = bl.boundary & ~bl.is_last & sel_z[src]
        bx.append(tgt[okb])
        bj.append((bl.jl + bl.virt0[src].long())[okb])
        bv.append(bl.bval[okb])
        z = torch.nonzero(bl.virt0 & sel_z).view(-1)  # block 0 is empty
        bx.append(z + r)
        bj.append(torch.zeros_like(z))
        bv.append(torch.zeros_like(z))
    gate = (det.extra_count > 0) & (d > 0)
    st = SimpleNamespace(d=d, det=det, gate=gate, has_ref=has_ref)
    st.len_outd = make_len_fn(outd_c, zeta_k)(d)
    st.len_ref = torch.where(d > 0, make_len_fn(ref_c, zeta_k)(refs), 0) \
        if w > 0 else zero
    st.block_count = torch.where(has_ref, block_count, 0)
    st.len_bcnt = torch.where(has_ref, make_len_fn(bcc, zeta_k)(block_count),
                              0)
    st.blk_bits = torch.where(has_ref, blk_bits, 0)
    st.copied = torch.where(has_ref, copied, 0)
    st.int_bits = torch.where(gate, det.ic_bits + det.iv_bits, 0) \
        if minint != 0 else zero
    st.res_bits = torch.where(gate, det.res_bits, 0)
    st.node_bits = (st.len_outd + st.len_ref + st.len_bcnt + st.blk_bits
                    + st.int_bits + st.res_bits)
    bx, bj, bv = torch.cat(bx), torch.cat(bj), torch.cat(bv)
    order = torch.argsort(bx * (int(d.max()) + 2) + bj) if bx.numel() else bx
    st.blk_node, st.blk_val = bx[order], bv[order]
    return st


def _within(lens, node, n):
    """Each item's bit offset within its node's run of items (the items
    in node order, ``node`` their nodes)."""
    cp = torch.cumsum(lens, 0) - lens
    count = torch.zeros(n, dtype=_I64, device=lens.device).index_add_(
        0, node, torch.ones_like(node))
    first = torch.cumsum(count, 0) - count
    return cp - cp[first[node]] if lens.numel() else cp


def _stats_of(st, off, succ, refs, depths, minint):
    det = st.det
    src = arc_sources(off)
    sc = succ.long()
    gate = st.gate
    iv_arcs = torch.where(gate, det.extra_count - det.res_count, 0).sum() \
        if minint != 0 else st.d.new_zeros(())
    counters = torch.stack([
        st.len_outd.sum(), st.len_ref.sum(), (st.len_bcnt + st.blk_bits).sum(),
        st.int_bits.sum(), st.res_bits.sum(), st.copied.sum(), iv_arcs,
        torch.where(gate, det.res_count, 0).sum(), depths.long().sum(),
        refs.long().sum()])
    first = torch.arange(sc.numel(), device=sc.device) == off[src]
    sgap = torch.where(first, int2nat(sc - src),
                       sc - torch.cat([sc[:1], sc[:-1]]))

    def hist(g):
        g = g[g > 0]
        return torch.bincount((_bitlen(g) - 1).clamp(max=32),
                              minlength=NBINS)[:NBINS]

    return torch.cat([counters, hist(sgap), hist(det.res_gaps)])


def _emit_graph_plain(st, acc, starts, refs, skey):
    outd_c, ref_c, bcc, blk_c, res_c, zeta_k, w, minint, _ = skey
    det, d, gate = st.det, st.d, st.gate
    n = d.numel()
    pos = starts[:n].clone()
    _emit(acc, d, st.len_outd, pos, make_pat_fn(outd_c, zeta_k),
          torch.ones_like(gate))
    pos += st.len_outd
    if w > 0:
        _emit(acc, refs.long(), st.len_ref, pos, make_pat_fn(ref_c, zeta_k),
              d > 0)
        pos += st.len_ref
    _emit(acc, st.block_count, st.len_bcnt, pos, make_pat_fn(bcc, zeta_k),
          st.has_ref)
    pos += st.len_bcnt
    blens = make_len_fn(blk_c, zeta_k)(st.blk_val)
    _emit(acc, st.blk_val, blens,
          pos[st.blk_node] + _within(blens, st.blk_node, n),
          make_pat_fn(blk_c, zeta_k), torch.ones_like(st.blk_val, dtype=bool))
    pos += st.blk_bits
    if minint != 0:
        ic = torch.where(gate, det.int_count, 0)
        _emit(acc, ic, det.ic_bits, pos, _gamma_pat, gate)
        pos += torch.where(gate, det.ic_bits, 0)
        llen = _gamma_len(det.iv_leftvals)
        nlen = _gamma_len(det.iv_lenvals)
        ppos = pos[det.iv_node] + _within(llen + nlen, det.iv_node, n)
        every = torch.ones_like(llen, dtype=bool)
        _emit(acc, det.iv_leftvals, llen, ppos, _gamma_pat, every)
        _emit(acc, det.iv_lenvals, nlen, ppos + llen, _gamma_pat, every)
        pos += torch.where(gate, det.iv_bits, 0)
    rlens = make_len_fn(res_c, zeta_k)(det.res_vals)
    _emit(acc, det.res_vals, rlens,
          pos[det.res_node] + _within(rlens, det.res_node, n),
          make_pat_fn(res_c, zeta_k), torch.ones_like(rlens, dtype=bool))


def offset_positions(node_bits, offset_coding, zeta_k):
    """Where each ``.offsets`` code starts: the codes of ``[0,
    node_bits...]`` one after the other, and their end (int64[n + 2])."""
    vals = torch.cat([node_bits.new_zeros(1), node_bits.long()])
    lens = make_len_fn(offset_coding, zeta_k)(vals)
    return torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])


def enc_emit_plain(off, succ, refs, depths, starts, skey, stats, *,
                   words=None, opos=None, owords=None, offset_coding=None):
    """:func:`enc_emit` in plain PyTorch, on any device:
    :func:`chosen_structure`, then every code as ``index_add_`` of
    disjoint-bit int64 pieces.  A node whose record is not
    ``starts[x + 1] - starts[x]`` bits long sets the error flag, as the
    kernel does."""
    zeta_k = skey[5]
    stats.zero_()
    if words is not None:
        st = chosen_structure(off, succ, refs, skey)
        if not torch.equal(st.node_bits, starts[1:] - starts[:-1]):
            stats[ERR] = 1
        acc = torch.zeros(words.numel(), dtype=_I64, device=words.device)
        _emit_graph_plain(st, acc, starts.long(), refs, skey)
        words.copy_(_to_i32(acc))
        stats[:STATS] = _stats_of(st, off.long(), succ, refs, depths, skey[7])
    if owords is not None:
        nb = starts[1:] - starts[:-1]
        vals = torch.cat([nb.new_zeros(1), nb]).long()
        lens = make_len_fn(offset_coding, zeta_k)(vals)
        if not torch.equal(opos[1:] - opos[:-1], lens):
            stats[ERR] = stats[ERR] | 4
        acc = torch.zeros(owords.numel(), dtype=_I64, device=owords.device)
        _emit(acc, vals, lens, opos[:-1].long(),
              make_pat_fn(offset_coding, zeta_k),
              torch.ones_like(vals, dtype=bool))
        owords.copy_(_to_i32(acc))


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------


def _check(what, dev, **tensors):
    """Raise ValueError unless each tensor (dtype, dims) is contiguous on
    ``dev``, a CPU or CUDA device."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, (t, dtype, dims) in tensors.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or t.dim() != dims \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dims}-d "
                             f"{dtype} tensor on {dev}")


def _check_skey(what, skey, codings=None):
    codings = skey[:5] if codings is None else codings
    if any(c not in CODINGS for c in codings) or skey[5] < 1 \
            or skey[6] < 0 or skey[7] < 0:
        raise ValueError(f"{what}: unsupported settings {skey}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def enc_costs(off, succ, skey, shard_start=0, src=None):
    """Every (node, shift) cost of the CSR ``(off int64[n+1], succ
    int32[m])`` under ``skey`` (``formats/bvgraph_encode.skey_of``):
    ``(costs int32[n, w+1], valid bool[n, w+1])``, as the JAX
    ``compute_costs``.  Shifts reaching before ``shard_start`` are no
    candidates.  CPU tensors take :func:`enc_costs_plain`; CUDA tensors
    launch ``enc_costs`` once, counted in ``enc_costs.launches``."""
    dev = off.device
    _check("enc_costs", dev, off=(off, torch.int64, 1),
           succ=(succ, torch.int32, 1))
    _check_skey("enc_costs", skey)
    n = off.numel() - 1
    if n < 1:
        raise ValueError("enc_costs: the graph has no nodes")
    if dev.type == "cpu":
        return enc_costs_plain(off, succ, skey, shard_start, src)
    w = skey[6]
    costs = torch.empty((n, w + 1), dtype=torch.int32, device=dev)
    valid = torch.empty((n, w + 1), dtype=torch.bool, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_enc_costs(
            off.data_ptr(), succ.data_ptr(), n, *skey[:8], int(shard_start),
            costs.data_ptr(), valid.data_ptr(), _stream(dev))
    _build.check_launch("wgt_enc_costs", rc)
    enc_costs.launches += 1
    return costs, valid


enc_costs.launches = 0


def enc_select(costs, valid, maxref):
    """Each node's reference and chain depth (``refs``, ``depths``,
    ``int32[n]``) from :func:`enc_costs`' output under ``maxref``, as the
    JAX ``select_references``.  CPU tensors take :func:`enc_select_plain`;
    CUDA tensors launch ``enc_select`` once (chunks of
    :data:`SELECT_CHUNK` nodes in parallel, repaired from their
    predecessors' depths), counted in ``enc_select.launches``.

    ``enc_select.last_counts`` is then the call's int64[3] on its device,
    never read here: repair rounds run, nodes re-run by the rounds'
    repairs and nodes re-run by the serial walk that follows rounds which
    stop settling (zeros on the CPU)."""
    dev = costs.device
    _check("enc_select", dev, costs=(costs, torch.int32, 2),
           valid=(valid, torch.bool, 2))
    if valid.shape != costs.shape or costs.shape[0] < 1:
        raise ValueError("enc_select: costs and valid must be one non-empty "
                         "[n, w+1] shape")
    if dev.type == "cpu":
        enc_select.last_counts = torch.zeros(3, dtype=_I64)
        return enc_select_plain(costs, valid, maxref)
    n, cbs = costs.shape
    refs = torch.empty(n, dtype=torch.int32, device=dev)
    depths = torch.empty(n, dtype=torch.int32, device=dev)
    nch = -(-n // SELECT_CHUNK)
    words = SELECT_WORDS + (nch * (2 * cbs - 1) + 1) // 2
    scratch = torch.zeros(words, dtype=_I64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_enc_select(costs.data_ptr(), valid.data_ptr(), n, cbs - 1,
                                int(maxref), refs.data_ptr(),
                                depths.data_ptr(), scratch.data_ptr(), words,
                                _stream(dev))
    _build.check_launch("wgt_enc_select", rc)
    enc_select.launches += 1
    enc_select.last_counts = scratch[:3]
    return refs, depths


enc_select.launches = 0
enc_select.last_counts = None


def enc_emit(off, succ, refs, depths, starts, skey, stats, *, words=None,
             opos=None, owords=None, offset_coding=None):
    """Write the records of the CSR ``(off, succ)`` for ``refs`` (with
    ``depths``) at ``starts`` (int64[n+1]) into ``words`` (zeroed int32),
    and the ``.offsets`` codes (``offset_coding``) of ``[0, node bits...]``
    at ``opos`` (int64[n+2], :func:`offset_positions`) into ``owords``
    (zeroed int32); either may be None.  ``stats`` (int64[STATS + 1],
    zeroed) gets the counters, both gap histograms and the error flag
    (nonzero: a record or code not where ``starts`` or ``opos`` put it).
    CPU tensors take :func:`enc_emit_plain`; CUDA tensors launch
    ``enc_emit`` once, counted in ``enc_emit.launches``, and read nothing
    back."""
    dev = starts.device
    n = starts.numel() - 1
    i32, i64 = torch.int32, torch.int64
    graph = words is not None
    _check("enc_emit", dev, starts=(starts, i64, 1), stats=(stats, i64, 1),
           words=(words, i32, 1), owords=(owords, i32, 1),
           opos=(opos, i64, 1) if owords is not None else (None, i64, 1),
           **({"off": (off, i64, 1), "succ": (succ, i32, 1),
               "refs": (refs, i32, 1), "depths": (depths, i32, 1)}
              if graph else {}))
    if graph:
        _check_skey("enc_emit", skey)
    if owords is not None:
        _check_skey("enc_emit", skey, codings=(offset_coding,))
        if opos is None or opos.numel() != n + 2:
            raise ValueError("enc_emit: opos must hold n + 2 positions")
    if n < 1 or stats.numel() != STATS + 1 \
            or (graph and (off.numel() != n + 1 or refs.numel() != n
                           or depths.numel() != n)):
        raise ValueError("enc_emit: sizes disagree")
    if dev.type == "cpu":
        return enc_emit_plain(off, succ, refs, depths, starts, skey, stats,
                              words=words, opos=opos, owords=owords,
                              offset_coding=offset_coding)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_enc_emit(
            ptr(off) if graph else None, ptr(succ) if graph else None,
            ptr(refs) if graph else None, ptr(depths) if graph else None,
            starts.data_ptr(), n, *skey[:8], ptr(words), ptr(opos),
            int(offset_coding or 0), ptr(owords), stats.data_ptr(),
            _stream(dev))
    _build.check_launch("wgt_enc_emit", rc)
    enc_emit.launches += 1


enc_emit.launches = 0
