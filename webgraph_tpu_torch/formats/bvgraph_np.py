"""Vectorized lane-parallel BVGraph bulk decoder (NumPy host version).

This is the TPU-shaped decode algorithm: instead of walking the bitstream
node-by-node (reference BVGraphNodeIterator, BVGraph.java:1136-1281), every
node's record is decoded *in parallel* — each lane owns one node's bit cursor
(start positions come from the offsets index) and the variable-length codes
are decoded with 64-bit window gathers + count-leading-zeros, one code per
lane per step.  Reference chains are then resolved with data-parallel rounds
of copy-block mask expansion + segmented merges, replacing the reference's
recursive lazy-iterator tree (BVGraph.java:1100-1126).

Phases:
  1. header parse  — outdegree / reference / copy blocks / intervals
                     (lane-parallel; ragged outputs via exclusive prefix sums)
  2. residuals     — the hot loop: nodes sorted by residual count so the
                     active lane set is always a prefix (arc-balanced)
  3. assembly      — interval expansion + residual merge (lexsort)
  4. chain rounds  — depth-ordered copy-mask application (segmented
                     run-length parity) and merge into the final CSR

The JAX package's device decoder (``webgraph_tpu/formats/bvgraph_jax.py``) mirrors these phases 1:1.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits import vcodes as V


def compute_sizes(g) -> dict:
    """Host-side computation of the static buffer sizes the device decoder
    needs (see the JAX package's bvgraph_jax.decode_to_csr) — a light scan of the stream."""
    offsets, succ, sizes = _decode_impl(g, want_sizes=True)
    return sizes


def decode_to_csr(g) -> tuple[np.ndarray, np.ndarray]:
    """Decode a loaded BVGraph into ``(offsets, successors)`` CSR arrays."""
    offsets, succ, _ = _decode_impl(g, want_sizes=False)
    return offsets, succ


def _decode_impl(g, want_sizes: bool):
    if g.bit_offsets is None:
        raise NotImplementedError("bulk vectorized decode requires the offsets index")
    s = g.settings
    n = g.num_nodes()
    # sentinel words so 64-bit window peeks never run off the stream end
    from webgraph_tpu_torch.bits.bitstream import as_u64_words

    words = np.concatenate([as_u64_words(g._words), np.zeros(2, dtype=np.uint64)])
    if n == 0:
        return np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int32), {}

    read_outd = V.make_reader(s.outdegree_coding, s.zeta_k)
    read_ref = V.make_reader(s.reference_coding, s.zeta_k)
    read_bcnt = V.make_reader(s.block_count_coding, s.zeta_k)
    read_block = V.make_reader(s.block_coding, s.zeta_k)
    read_res = V.make_reader(s.residual_coding, s.zeta_k)

    pos = g.bit_offsets[:n].astype(np.int64).copy()

    # ---- Phase 1a: outdegrees ----------------------------------------
    d, pos = read_outd(words, pos)
    nonempty = d > 0

    # ---- Phase 1b: references ----------------------------------------
    ref = np.full(n, -1, dtype=np.int64)
    if s.window_size > 0:
        idx = np.flatnonzero(nonempty)
        r, p = read_ref(words, pos[idx])
        ref[idx] = r
        pos[idx] = p
    has_ref = ref > 0

    # ---- Phase 1c: copy blocks ---------------------------------------
    block_count = np.zeros(n, dtype=np.int64)
    idx = np.flatnonzero(has_ref)
    if len(idx):
        bc, p = read_bcnt(words, pos[idx])
        block_count[idx] = bc
        pos[idx] = p
    block_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(block_count, out=block_start[1:])
    blocks = np.zeros(block_start[-1], dtype=np.int64)
    copied = np.zeros(n, dtype=np.int64)
    total_blocks = np.zeros(n, dtype=np.int64)
    if len(idx):
        # decode blocks step-by-step over lanes still having blocks to read;
        # sort by block count so the active set is a prefix
        order = idx[np.argsort(-block_count[idx], kind="stable")]
        counts = block_count[order]
        max_bc = int(counts[0]) if len(counts) else 0
        lane_pos = pos[order].copy()
        for step in range(max_bc):
            k = int(np.searchsorted(-counts, -step, side="left"))
            if k == 0:
                break
            active = order[:k]
            b, p = read_block(words, lane_pos[:k])
            lane_pos[:k] = p
            v = b + (0 if step == 0 else 1)
            blocks[block_start[active] + step] = v
            total_blocks[active] += v
            if step % 2 == 0:
                copied[active] += v
        pos[order] = lane_pos
        # implicit tail copy when the block count is even
        even = np.flatnonzero(has_ref & ((block_count & 1) == 0))
        copied[even] += d[even - ref[even]] - total_blocks[even]

    extra_count = np.where(has_ref, d - copied, d)
    extra_count[~nonempty] = 0

    # ---- Phase 1d: intervals -----------------------------------------
    int_count = np.zeros(n, dtype=np.int64)
    if s.min_interval_length != 0:
        idx = np.flatnonzero(extra_count > 0)
        if len(idx):
            ic, p = V.read_gamma(words, pos[idx])
            int_count[idx] = ic
            pos[idx] = p
    int_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(int_count, out=int_start[1:])
    int_left = np.zeros(int_start[-1], dtype=np.int64)
    int_len = np.zeros(int_start[-1], dtype=np.int64)
    interval_arcs = np.zeros(n, dtype=np.int64)
    idx = np.flatnonzero(int_count > 0)
    if len(idx):
        order = idx[np.argsort(-int_count[idx], kind="stable")]
        counts = int_count[order]
        max_ic = int(counts[0])
        lane_pos = pos[order].copy()
        prev = np.zeros(len(order), dtype=np.int64)
        for step in range(max_ic):
            k = int(np.searchsorted(-counts, -step, side="left"))
            if k == 0:
                break
            active = order[:k]
            lraw, p = V.read_gamma(words, lane_pos[:k])
            if step == 0:
                left = active + V.nat2int(lraw)
            else:
                left = lraw + prev[:k] + 1
            ln, p2 = V.read_gamma(words, p)
            ln = ln + s.min_interval_length
            lane_pos[:k] = p2
            int_left[int_start[active] + step] = left
            int_len[int_start[active] + step] = ln
            prev[:k] = left + ln
            interval_arcs[active] += ln
        pos[order] = lane_pos

    residual_count = extra_count - interval_arcs

    # ---- Phase 2: residuals (hot loop, arc-balanced prefix) ----------
    res_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(residual_count, out=res_start[1:])
    residuals = np.zeros(res_start[-1], dtype=np.int64)
    idx = np.flatnonzero(residual_count > 0)
    if len(idx):
        order = idx[np.argsort(-residual_count[idx], kind="stable")]
        counts = residual_count[order]
        max_rc = int(counts[0])
        lane_pos = pos[order].copy()
        prev = np.zeros(len(order), dtype=np.int64)
        for step in range(max_rc):
            k = int(np.searchsorted(-counts, -step, side="left"))
            if k == 0:
                break
            active = order[:k]
            v, p = read_res(words, lane_pos[:k])
            lane_pos[:k] = p
            if step == 0:
                val = active + V.nat2int(v)
            else:
                val = prev[:k] + v + 1
            residuals[res_start[active] + step] = val
            prev[:k] = val
        pos[order] = lane_pos

    # ---- Phase 3: assemble extras (intervals ∪ residuals) ------------
    # expand intervals into explicit arcs
    tot_int_arcs = int(int_len.sum())
    if tot_int_arcs:
        seg = np.repeat(np.arange(len(int_len)), int_len)
        within = np.arange(tot_int_arcs) - np.repeat(np.concatenate([[0], np.cumsum(int_len)[:-1]]), int_len)
        int_vals = int_left[seg] + within
        # node of each interval-arc = node of its interval
        node_of_interval = np.repeat(np.arange(n), int_count)
        int_nodes = node_of_interval[seg]
    else:
        int_vals = np.zeros(0, dtype=np.int64)
        int_nodes = np.zeros(0, dtype=np.int64)
    res_nodes = np.repeat(np.arange(n), residual_count)
    extra_nodes = np.concatenate([int_nodes, res_nodes])
    extra_vals = np.concatenate([int_vals, residuals])
    order = np.lexsort((extra_vals, extra_nodes))
    extra_nodes = extra_nodes[order]
    extra_vals = extra_vals[order]
    extra_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(extra_count, out=extra_start[1:])

    # ---- Phase 4: resolve reference chains in depth rounds -----------
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(d, out=offsets[1:])
    out = np.zeros(offsets[-1], dtype=np.int64)

    parent = np.where(has_ref, np.arange(n) - ref, -1)
    depth = np.where(has_ref, -1, 0)
    rounds = 0
    while True:
        unresolved = depth < 0
        if not unresolved.any():
            break
        promote = unresolved & (depth[np.maximum(parent, 0)] >= 0) & (parent >= 0)
        if not promote.any():
            raise ValueError("cyclic reference chain in BVGraph stream")
        depth[promote] = depth[parent[promote]] + 1
        rounds += 1

    if want_sizes:
        n_rounds = int(depth.max()) + 1
        dp = np.where(has_ref, d[np.maximum(parent, 0)], 0)
        c_hist = tuple(int(dp[depth == t].sum()) for t in range(n_rounds))
        e_hist = tuple(int(extra_count[depth == t].sum()) for t in range(n_rounds))
        sizes = {
            "total_blocks": int(block_start[-1]),
            "m": int(offsets[-1]),
            "total_ints": int(int_start[-1]),
            "total_res": int(res_start[-1]),
            "tot_int_arcs": int(int_len.sum()),
            "max_depth": int(depth.max()),
            "P": int(d[parent[has_ref]].sum()),
            "n_items_blocks": int((block_count > 0).sum()),
            "n_items_ints": int((int_count > 0).sum()),
            "n_items_res": int((residual_count > 0).sum()),
            # items whose code count exceeds the heavy threshold serialize a
            # work-queue lane for many trips; the device decoder runs them in
            # a separate narrow-lane tier so they don't stall the wide tier
            "n_heavy_blocks": int((block_count > 64).sum()),
            "n_heavy_ints": int((int_count > 64).sum()),
            "n_heavy_res": int((residual_count > 64).sum()),
            "c_hist": c_hist,
            "e_hist": e_hist,
        }
        return offsets, None, sizes

    # round 0: no-reference nodes — extras are the whole list
    for t in range(rounds + 1):
        nodes_t = np.flatnonzero((depth == t) & nonempty)
        if len(nodes_t) == 0:
            continue
        if t == 0:
            # scatter extras straight into the CSR slots
            cnt = extra_count[nodes_t]
            tgt = _ragged_positions(offsets[nodes_t], cnt)
            src = _ragged_positions(extra_start[nodes_t], cnt)
            out[tgt] = extra_vals[src]
            continue
        # gather parent lists, apply copy-block masks
        par = parent[nodes_t]
        dp = d[par]
        tot = int(dp.sum())
        seg_id = np.repeat(np.arange(len(nodes_t)), dp)
        seg_base = np.concatenate([[0], np.cumsum(dp)[:-1]])
        within = np.arange(tot) - seg_base[seg_id]
        parent_vals = out[offsets[par][seg_id] + within]
        # run-length parity: a boundary at within-position c means elements
        # at indices >= c start a new copy/skip run. Note block[0] may be 0
        # (boundary at position 0), so the per-segment reset must be an
        # EXCLUSIVE prefix at the segment start.
        bc = block_count[nodes_t]
        boundary_flags = np.zeros(tot + 1, dtype=np.int64)
        if bc.sum():
            b_nodes = np.repeat(np.arange(len(nodes_t)), bc)
            b_idx = _ragged_positions(block_start[nodes_t], bc)
            b_cum = _segmented_cumsum(blocks[b_idx], b_nodes)
            # a boundary landing exactly at the segment end affects nothing
            # (and would leak into the next segment's flat position)
            valid = b_cum < dp[b_nodes]
            np.add.at(boundary_flags, (seg_base[b_nodes] + b_cum)[valid], 1)
        if tot:
            cs = np.cumsum(boundary_flags[:tot])
            seg_excl = cs[seg_base] - boundary_flags[seg_base]  # exclusive prefix at segment start
            runs = cs - seg_excl[seg_id]
            keep = (runs & 1) == 0
            kept_vals = parent_vals[keep]
            kept_nodes = nodes_t[seg_id[keep]]
        else:
            kept_vals = np.zeros(0, dtype=np.int64)
            kept_nodes = np.zeros(0, dtype=np.int64)
        # merge kept parent values with extras of these nodes
        cnt = extra_count[nodes_t]
        src = _ragged_positions(extra_start[nodes_t], cnt)
        ex_vals = extra_vals[src]
        ex_nodes = nodes_t[np.repeat(np.arange(len(nodes_t)), cnt)]
        all_nodes = np.concatenate([kept_nodes, ex_nodes])
        all_vals = np.concatenate([kept_vals, ex_vals])
        o = np.lexsort((all_vals, all_nodes))
        all_nodes = all_nodes[o]
        all_vals = all_vals[o]
        # scatter: positions are CSR slot + rank within node
        cnts = d[nodes_t]
        assert len(all_nodes) == int(cnts.sum()), (
            f"round {t}: assembled {len(all_nodes)} arcs, expected {int(cnts.sum())}"
        )
        tgt = _ragged_positions(offsets[nodes_t], cnts)
        out[tgt] = all_vals

    return offsets, out.astype(np.int32), None


def _ragged_positions(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat positions [starts[i], starts[i]+counts[i]) concatenated."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    seg = np.repeat(np.arange(len(starts)), counts)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - base[seg]
    return starts[seg] + within


def _segmented_cumsum(vals: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Inclusive cumsum of ``vals`` resetting at each new segment id."""
    if len(vals) == 0:
        return vals
    cs = np.cumsum(vals)
    first = np.ones(len(vals), dtype=bool)
    first[1:] = seg[1:] != seg[:-1]
    starts = np.flatnonzero(first)
    base = np.zeros(len(vals), dtype=vals.dtype)
    base[starts[1:]] = cs[starts[1:] - 1]
    np.maximum.accumulate(base, out=base)
    return cs - base
