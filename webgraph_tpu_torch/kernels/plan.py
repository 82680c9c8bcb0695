"""Host structure scan of a stored BVGraph.

A copy of ``StructureScan`` and ``scan_structure`` from the JAX package's
``webgraph_tpu/pallas/plan.py`` (its ``plan_blocks`` partitions nodes for
TPU VMEM and has no counterpart here).  A vectorized host scan of the
structure codes (outdegree, reference, block count, blocks, interval
count) yields per-node counts and the global reference-chain depth, from
which the depth levels of K1 and K2 (``kernels/levels.py``) are derived.
Same logic as phase 1 of
``formats/bvgraph_np.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from webgraph_tpu_torch.bits import vcodes as V


@dataclass
class StructureScan:
    """Per-node structural counts from the host pre-scan."""

    d: np.ndarray            # outdegree
    ref: np.ndarray          # reference (-1 = none, 0 = explicit none)
    block_count: np.ndarray  # copy-block count
    int_count: np.ndarray    # interval count
    res_count: np.ndarray    # residual count
    copied: np.ndarray       # arcs copied from the parent list
    depth: np.ndarray        # global reference-chain depth
    pos_after_ic: np.ndarray  # bit cursor after the interval-count code


def chain_roots(ref) -> tuple[np.ndarray, np.ndarray]:
    """``(root, depth)`` of each node's reference chain: the node with no
    reference that the chain ends at (the node itself when ``ref[x] <=
    0``) and the number of references followed to reach it.  A parent
    lies before its node, so doubling the steps ancestor by ancestor
    (``anc[anc]``) reaches every root in log2(depth) rounds of a gather
    over the nodes.  Raises ``ValueError`` where a chain leads before node
    0."""
    n = ref.size
    ids = np.arange(n, dtype=np.int64)
    has_ref = ref > 0
    anc = np.where(has_ref, ids - ref, ids)
    if (anc < 0).any():
        raise ValueError("cyclic reference chain")
    depth = has_ref.astype(np.int64)
    while True:
        up = anc[anc]
        if np.array_equal(up, anc):
            return anc, depth
        depth += depth[anc]
        anc = up


def scan_structure(g) -> StructureScan:
    """Vectorized host scan of all structure codes (no residual decode)."""
    s = g.settings
    n = g.num_nodes()
    from webgraph_tpu_torch.bits.bitstream import as_u64_words

    words = np.concatenate([as_u64_words(g._words), np.zeros(2, dtype=np.uint64)])
    bo = g.bit_offsets  # decoded from the succinct index once
    if bo is None:
        raise ValueError("the structure scan requires the offsets index")
    pos = bo[:n].astype(np.int64).copy()

    read_outd = V.make_reader(s.outdegree_coding, s.zeta_k)
    read_ref = V.make_reader(s.reference_coding, s.zeta_k)
    read_bcnt = V.make_reader(s.block_count_coding, s.zeta_k)
    read_block = V.make_reader(s.block_coding, s.zeta_k)

    d, pos = read_outd(words, pos)
    nonempty = d > 0
    ref = np.full(n, -1, dtype=np.int64)
    if s.window_size > 0:
        idx = np.flatnonzero(nonempty)
        r, p = read_ref(words, pos[idx])
        ref[idx] = r
        pos[idx] = p
    has_ref = ref > 0

    block_count = np.zeros(n, dtype=np.int64)
    idx = np.flatnonzero(has_ref)
    if len(idx):
        bc, p = read_bcnt(words, pos[idx])
        block_count[idx] = bc
        pos[idx] = p

    copied = np.zeros(n, dtype=np.int64)
    total_b = np.zeros(n, dtype=np.int64)
    if len(idx):
        order = idx[np.argsort(-block_count[idx], kind="stable")]
        counts = block_count[order]
        falling = -counts  # ascending, for the lanes still reading
        lane_pos = pos[order].copy()
        for step in range(int(counts[0]) if len(counts) else 0):
            k = int(np.searchsorted(falling, -step, side="left"))
            if k == 0:
                break
            b, p = read_block(words, lane_pos[:k])
            lane_pos[:k] = p
            v = b + (0 if step == 0 else 1)
            act = order[:k]
            total_b[act] += v
            if step % 2 == 0:
                copied[act] += v
        pos[order] = lane_pos
        even = np.flatnonzero(has_ref & ((block_count & 1) == 0))
        copied[even] += d[even - ref[even]] - total_b[even]

    extra = np.where(has_ref, d - copied, d)
    extra[~nonempty] = 0

    int_count = np.zeros(n, dtype=np.int64)
    interval_arcs = np.zeros(n, dtype=np.int64)
    if s.min_interval_length != 0:
        idx = np.flatnonzero(extra > 0)
        if len(idx):
            ic, p = V.read_gamma(words, pos[idx])
            int_count[idx] = ic
            pos[idx] = p
        # interval lengths: needed for residual counts -> walk intervals
        idx = np.flatnonzero(int_count > 0)
        if len(idx):
            order = idx[np.argsort(-int_count[idx], kind="stable")]
            counts = int_count[order]
            falling = -counts
            lane_pos = pos[order].copy()
            for step in range(int(counts[0])):
                k = int(np.searchsorted(falling, -step, side="left"))
                if k == 0:
                    break
                _l, p = V.read_gamma(words, lane_pos[:k])
                ln, p2 = V.read_gamma(words, p)
                lane_pos[:k] = p2
                interval_arcs[order[:k]] += ln + s.min_interval_length
            # NOTE: pos is NOT advanced here for nodes with intervals — the
            # kernel re-reads intervals itself; pos_after_ic below is the
            # cursor right after the interval-count code.

    res_count = extra - interval_arcs

    depth = chain_roots(ref)[1]

    return StructureScan(
        d=d.astype(np.int32),
        ref=ref.astype(np.int32),
        block_count=block_count.astype(np.int32),
        int_count=int_count.astype(np.int32),
        res_count=res_count.astype(np.int32),
        copied=copied.astype(np.int32),
        depth=depth.astype(np.int32),
        pos_after_ic=pos.astype(np.int64),
    )
