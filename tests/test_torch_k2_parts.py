"""The two halves of K2 (webgraph_tpu_torch/kernels/decode.py) on their
own: the plain parse against a NumPy oracle built from the host decoder,
the merge-by-rank arithmetic of ``k2_resolve`` against a sorted union, the
plan's ticket order, and the plain version of the warp-compaction probe
against the expectation of the JAX package's probe script.  Exact: the
outputs are integers."""

import os

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from webgraph_tpu_torch.bits import vcodes as V
from webgraph_tpu_torch.bits.bitstream import as_u64_words
from webgraph_tpu_torch.formats import bvgraph_np
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels.plan import scan_structure
from webgraph_tpu_torch.synth import MAXREF_INF, deep_chain_graph

from test_torch_decode import GRAPHS

CONFIG3 = {f"deep_chain6000_minint{i}": (lambda: deep_chain_graph(6000), dict(
    window_size=7, max_ref_count=MAXREF_INF, min_interval_length=i))
    for i in (0, 2, 4, 8)}
PARSE_GRAPHS = {**{k: v[:2] for k, v in GRAPHS.items()}, **CONFIG3}


def _stored(name, tmp):
    make, kw = PARSE_GRAPHS[name]
    base = os.path.join(tmp, name)
    BVGraph.store(make(), base, **kw)
    return BVGraph.load(base)


def _copied_slots(blocks, dp):
    """Parent slots a record copies: even blocks, and the tail past the
    last block when the count is even."""
    slots, cur = [], 0
    for k, v in enumerate(blocks):
        if k % 2 == 0:
            slots.extend(range(cur, cur + v))
        cur += v
    if len(blocks) % 2 == 0:
        slots.extend(range(cur, dp))
    return slots


def _oracle(bv):
    """(ext, bend, ref) as parse_records_plain lays them out, from the
    host decoder's lists and each record's blocks read one code at a
    time."""
    s = bv.settings
    n = bv.num_nodes()
    off, succ = bvgraph_np.decode_to_csr(bv)
    scan = scan_structure(bv)
    words = np.concatenate([as_u64_words(bv._words), np.zeros(2, np.uint64)])
    readers = {c: V.make_reader(c, s.zeta_k) for c in (
        s.outdegree_coding, s.reference_coding, s.block_count_coding,
        s.block_coding)}
    ext = np.zeros(len(succ), np.int64)
    bend = []
    ref = np.maximum(scan.ref.astype(np.int64), 0)
    for x in range(n):
        lst = succ[off[x]:off[x + 1]]
        if ref[x] == 0:
            ext[off[x]:off[x + 1]] = lst
            continue
        pos = np.array([bv.bit_offsets[x]], np.int64)
        _, pos = readers[s.outdegree_coding](words, pos)
        _, pos = readers[s.reference_coding](words, pos)
        bc, pos = readers[s.block_count_coding](words, pos)
        blocks = []
        for k in range(int(bc[0])):
            b, pos = readers[s.block_coding](words, pos)
            blocks.append(int(b[0]) + (k > 0))
        bend.extend(np.cumsum(blocks).tolist())
        p = x - ref[x]
        parent = succ[off[p]:off[p + 1]]
        copied = parent[_copied_slots(blocks, len(parent))]
        extras = np.setdiff1d(lst, copied)
        ext[off[x]:off[x] + len(extras)] = extras
    return ext, np.asarray(bend, np.int64), ref


@pytest.mark.parametrize("name", list(PARSE_GRAPHS))
def test_parse_matches_oracle(name, tmp_path):
    bv = _stored(name, tmp_path)
    prep = K2.prepare(bv, "cpu")
    parsed = K2.parse_records_plain(*prep.args())
    assert not parsed.err.any()
    ext, bend, ref = _oracle(bv)
    np.testing.assert_array_equal(parsed.ext.numpy(), ext)
    np.testing.assert_array_equal(parsed.bend.numpy(), bend)
    np.testing.assert_array_equal(parsed.ref.numpy(), ref)
    scan = scan_structure(bv)
    np.testing.assert_array_equal(np.diff(prep.bstart.numpy()),
                                  scan.block_count)


@st.composite
def _copy_cases(draw):
    """A sorted parent list, block lengths within it (the first may be 0,
    later ones at least 1) and sorted extras disjoint from the copied
    values."""
    values = draw(st.lists(st.integers(0, 300), max_size=80, unique=True))
    parent = sorted(values)
    blocks, left = [], len(parent)
    for k in range(draw(st.integers(0, 12))):
        lo = 0 if k == 0 else 1
        if left < lo:
            break
        v = draw(st.integers(lo, min(left, lo + 10)))
        blocks.append(v)
        left -= v
    copied = {parent[j] for j in _copied_slots(blocks, len(parent))}
    extras = draw(st.lists(st.integers(-5, 320).filter(
        lambda v: v not in copied), max_size=40, unique=True))
    return parent, blocks, sorted(extras)


@settings(max_examples=300, deadline=None)
@given(_copy_cases())
@example(([], [], [3, 7]))                   # empty parent, 0 blocks
@example(([1, 2, 3, 4], [], [0, 9]))         # 0 blocks: all copied
@example(([1, 2, 3, 4, 5], [2, 1, 1], [6]))  # odd count: no tail
@example(([1, 2, 3, 4, 5], [0, 2], [0]))     # even count: the tail
@example(([1, 2, 3, 4, 5], [2, 3], []))      # even count ending at dp
def test_merge_by_rank_is_the_sorted_union(case):
    parent, blocks, extras = case
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    bend = np.cumsum(blocks).astype(np.int64)
    got = K2.merge_copies_plain(t(parent), t(bend), t(extras))
    kept = t(parent)[t(_copied_slots(blocks, len(parent)))]
    want = torch.unique(torch.cat([kept, t(extras)]))
    assert got.numel() == kept.numel() + len(extras)
    assert torch.equal(got, want)


@pytest.mark.parametrize("parent,blocks,extras", [
    ([1, 2, 3, 4], [], [0, 3]),         # 0 blocks: 3 is copied
    ([1, 2, 3, 4, 5], [2, 1, 1], [4]),  # odd count: 4 is in the third block
    ([1, 2, 3, 4, 5], [0, 2], [0, 4]),  # even count: 4 is in the tail
])
def test_merge_by_rank_rejects_a_shared_value(parent, blocks, extras):
    """An extra that equals a kept value would take that value's position,
    leaving a slot unwritten: the merge refuses it, as k2_resolve fails the
    node."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    with pytest.raises(ValueError, match="also a copied value"):
        K2.merge_copies_plain(t(parent), t(np.cumsum(blocks).tolist()),
                              t(extras))


@pytest.mark.parametrize("name", ["deep_chains", "deep_chain6000_i2",
                                  "many_blocks", "multiblock"])
def test_tickets_come_after_parents(name, tmp_path):
    """In ``order``, every node of depth >= 1 comes after its parent, so a
    warp of k2_resolve waits only on a ticket already taken; the nodes
    without a reference fill depth 0."""
    make, kw, _ = GRAPHS[name]
    base = os.path.join(tmp_path, name)
    BVGraph.store(make(), base, **kw)
    bv = BVGraph.load(base)
    scan = scan_structure(bv)
    plan = K2.plan_levels(bv, scan)
    order = plan.order.numpy().astype(np.int64)
    n = len(order)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    ref = scan.ref.astype(np.int64)
    kids = np.flatnonzero(ref > 0)
    assert (rank[kids - ref[kids]] < rank[kids]).all()
    assert (rank[kids] >= plan.bounds[1]).all()
    assert (rank[np.flatnonzero(ref <= 0)] < plan.bounds[1]).all()


def test_compact_probe_plain_matches_numpy():
    """The probe's inputs of scripts/pallas_compact_chip.py: 1,024 lanes,
    0-16 values each, scattered at their prefix positions, then 16 slots
    fetched at random positions."""
    rng = np.random.default_rng(11)
    cnt = rng.integers(0, 17, 1024).astype(np.int32)
    pre = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    vals = rng.integers(1, 1 << 20, (128, 1024)).astype(np.int32)
    pool_size = 160 * 128
    exp = np.zeros(pool_size, np.int64)
    for lane in range(1024):
        exp[pre[lane]:pre[lane] + cnt[lane]] = vals[:cnt[lane], lane]
    acc = int(cnt.sum())
    qpos = rng.integers(0, max(acc - 16, 1), 1024).astype(np.int32)
    exp_q = np.stack([exp[qpos + k] for k in range(16)])
    pool, q = K2.compact_probe(torch.from_numpy(vals), torch.from_numpy(cnt),
                               torch.from_numpy(qpos), pool_size)
    np.testing.assert_array_equal(pool.numpy(), exp)
    np.testing.assert_array_equal(q.numpy(), exp_q)
