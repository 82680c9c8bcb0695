"""Batched random access in the port (webgraph_tpu_torch/kernels/query2.py)
against the host oracle ``bvgraph_np.decode_to_csr``, exactly: on the CPU
through the plain versions of ``k1_parse`` and ``k2_resolve`` over each
batch's ancestor closure, on the card through the kernels themselves.  The
graph set is that of tests/test_query.py.  The port against the JAX
package's ``QueryPlanner``: tests/test_torch_query_ref.py."""

import os
import time

import numpy as np
import pytest
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.formats import bvgraph_np
from webgraph_tpu_torch.formats.bvgraph import BVGraph, BVGraphSettings
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels import levels as L
from webgraph_tpu_torch.kernels.query2 import QueryPlan, QueryPlanner
from webgraph_tpu_torch.tools.speed_test import SpeedTest
from webgraph_tpu_torch.utils.rng import XoRoShiRo128PlusRandom


def _er(n, p, seed):
    return lambda: MutableGraph.erdos_renyi(n, p, seed=seed)


def _deep_chains():
    lists = [sorted(set(range(0, 1 + x % 37)) | {399 - (x % 5)})
             for x in range(200)]
    return CSRGraph.from_lists(lists + [[]] * 200)


# name -> (graph factory, store keywords, query nodes); the graphs and
# batches of tests/test_query.py
GRAPHS = {
    "er_default": (_er(300, 0.04, 0), {}, None),
    "er_minint3": (_er(200, 0.08, 1), dict(min_interval_length=3), None),
    "er_window0": (_er(250, 0.05, 2), dict(window_size=0, max_ref_count=0),
                   None),
    "er_maxref7": (_er(220, 0.05, 3), dict(window_size=7, max_ref_count=7),
                   None),
    "deep_chains": (_deep_chains, dict(window_size=7, max_ref_count=100,
                                       min_interval_length=2),
                    np.arange(64) * 3 % 400),
    "duplicates_and_empty": (_er(150, 0.05, 9), {}, np.array(
        [5] * 10 + [0, 149] * 5 + list(range(44)))),
}


def _stored(name, tmp):
    make, kw, _ = GRAPHS[name]
    base = os.path.join(tmp, name)
    BVGraph.store(make(), base, **kw)
    return BVGraph.load(base)


def _nodes(name, bv, seed):
    nodes = GRAPHS[name][2]
    if nodes is None:
        nodes = np.random.default_rng(seed).integers(0, bv.num_nodes(), 64)
    return np.asarray(nodes, dtype=np.int64)


def _assert_lists(bv, nodes, out, counts):
    """``out`` and ``counts`` are the oracle's lists of ``nodes``,
    zero-padded to the longest (at least 1)."""
    toff, tsucc = bvgraph_np.decode_to_csr(bv)
    d = np.diff(toff)[nodes]
    want = np.zeros((nodes.size, int(d.max(initial=1))), np.int32)
    for i, x in enumerate(nodes):
        want[i, :d[i]] = tsucc[toff[x]:toff[x + 1]]
    assert out.dtype == torch.int32 and counts.dtype == torch.int64
    np.testing.assert_array_equal(counts.cpu().numpy(), d)
    np.testing.assert_array_equal(out.cpu().numpy(), want)


def _launches():
    return (dict(D2.decode_records.counts),
            sum(K2.decode_levels.counts.values()))


def _plan_over(qp, nodes, closure, long_arcs=D2.LONG_ARCS):
    """The plan of ``nodes`` over ``closure``, its long records those of at
    least ``long_arcs`` arcs."""
    order, bounds, long = L.level_order(qp.depth, qp.d, closure, long_arcs)
    return QueryPlan(nodes=nodes, counts=qp.d[nodes], order=order,
                     bounds=bounds, long=long)


def _without_parent(qp, plan):
    """``plan`` with the parent of its deepest node left out of the
    closure (the bounds made again from the depths that are left)."""
    x = int(plan.order[-1])
    assert qp.depth[x] > 0
    return _plan_over(qp, plan.nodes, plan.order[plan.order != qp.parent[x]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(GRAPHS))
def test_successors_batch_matches_oracle(name, tmp_path):
    bv = _stored(name, tmp_path)
    nodes = _nodes(name, bv, seed=list(GRAPHS).index(name))
    qp = QueryPlanner(bv, "cpu")
    before = _launches()
    out, counts = qp.successors_batch(nodes)
    assert _launches() == before  # CPU tensors launch nothing
    _assert_lists(bv, nodes, out, counts)


@pytest.mark.parametrize("size", [0, 1, 5000])
def test_batch_sizes(size, tmp_path):
    """An empty batch gives a (0, 1) block; a batch of 5,000 nodes (every
    node many times over) is one decode like any other."""
    bv = _stored("er_default", tmp_path)
    nodes = np.random.default_rng(size).integers(0, bv.num_nodes(), size)
    out, counts = QueryPlanner(bv, "cpu").successors_batch(nodes)
    assert out.shape == (size, max(int(counts.max()) if size else 1, 1))
    _assert_lists(bv, nodes, out, counts)


def test_adjacency_matches_oracle(tmp_path):
    """The membership filter over ``successors_batch``, on the pairs of
    tests/test_query.py::test_adjacency_queries."""
    g = MutableGraph.erdos_renyi(300, 0.04, seed=4)
    BVGraph.store(g, os.path.join(tmp_path, "g"))
    bv = BVGraph.load(os.path.join(tmp_path, "g"))
    toff, tsucc = g.to_csr()
    rng = np.random.default_rng(1)
    src = rng.integers(0, 300, 64)
    dst = rng.integers(0, 300, 64)
    for i in range(0, 64, 2):  # half of them true arcs
        x = src[i]
        if toff[x + 1] > toff[x]:
            dst[i] = tsucc[rng.integers(toff[x], toff[x + 1])]
    want = np.array([dst[i] in set(tsucc[toff[src[i]]:toff[src[i] + 1]])
                     for i in range(64)])
    got = QueryPlanner(bv, "cpu").adjacency(src, dst)
    assert got.dtype == torch.bool and want.sum() >= 16
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nodes", [[-1], [0, 300], [[1, 2]]],
                         ids=["negative", "past_n", "two_dims"])
def test_nodes_out_of_range_raise(nodes, tmp_path):
    """A negative id is refused, not wrapped around as the reference's
    NumPy indexing does (ROADMAP C)."""
    qp = QueryPlanner(_stored("er_default", tmp_path), "cpu")
    with pytest.raises(ValueError):
        qp.successors_batch(np.asarray(nodes))


def test_golomb_graph_raises(tmp_path):
    s = BVGraphSettings()
    s.codings["RESIDUALS"] = C.GOLOMB
    BVGraph.store(MutableGraph.erdos_renyi(100, 0.05, seed=12),
                  os.path.join(tmp_path, "g"), settings=s)
    with pytest.raises(NotImplementedError, match="k1_parse"):
        QueryPlanner(BVGraph.load(os.path.join(tmp_path, "g")), "cpu")


@pytest.mark.parametrize("name", ["er_maxref7", "deep_chains"])
def test_closure_holds_every_ancestor_and_nothing_else(name, tmp_path):
    bv = _stored(name, tmp_path)
    qp = QueryPlanner(bv, "cpu")
    nodes = _nodes(name, bv, seed=5)
    want = set()
    for x in nodes.tolist():
        while x >= 0 and x not in want:
            want.add(x)
            x = int(qp.parent[x])
    plan = qp.plan(nodes)
    closure = qp.closure(nodes)
    assert closure.size == len(want)  # each node once
    np.testing.assert_array_equal(np.sort(closure), sorted(want))
    np.testing.assert_array_equal(
        plan.order, sorted(want, key=lambda x: (qp.depth[x], x)))
    depth = qp.depth[plan.order]
    assert (np.diff(depth) >= 0).all()
    np.testing.assert_array_equal(
        plan.bounds, np.searchsorted(depth, np.arange(depth.max() + 2)))
    np.testing.assert_array_equal(plan.long, np.flatnonzero(
        qp.d[plan.order] >= D2.LONG_ARCS))


def test_full_closure_is_the_bulk_plan(tmp_path):
    """Queried at every node, the closure is the whole graph and its plan
    and decode are the bulk decode's, bit for bit."""
    bv = _stored("er_maxref7", tmp_path)
    qp = QueryPlanner(bv, "cpu")
    prep = D2.prepare(bv, "cpu", long_arcs=8)
    nodes = np.arange(bv.num_nodes())
    plan = _plan_over(qp, nodes, qp.closure(nodes), 8)
    np.testing.assert_array_equal(  # the bulk order: depth, then id
        prep.order.numpy(), np.argsort(qp.depth, kind="stable"))
    np.testing.assert_array_equal(plan.order, prep.order.numpy())
    np.testing.assert_array_equal(plan.bounds, prep.bounds)
    np.testing.assert_array_equal(plan.long, prep.long.numpy())
    assert plan.long.size > 0
    assert torch.equal(qp.decode(plan), D2.decode_prepared(prep)[1])


def _closure_slots(offsets, nodes):
    """Every CSR slot of ``nodes`` (int64 tensor of node ids) by
    ``offsets``, as a bool mask."""
    mask = torch.zeros(int(offsets[-1]), dtype=torch.bool)
    for x in nodes.tolist():
        mask[int(offsets[x]):int(offsets[x + 1])] = True
    return mask


def test_subset_plain_versions_parse_only_the_closure(tmp_path):
    """Over a closure, the plain parse and resolve write exactly the bulk
    versions' values in the closure's slots (extras, block ends,
    references, lists) and nothing anywhere else."""
    bv = _stored("deep_chains", tmp_path)
    prep = D2.prepare(bv, "cpu")
    args, sizes = prep.args()[:7], prep.sizes()
    full = L.parse_records_plain(*args, **sizes)
    fsucc, ferr = L.resolve_copies_plain(full, prep.order, prep.bounds,
                                         prep.offsets, prep.bstart,
                                         m=prep.m)
    assert not ferr.any()
    qp = QueryPlanner(bv, "cpu")
    deep = np.flatnonzero(qp.depth == 20)[:2]
    plan = qp.plan(np.concatenate([deep, deep, [399]]))
    assert plan.bounds.size == 22  # two chains of 20 links
    order = torch.from_numpy(plan.order.astype(np.int32))
    sub = L.parse_records_plain(args[0], args[1], order, plan.bounds,
                                *args[4:], **sizes)
    nodes = order.long()
    slots = _closure_slots(prep.offsets, nodes)
    blocks = _closure_slots(prep.bstart, nodes)
    listed = torch.zeros(bv.num_nodes(), dtype=torch.bool)
    listed[nodes] = True
    assert 0 < int(slots.sum()) < prep.m and int(blocks.sum()) > 0
    for got, want, mask in ((sub.ext, full.ext, slots),
                            (sub.bend, full.bend, blocks),
                            (sub.ref, full.ref, listed)):
        assert torch.equal(got[mask], want[mask])
        assert not got[~mask].any()
    assert sub.err.shape == order.shape and not sub.err.any()
    succ, err = L.resolve_copies_plain(sub, order, plan.bounds, prep.offsets,
                                       prep.bstart, m=prep.m)
    assert not err.any()
    assert torch.equal(succ[slots], fsucc[slots]) and not succ[~slots].any()


def test_missing_parent_fails_without_waiting(tmp_path):
    """A closure that leaves out a parent fails its child with "reference
    disagrees with the depth plan"."""
    bv = _stored("deep_chains", tmp_path)
    qp = QueryPlanner(bv, "cpu")
    plan = _without_parent(qp, qp.plan(_nodes("deep_chains", bv, 0)))
    with pytest.raises(RuntimeError,
                       match="reference disagrees with the depth plan"):
        qp.decode(plan)


def test_speed_test_counts_the_oracles_arcs(tmp_path):
    """``links`` is the number of arcs the batches return (the reference
    sums the lengths of the (out, counts) pair instead, ROADMAP C)."""
    bv = _stored("er_default", tmp_path)
    toff, _ = bvgraph_np.decode_to_csr(bv)
    rng = XoRoShiRo128PlusRandom(3)
    nodes = [rng.next_int(bv.num_nodes()) for _ in range(2500)]
    r = SpeedTest.random_access_batched(bv, 2500, seed=3, warmup=0,
                                        repeat=1, device="cpu")
    assert r["links"] == int(np.diff(toff)[nodes].sum())
    assert r["batched"] and r["ns_per_node"] > 0
    s = SpeedTest.sequential(bv, warmup=0, repeat=1, backend="device",
                             device="cpu")
    assert s["links"] == bv.num_arcs()


def test_speed_test_sequential_runs_with_its_defaults(tmp_path):
    """With the default device ("cuda") the sequential test runs on a host
    with or without a card: ``to_csr`` takes the host codec where no card
    is present, and the clock synchronises only a card that is there."""
    bv = _stored("er_default", tmp_path)
    s = SpeedTest.sequential(bv, warmup=0, repeat=1)
    assert s["links"] == bv.num_arcs() and s["seconds"] > 0


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GRAPHS))
def test_successors_batch_on_card(name, tmp_path, cuda):
    """``k1_parse`` once and ``k2_resolve`` once (none when the closure is
    all at depth 0) through K1's wrapper, none through K2's, and one read
    from the card, the error check; exact."""
    bv = _stored(name, tmp_path)
    nodes = _nodes(name, bv, seed=list(GRAPHS).index(name))
    qp = QueryPlanner(bv, cuda)
    plan = qp.plan(nodes)
    (k1, k2) = _launches()
    out, counts = qp.successors_batch(nodes)
    torch.cuda.synchronize()
    after, k2_after = _launches()
    assert after == {"k1_parse": k1["k1_parse"] + 1,
                     "k2_resolve": k1["k2_resolve"] + int(
                         plan.bounds.size > 2),
                     "reads": k1["reads"] + 1,
                     "levels": k1["levels"] + plan.bounds.size - 1}
    assert k2_after == k2 and out.device.type == "cuda"
    _assert_lists(bv, nodes, out, counts)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [0, 1, 5000])
def test_batch_sizes_on_card(size, tmp_path, cuda):
    bv = _stored("er_default", tmp_path)
    nodes = np.random.default_rng(size).integers(0, bv.num_nodes(), size)
    out, counts = QueryPlanner(bv, cuda).successors_batch(nodes)
    _assert_lists(bv, nodes, out, counts)


@pytest.mark.gpu
def test_subset_kernels_match_plain_on_card(tmp_path, cuda):
    """``k1_parse`` alone and the decode over a closure equal the plain
    versions on the same subset in every slot of the closure."""
    bv = _stored("deep_chains", tmp_path)
    qp = QueryPlanner(bv, cuda)
    nodes = _nodes("deep_chains", bv, 0)
    plan = _plan_over(qp, nodes, qp.closure(nodes), 8)
    order = torch.from_numpy(plan.order.astype(np.int32)).to(cuda)
    long = torch.from_numpy(plan.long.astype(np.int32)).to(cuda)
    args = (qp.words, qp.bo, order, plan.bounds, qp.offsets, qp.skey,
            qp.bstart)
    sizes = dict(m=qp.m, nblocks=qp.nblocks)
    parsed = D2.parse_records(*args, long, **sizes)
    plain = L.parse_records_plain(*args, **sizes)
    slots = _closure_slots(qp.offsets.cpu(), order.cpu().long()).to(cuda)
    blocks = _closure_slots(qp.bstart.cpu(), order.cpu().long()).to(cuda)
    assert torch.equal(parsed.ext, plain.ext)  # zeros outside on both
    assert torch.equal(parsed.bend[blocks], plain.bend[blocks])
    assert torch.equal(parsed.ref[order.long()], plain.ref[order.long()])
    assert torch.equal(parsed.err, plain.err) and not plain.err.any()
    succ = qp.decode(plan)
    psucc, perr = L.resolve_copies_plain(plain, order, plan.bounds,
                                         qp.offsets, qp.bstart, m=qp.m)
    assert not perr.any()
    assert torch.equal(succ[slots], psucc[slots])


@pytest.mark.gpu
def test_missing_parent_fails_without_waiting_on_card(tmp_path, cuda):
    """On the card the child fails at once (every rank starts past every
    position), with the CPU's message, instead of polling its parent's
    flag for seconds."""
    bv = _stored("deep_chains", tmp_path)
    nodes = _nodes("deep_chains", bv, 0)
    plan = _without_parent(QueryPlanner(bv, "cpu"),
                           QueryPlanner(bv, "cpu").plan(nodes))
    with pytest.raises(RuntimeError) as on_cpu:
        QueryPlanner(bv, "cpu").decode(plan)
    qp = QueryPlanner(bv, cuda)
    qp.successors_batch(nodes)  # builds and warms up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as on_card:
        qp.decode(plan)
    assert time.perf_counter() - t0 < 1.0
    assert str(on_card.value) == str(on_cpu.value)
    assert "reference disagrees with the depth plan" in str(on_card.value)


@pytest.mark.gpu
def test_adjacency_on_card(tmp_path, cuda):
    bv = _stored("er_default", tmp_path)
    toff, tsucc = bvgraph_np.decode_to_csr(bv)
    rng = np.random.default_rng(2)
    src = rng.integers(0, bv.num_nodes(), 256)
    dst = rng.integers(0, bv.num_nodes(), 256)
    want = np.array([y in set(tsucc[toff[x]:toff[x + 1]])
                     for x, y in zip(src, dst)])
    got = QueryPlanner(bv, cuda).adjacency(src, dst)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_k2_wrapper_refuses_a_subset_on_card(tmp_path, cuda):
    """K2's C entry point resets the ready flags by the order's length, so
    its wrapper takes whole graphs only."""
    bv = _stored("deep_chains", tmp_path)
    qp = QueryPlanner(bv, cuda)
    plan = qp.plan(np.array([5]))
    order = torch.from_numpy(plan.order.astype(np.int32)).to(cuda)
    with pytest.raises(ValueError, match="every node"):
        K2.decode_levels(qp.words, qp.bo, order, plan.bounds, qp.offsets,
                         qp.skey, qp.bstart, m=qp.m, nblocks=qp.nblocks)
