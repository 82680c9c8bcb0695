"""K2: the port's long-chain decoder (webgraph_tpu_torch/kernels/decode.py)
and the routed bulk decode, against the host oracle, exactly: on the CPU
through the plain PyTorch decoder, on the card through the two K2 kernels,
which must also equal the plain versions of both.  The graph set is that of
tests/test_pallas_decode.py plus config 3's deep-chain graph stored with
unbounded maxref.  The routing is held to the JAX package's
``decode_to_csr_auto`` by tests/test_torch_route.py."""

import os

import numpy as np
import pytest
import torch

import webgraph_tpu_torch as wgt
from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits import vcodes as V
from webgraph_tpu_torch.bits.bitstream import OutputBitStream
from webgraph_tpu_torch.formats import bvgraph as F
from webgraph_tpu_torch.formats import bvgraph_np
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels.plan import scan_structure
from webgraph_tpu_torch.synth import (deep_chain_graph, long_record_graph,
                                      weblike_graph)

MAXREF_INF = 2**31 - 1
CNR = dict(window_size=7, max_ref_count=3, min_interval_length=3, zeta_k=3)


def _structures():
    lists = []
    for x in range(120):
        base = list(range(x + 1, x + 20)) + [200 + (x % 7), 300 + 2 * (x % 11)]
        lists.append(sorted(set(v for v in base if v < 400)))
    return CSRGraph.from_lists(lists + [[]] * 280)


def _deep_chains():
    lists = []
    for x in range(200):
        lists.append(sorted(set(range(0, 1 + x % 37)) | {399 - (x % 5)}))
    return CSRGraph.from_lists(lists + [[]] * 200)


def _many_blocks():
    """300 lists of 1,100 arcs, each its predecessor with 20 arcs dropped
    and 20 added: a 300-deep chain (past K1's reach) of records with up
    to 40 copy blocks and lists past a warp's shared staging."""
    rng = np.random.default_rng(5)
    cur = set(rng.choice(5000, 1100, replace=False).tolist())
    lists = []
    for _ in range(300):
        lists.append(sorted(cur))
        cur -= set(rng.choice(sorted(cur), 20, replace=False).tolist())
        cur |= set(rng.choice(5000, 20, replace=False).tolist())
    return CSRGraph.from_lists(lists + [[]] * 700)


def _er(n, p, seed):
    return lambda: MutableGraph.erdos_renyi(n, p, seed=seed)


# name -> (graph factory, store keywords, meant for K2 only)
GRAPHS = {
    **{f"er_w{w}r{r}i{i}": (_er(n, p, s), dict(
        window_size=w, max_ref_count=r, min_interval_length=i), False)
       for w, r, i, s, n, p in [(7, 3, 4, 0, 300, 0.03), (7, 3, 3, 1, 200, 0.08),
                                (0, 0, 4, 2, 150, 0.05), (1, 1, 0, 3, 150, 0.05),
                                (2, 2, 2, 4, 250, 0.04), (7, 7, 2, 5, 400, 0.02)]},
    "multiblock": (_er(400, 0.03, 11), {}, False),
    "structures": (_structures, {}, False),
    "deep_chains": (_deep_chains, dict(window_size=7, max_ref_count=100,
                                       min_interval_length=2), False),
    "empty_and_single": (lambda: CSRGraph.from_lists([[], [0], [], [1, 2], []]),
                         {}, False),
    "many_blocks": (_many_blocks, dict(window_size=7, max_ref_count=MAXREF_INF,
                                       min_interval_length=2), False),
    "deep_chain6000_i0": (lambda: deep_chain_graph(6000), dict(
        window_size=7, max_ref_count=MAXREF_INF, min_interval_length=0), True),
    "deep_chain6000_i2": (lambda: deep_chain_graph(6000), dict(
        window_size=7, max_ref_count=MAXREF_INF, min_interval_length=2), True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stored(name, tmp):
    make, kw, _ = GRAPHS[name]
    g = make()
    base = os.path.join(tmp, name)
    BVGraph.store(g, base, **kw)
    return g, BVGraph.load(base)


def _k2_launches():
    return sum(K2.decode_levels.counts.values())


def _k1_launches():
    c = D2.decode_records.counts
    return c["k1_parse"] + c["k2_resolve"]


def _assert_csr(g, off, succ):
    toff, tsucc = g.to_csr()
    np.testing.assert_array_equal(off.cpu().numpy(), toff)
    np.testing.assert_array_equal(succ.cpu().numpy(), tsucc)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_plain_levels_match_oracle(name, tmp_path):
    g, bv = _stored(name, tmp_path)
    prep = K2.prepare(bv, "cpu")
    assert isinstance(prep, K2.LevelPrepared)
    succ, err = K2.decode_levels_plain(*prep.args())
    assert succ.dtype == torch.int32 and not err.any()
    _assert_csr(g, prep.offsets, succ)
    if GRAPHS[name][2]:
        assert not D2.supports(bv)
        assert prep.bounds.size - 1 > 500  # hundreds of chain-depth levels


@pytest.mark.parametrize("name", list(GRAPHS))
def test_routed_decode_matches_oracle(name, tmp_path):
    g, bv = _stored(name, tmp_path)
    launches = (_k1_launches(), _k2_launches())
    off, succ = wgt.decode_to_csr(bv, device="cpu")
    assert off.dtype == torch.int64 and succ.dtype == torch.int32
    _assert_csr(g, off, succ)
    prep = F.prepare(bv, "cpu")
    assert isinstance(prep, K2.LevelPrepared) == (not D2.supports(bv))
    # CPU tensors take the plain versions: no kernel launched
    assert (_k1_launches(), _k2_launches()) == launches


def test_plan_levels_orders_by_depth(tmp_path):
    _, bv = _stored("deep_chain6000_i2", tmp_path)
    scan = scan_structure(bv)
    plan = K2.plan_levels(bv, scan)
    order = plan.order.numpy().astype(np.int64)
    depth = scan.depth.astype(np.int64)
    assert plan.order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(bv.num_nodes()))
    assert plan.levels == int(depth.max()) + 1
    for lvl in (0, 1, plan.levels - 1):
        nodes = order[plan.bounds[lvl]:plan.bounds[lvl + 1]]
        assert len(nodes) > 0 and (depth[nodes] == lvl).all()
        assert (np.diff(nodes) > 0).all()  # stable: ids rise in a level
    ref = scan.ref.astype(np.int64)
    kids = np.flatnonzero(ref > 0)
    assert (depth[kids - ref[kids]] == depth[kids] - 1).all()
    assert plan.offsets.dtype == torch.int64
    np.testing.assert_array_equal(np.diff(plan.offsets.numpy()), scan.d)


def _set_record_bits(words, bo, x):
    """The stream with every bit of node x's record set: its outdegree
    reads 0."""
    w = words.cpu().numpy().view(np.uint64).copy()
    for p in range(int(bo[x]), int(bo[x + 1])):
        w[p >> 6] |= np.uint64(1) << np.uint64(63 - (p & 63))
    return torch.from_numpy(w.view(np.int64)).to(words.device)


def _clash(bv, words, bo, depth=3, into="copied"):
    """A node with residuals and a child, its record rewritten so that its
    first residual becomes another of its successors; every other code
    stays.  ``into`` "copied": a node of ``depth`` with copied arcs, the
    residual becomes its first copied successor, so an extra equals a
    copied value.  "interval": a node of depth 0 with intervals, the
    residual becomes its first interval value, so a residual lies inside an
    interval run.  Its counts all agree.  Returns the stream, the bit
    offsets and the node."""
    s, k = bv.settings, bv.settings.zeta_k
    n = bv.num_nodes()
    scan = scan_structure(bv)
    off, succ = bvgraph_np.decode_to_csr(bv)
    ref = scan.ref.astype(np.int64)
    kids = np.flatnonzero(ref > 0)
    parent = np.zeros(n, bool)
    parent[kids - ref[kids]] = True
    if into == "copied":
        pick = (scan.depth == depth) & (scan.copied > 0)
    else:
        pick = (scan.depth == 0) & (scan.int_count > 0)
    x = int(np.flatnonzero(pick & (scan.res_count > 0) & parent)[0])
    p = x - int(ref[x])

    w = words.cpu().numpy().view(np.uint64)
    bo = bo.cpu().numpy().copy()
    pos = np.array([bo[x]], np.int64)

    def read(coding, times=1):
        nonlocal pos
        vals = []
        for _ in range(times):
            v, pos = V.make_reader(coding, k)(w, pos)
            vals.append(int(v[0]))
        return vals

    read(s.outdegree_coding)
    if s.window_size > 0:
        read(s.reference_coding)
    if ref[x] > 0:
        read(s.block_coding, read(s.block_count_coding)[0])
    if s.min_interval_length != 0:
        read(C.GAMMA, 2 * read(C.GAMMA)[0])
    start = int(pos[0])
    gaps = read(s.residual_coding, int(scan.res_count[x]))
    res = np.cumsum([x + C.nat2int(gaps[0])] + [g + 1 for g in gaps[1:]])
    mine = succ[off[x]:off[x + 1]]
    if into == "copied":
        c = np.intersect1d(mine, succ[off[p]:off[p + 1]])[0]
    else:  # depth 0: its list is its interval values and its residuals
        c = np.setdiff1d(mine, res)[0]
    res = sorted(res[1:].tolist() + [int(c)])
    obs = OutputBitStream()
    for i, r in enumerate(res):
        obs.write(s.residual_coding,
                  C.int2nat(r - x) if i == 0 else r - res[i - 1] - 1, k)
    new = np.unpackbits(np.frombuffer(obs.to_bytes(), np.uint8))
    bits = np.unpackbits(w.astype(">u8").view(np.uint8))
    bits = np.concatenate([bits[:start], new[:obs.written_bits],
                           bits[bo[x + 1]:bo[n]]])
    bo[x + 1:] += start + obs.written_bits - bo[x + 1]
    bits = np.concatenate([bits, np.zeros(-len(bits) % 64 + 128, np.uint8)])
    w = np.packbits(bits).view(">u8").astype(np.uint64).view(np.int64)
    return torch.from_numpy(w), torch.from_numpy(bo), x


def _zero_from_middle(words, bo, x):
    """The stream with the second half of node x's record zeroed."""
    w = words.cpu().numpy().view(np.uint64).copy()
    lo, hi = int(bo[x]), int(bo[x + 1])
    for p in range((lo + hi) // 2, hi):
        w[p >> 6] &= ~(np.uint64(1) << np.uint64(63 - (p & 63)))
    return torch.from_numpy(w.view(np.int64)).to(words.device)


def _faulty(fault, prep, bv, depth=3):
    """The arguments of the route's decode wrapper (``decode_levels`` or
    ``decode_records``) with one fault, and the node that must come first
    in the error (None: any).  "record" corrupts a record of ``depth`` and
    "clash" rewrites one, each a node with a child."""
    words, bo, order, bounds, offsets, skey, bstart, *rest = prep.args()
    first = None
    if fault == "stream":
        words = torch.zeros_like(words)
    elif fault == "offsets":
        offsets = offsets.clone()
        offsets[1] += 1  # node 0 one arc longer, node 1 one shorter
    elif fault == "window":
        skey = skey[:6] + (1,) + skey[7:]
    elif fault in ("clash", "interval"):  # its descendants then fail too
        words, bo, first = _clash(bv, words, bo, depth,
                                  "copied" if fault == "clash" else fault)
    elif fault == "long":  # node 10 of long_record_graph, which 11 copies
        words = _zero_from_middle(words, bo.cpu(), 10)
    else:  # one record of ``depth``, whose descendants then fail too
        first = int(order[int(bounds[depth])])
        words = _set_record_bits(words, bo.cpu(), first)
    return (words, bo, order, bounds, offsets, skey, bstart, *rest), first


FAULTS = [("stream", "invalid code"), ("offsets", "record counts disagree"),
          ("window", "reference beyond the window"),
          ("record", "record counts disagree, parent failed"),
          ("clash", "record counts disagree, parent failed")]


@pytest.mark.parametrize("fault,message", FAULTS)
def test_node_errors_raise(fault, message, tmp_path):
    """A node whose stream holds no valid code, whose outdegree disagrees
    with its CSR slot or whose reference reaches past the window fails
    loudly instead of returning garbage; so do the descendants of a
    corrupted record, named after it."""
    _, bv = _stored("deep_chain6000_i2", tmp_path)
    args, first = _faulty(fault, K2.prepare(bv, "cpu"), bv)
    with pytest.raises(RuntimeError, match=message) as e:
        K2.decode_levels(*args)
    if first is not None:
        assert f"nodes [{first}," in str(e.value)


# K1's route (k1_parse, then k2_resolve): the fault, long_arcs (None: the
# default) and the error
K1_FAULTS = [("stream", None, "invalid code"), ("stream", 2, "invalid code"),
             ("offsets", None, "record counts disagree"),
             ("window", None, "reference beyond the window"),
             ("record", None, "record counts disagree, parent failed"),
             ("clash", None, "record counts disagree, parent failed"),
             ("interval", None, "record counts disagree, parent failed"),
             ("interval", 2, "record counts disagree, parent failed"),
             ("long", None, "invalid code, parent failed"),
             ("long", 2, "invalid code, parent failed")]


@pytest.fixture(scope="module")
def k1_graphs(tmp_path_factory):
    """Two graphs K1 decodes, stored with cnr-2000's parameters: a small
    web-like graph (chains 3 deep) and a small long-record graph (node 10
    links 4,000 scattered nodes, node 11 copies it)."""
    tmp = tmp_path_factory.mktemp("k1")
    out = {}
    for name, g in (("weblike", weblike_graph(3000, seed=0, hubs=0)),
                    ("long", long_record_graph(30_000))):
        base = os.path.join(tmp, name)
        BVGraph.store(g, base, **CNR)
        out[name] = BVGraph.load(base)
    return out


def _k1_faulty(fault, long_arcs, k1_graphs):
    bv = k1_graphs["long" if fault == "long" else "weblike"]
    assert D2.supports(bv)
    prep = D2.prepare(bv, "cpu", long_arcs=long_arcs or D2.LONG_ARCS)
    args, first = _faulty(fault, prep, bv, depth=2)
    return args, prep.sizes(), first


@pytest.mark.parametrize("fault,long_arcs,message", K1_FAULTS)
def test_k1_node_errors_raise(fault, long_arcs, message, k1_graphs):
    """K1's route fails loudly on the same faults as K2's, on short records
    and on records parsed a block each (``long_arcs`` 2, and the 4,000-arc
    record at the default), naming the corrupted record first."""
    args, sizes, first = _k1_faulty(fault, long_arcs, k1_graphs)
    with pytest.raises(RuntimeError, match=message) as e:
        D2.decode_records(*args, **sizes)
    if first is not None:
        assert f"nodes [{first}," in str(e.value)


def test_to_csr_routes_through_the_device_path(tmp_path):
    g, bv = _stored("deep_chain6000_i0", tmp_path)
    off, succ = bv.to_csr(backend="device", device="cpu")
    toff, tsucc = bvgraph_np.decode_to_csr(bv)
    np.testing.assert_array_equal(off, toff)
    np.testing.assert_array_equal(succ, tsucc)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GRAPHS))
def test_kernel_matches_plain_and_oracle_on_card(name, tmp_path, cuda):
    g, bv = _stored(name, tmp_path)
    prep = K2.prepare(bv, cuda)
    before = _k2_launches()
    succ = K2.decode_levels(*prep.args())
    torch.cuda.synchronize()
    # k2_parse, and k2_resolve when a node has a parent
    assert _k2_launches() == before + min(prep.bounds.size - 1, 2)
    parsed = K2.parse_records(*prep.args())
    plain = K2.parse_records_plain(*prep.args())
    for got, want in zip(parsed, plain):
        assert torch.equal(got, want)
    psucc, perr = K2.decode_levels_plain(*prep.args())
    assert not perr.any()
    assert torch.equal(succ, psucc)
    _assert_csr(g, prep.offsets, succ)
    off, succ = wgt.decode_to_csr(bv)
    assert succ.device.type == "cuda"
    _assert_csr(g, off, succ)


@pytest.mark.gpu
@pytest.mark.parametrize("fault,message", FAULTS)
def test_node_errors_raise_on_card(fault, message, tmp_path, cuda):
    """The same faults on the card raise the same error as on the CPU,
    without hanging on the failed nodes' children."""
    _, bv = _stored("deep_chain6000_i2", tmp_path)
    args, _ = _faulty(fault, K2.prepare(bv, "cpu"), bv)
    with pytest.raises(RuntimeError, match=message) as on_cpu:
        K2.decode_levels(*args)
    on_card = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(RuntimeError, match=message) as e:
        K2.decode_levels(*on_card)
    assert str(e.value) == str(on_cpu.value)


@pytest.mark.gpu
@pytest.mark.parametrize("fault,long_arcs,message", K1_FAULTS)
def test_k1_node_errors_raise_on_card(fault, long_arcs, message, k1_graphs,
                                      cuda):
    """The same faults through ``k1_parse`` and ``k2_resolve`` raise the
    same error as on the CPU, without hanging on the failed nodes'
    children."""
    args, sizes, _ = _k1_faulty(fault, long_arcs, k1_graphs)
    with pytest.raises(RuntimeError, match=message) as on_cpu:
        D2.decode_records(*args, **sizes)
    on_card = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(RuntimeError, match=message) as e:
        D2.decode_records(*on_card, **sizes)
    assert str(e.value) == str(on_cpu.value)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kernel", [("er_w7r3i4", "k1"),
                                         ("deep_chain6000_i2", "k2")])
def test_bvgraph_to_csr_defaults_to_the_card(name, kernel, tmp_path, cuda,
                                             monkeypatch):
    """``BVGraph.to_csr()`` with no arguments launches K1 or K2."""
    monkeypatch.delenv("WGT_DECODE_BACKEND", raising=False)
    g, bv = _stored(name, tmp_path)
    before = (_k1_launches(), _k2_launches())
    off, succ = bv.to_csr()
    after = (_k1_launches(), _k2_launches())
    rose = [b > a for a, b in zip(before, after)]
    assert rose == [kernel == "k1", kernel == "k2"]
    _assert_csr(g, torch.from_numpy(off), torch.from_numpy(succ))
