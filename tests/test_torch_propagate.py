"""The port's device analytics against the host copies, and its kernel
``or_pull`` (webgraph_tpu_torch/kernels/propagate.py):

* ``GeometricCentralities``, ``BetweennessCentrality`` and
  ``SumSweepDirectedDiameterRadius`` with ``use_device=True`` on the CPU
  against their host paths: float64 within rtol 1e-12 (geometric) and
  1e-9 (betweenness; sums in another order), SumSweep exact; path counts
  past 2**62 raise on both paths;
* ``or_pull_plain`` against a NumPy oracle, slot for slot, and a path
  graph that a step done in place would get wrong;
* the mask converters between the two packages' layouts.

Card twins (``gpu``) hold ``or_pull`` to ``or_pull_plain`` slot for slot
and the analytics on the card to the CPU's, and skip without one."""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from webgraph_tpu_torch.algo import device as D
from webgraph_tpu_torch.algo.centralities import (BetweennessCentrality,
                                                  GeometricCentralities)
from webgraph_tpu_torch.algo.sumsweep import (OutputLevel,
                                              SumSweepDirectedDiameterRadius)
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.kernels import propagate as P
from webgraph_tpu_torch.synth import weblike_graph
from webgraph_tpu_torch.transform import transform as T
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)

GRAPHS = {
    "er300": lambda: MutableGraph.erdos_renyi(300, 0.02, seed=3),
    "weblike500": lambda: weblike_graph(500),
    "weblike2000": lambda: weblike_graph(2_000),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ----------------------------------------------------------------------
# against the host copies
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["er300", "weblike500"])
def test_centralities_use_device_match_host(name):
    g = GRAPHS[name]()
    h = GeometricCentralities(g, alpha=0.3).compute()
    d = GeometricCentralities(g, alpha=0.3, use_device=True,
                              device="cpu").compute()
    np.testing.assert_array_equal(d.reachable, h.reachable)
    for f in ("closeness", "harmonic", "lin", "exponential"):
        np.testing.assert_allclose(getattr(d, f), getattr(h, f), rtol=1e-12,
                                   err_msg=f)
    hb = BetweennessCentrality(g).compute().betweenness
    db = BetweennessCentrality(g, use_device=True,
                               device="cpu").compute().betweenness
    np.testing.assert_allclose(db, hb, rtol=1e-9)


@pytest.mark.parametrize("name", ["er300", "weblike500"])
def test_sumsweep_use_device_matches_host(name):
    g = GRAPHS[name]()
    out = []
    for use in (False, True):
        s = SumSweepDirectedDiameterRadius(g, OutputLevel.RADIUS_DIAMETER,
                                           use_device=use, device="cpu")
        s.compute()
        out.append((s.get_diameter(), s.get_radius()))
    assert out[0] == out[1]


@pytest.mark.parametrize("name", ["er300", "weblike500"])
def test_reversed_is_the_transpose(name):
    """``DeviceCSR.reversed`` (SumSweep's backward sweeps) holds the same
    tensors as a ``DeviceCSR`` built from the host transpose."""
    g = GRAPHS[name]()
    got = D.DeviceCSR.from_graph(g, "cpu").reversed()
    want = D.DeviceCSR.from_graph(T.transpose(g), "cpu")
    assert (got.n, got.m) == (want.n, want.m)
    for f in ("offsets", "src", "dst", "in_off", "in_src"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _layered(layers):
    """A root, then ``layers`` layers of two nodes, each node joined to
    both nodes of the next layer: 2**(k-1) shortest paths from the root to
    each node of layer k."""
    lists = [[1, 2]]
    for k in range(layers):
        a = 1 + 2 * k
        nxt = [a + 2, a + 3] if k + 1 < layers else []
        lists += [nxt, list(nxt)]
    return lists


@pytest.mark.parametrize("layers,raises", [(63, False), (64, True)])
def test_path_count_overflow_raises_on_both_paths(layers, raises):
    """2**62 paths are counted; 2**63 raise PathCountOverflowException on
    the host path and on the device path (the JAX package counts in float32
    and cannot tell, ROADMAP C reference defect 5)."""
    g = CSRGraph.from_lists(_layered(layers))
    for use in (False, True):
        bc = BetweennessCentrality(g, use_device=use, device="cpu")
        if raises:
            with pytest.raises(
                    BetweennessCentrality.PathCountOverflowException):
                bc.compute()
        else:
            bc.compute()
    if not raises:
        h = BetweennessCentrality(g).compute().betweenness
        d = BetweennessCentrality(g, use_device=True,
                                  device="cpu").compute().betweenness
        np.testing.assert_allclose(d, h, rtol=1e-9)


# ----------------------------------------------------------------------
# or_pull's plain version
# ----------------------------------------------------------------------


def _oracle(n, arcs, old, level):
    """new, stats (65), dist updates by the definition, in Python ints."""
    old = [int(w) & (2**64 - 1) for w in old]
    new = list(old)
    for y, x in arcs:
        new[x] |= old[y]
    nb = [a & ~b & (2**64 - 1) for a, b in zip(new, old)]
    stats = [sum(bin(w).count("1") for w in nb)] + [
        sum((w >> b) & 1 for w in nb) for b in range(64)]
    reached = [x for x in range(n) if old[x] == 0 and new[x] != 0]
    return [w - 2**64 if w >= 2**63 else w for w in new], stats, reached


def _in_csr(n, arcs):
    """The in-CSR of ``arcs`` ((src, dst) pairs), by target then source."""
    arcs = sorted(set(arcs), key=lambda a: (a[1], a[0]))
    in_off = np.zeros(n + 1, dtype=np.int64)
    for _, x in arcs:
        in_off[x + 1] += 1
    return (torch.from_numpy(np.cumsum(in_off)),
            torch.tensor([y for y, _ in arcs], dtype=torch.int32), arcs)


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_or_pull_plain_matches_oracle(data):
    n = data.draw(st.integers(1, 40))
    arcs = data.draw(st.lists(st.tuples(st.integers(0, n - 1),
                                        st.integers(0, n - 1)), max_size=120))
    words = data.draw(st.lists(
        st.one_of(st.just(0), st.integers(-2**63, 2**63 - 1),
                  st.sampled_from([-2**63, -1, 1, 2**62])),
        min_size=n, max_size=n))
    level = data.draw(st.integers(0, 50))
    in_off, in_src, arcs = _in_csr(n, arcs)
    old = torch.tensor(words, dtype=torch.int64)
    keep = old.clone()
    dist = torch.full((n,), -7, dtype=torch.int32)
    new, stats = P.or_pull(in_off, in_src, old, perbit=True, dist=dist,
                           level=level)
    enew, estats, reached = _oracle(n, arcs, words, level)
    assert new.tolist() == enew
    assert stats.tolist() == estats
    assert torch.equal(old, keep)  # old is read, never written
    exp = [level + 1 if x in reached else -7 for x in range(n)]
    assert dist.tolist() == exp
    new1, stats1 = P.or_pull(in_off, in_src, old)
    assert torch.equal(new1, new) and stats1.tolist() == estats[:1]


def test_or_pull_is_one_hop_a_step():
    """On a path 0 -> 1 -> ... -> 9 a step reaches one more node: a step
    done in place (reading words it wrote in the same pass) would reach
    every node downstream of node 0 at once and give them distance 1."""
    n = 10
    in_off, in_src, _ = _in_csr(n, [(i, i + 1) for i in range(n - 1)])
    old = torch.zeros(n, dtype=torch.int64)
    old[0] = 1
    dist = torch.full((n,), -1, dtype=torch.int32)
    dist[0] = 0
    new, stats = P.or_pull(in_off, in_src, old, dist=dist, level=0)
    assert new.tolist() == [1, 1] + [0] * (n - 2)
    assert int(stats[0]) == 1 and dist.tolist() == [0, 1] + [-1] * (n - 2)
    csr = D.DeviceCSR(np.arange(n + 1).clip(max=n - 1),
                      np.arange(1, n), n, "cpu")
    assert D.bfs_distances(csr, 0).tolist() == list(range(n))
    counts, _, it = D.nf64(csr, [0])
    assert counts.tolist() == list(range(1, n + 1)) + [n] and it == n


def test_or_pull_checks_its_inputs():
    in_off = torch.tensor([0, 1, 1], dtype=torch.int64)
    in_src = torch.tensor([1], dtype=torch.int32)
    old = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="in_src"):
        P.or_pull(in_off, in_src.long(), old)
    with pytest.raises(ValueError, match="in_off"):
        P.or_pull(in_off[:2], in_src, old)
    with pytest.raises(ValueError, match="dist"):
        P.or_pull(in_off, in_src, old, dist=torch.zeros(2, dtype=torch.int64))
    launches = P.or_pull.launches
    P.or_pull(in_off, in_src, old)
    assert P.or_pull.launches == launches  # the CPU launches nothing


def test_mask_converters_round_trip():
    rng = np.random.default_rng(0)
    jm = rng.integers(0, 2**32, size=(50, 2), dtype=np.uint64).astype(
        np.uint32)
    jm[0] = [0, 2**31]   # source 63 alone: the sign bit of the word
    jm[1] = [1, 0]       # source 0 alone
    words = D.masks_from_jax(jm)
    assert words.dtype == torch.int64
    assert int(words[0]) == -2**63 and int(words[1]) == 1
    np.testing.assert_array_equal(D.masks_to_jax(words), jm)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GRAPHS))
def test_or_pull_matches_plain_on_card(name, cuda):
    g = GRAPHS[name]()
    csr = D.DeviceCSR.from_graph(g, cuda)
    rng = np.random.default_rng(1)
    words = rng.integers(-2**63, 2**63 - 1, size=csr.n, dtype=np.int64)
    words[rng.random(csr.n) < 0.6] = 0
    old = torch.from_numpy(words).to(cuda)
    for perbit in (False, True):
        d1 = torch.full((csr.n,), -1, dtype=torch.int32, device=cuda)
        d2 = d1.clone()
        before = P.or_pull.launches
        new, stats = P.or_pull(csr.in_off, csr.in_src, old, perbit=perbit,
                               dist=d1, level=4)
        torch.cuda.synchronize()
        assert P.or_pull.launches == before + 1
        pnew, pstats = P.or_pull_plain(csr.in_off, csr.in_src, old,
                                       perbit=perbit, dist=d2, level=4)
        assert torch.equal(new, pnew) and torch.equal(stats, pstats)
        assert torch.equal(d1, d2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GRAPHS))
def test_analytics_on_card_match_cpu(name, cuda):
    g = GRAPHS[name]()
    ccsr = D.DeviceCSR.from_graph(g, "cpu")
    csr = D.DeviceCSR.from_graph(g, cuda)
    assert torch.equal(csr.in_src.cpu(), ccsr.in_src)
    assert torch.equal(D.bfs_distances(csr, [0, 7]).cpu(),
                       D.bfs_distances(ccsr, [0, 7]))
    a, b = D.nf64(csr, np.arange(64)), D.nf64(ccsr, np.arange(64))
    assert np.array_equal(a[0], b[0]) and torch.equal(a[1].cpu(), b[1])
    for x, y in zip(D.geometric_centralities_device(csr),
                    D.geometric_centralities_device(ccsr)):
        np.testing.assert_allclose(x, y, rtol=1e-12)
    np.testing.assert_allclose(D.betweenness_device(csr),
                               D.betweenness_device(ccsr), rtol=1e-9)


@pytest.mark.gpu
def test_from_graph_bvgraph_on_card(cuda, tmp_path):
    """A BVGraph becomes a DeviceCSR through the port's decode kernels,
    equal to the CPU's CSR."""
    from webgraph_tpu_torch.kernels import decode2 as D2

    g = weblike_graph(20_000)
    base = os.path.join(tmp_path, "g")
    BVGraph.store(g, base, window_size=7, max_ref_count=3,
                  min_interval_length=3)
    before = dict(D2.decode_records.counts)
    csr = D.DeviceCSR.from_graph(BVGraph.load(base), cuda)
    torch.cuda.synchronize()
    assert D2.decode_records.counts["k1_parse"] == before["k1_parse"] + 1
    ccsr = D.DeviceCSR.from_graph(g, "cpu")
    for f in ("offsets", "src", "dst", "in_off", "in_src"):
        assert torch.equal(getattr(csr, f).cpu(), getattr(ccsr, f)), f
