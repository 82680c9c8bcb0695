"""The port's device analytics (webgraph_tpu_torch/algo/device.py) on the
CPU, through its kernel's plain version:

* against the JAX package's algo/device.py on the same seeded graphs (ER
  300 nodes p 0.02 seed 3, as tests/test_device_algo.py; a web-like graph
  of 2,000 nodes, batch by batch): integers exact, geometric floats within
  rtol 1e-5 and betweenness within rtol 1e-4 (the JAX package sums in
  float32);
* ``DeviceCSR.from_graph`` of a stored BVGraph through the port's decode
  route.

The host copies and ``or_pull`` itself: tests/test_torch_propagate.py."""

import os

import numpy as np
import pytest
import torch

from webgraph_tpu.algo import device as J
from webgraph_tpu_torch.algo import device as D
from webgraph_tpu_torch.algo.bfs import bfs_distances as host_bfs
from webgraph_tpu_torch.algo.nf import NeighbourhoodFunction
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.synth import weblike_graph

GRAPHS = {
    "er300": lambda: MutableGraph.erdos_renyi(300, 0.02, seed=3),
    "weblike2000": lambda: weblike_graph(2_000),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a module runs: the tensors here are small,
    and the test workers share the cores, so more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """name -> (graph, the port's DeviceCSR on the CPU, the JAX DeviceCSR
    of the same arcs)."""
    out = {}
    for name, make in GRAPHS.items():
        g = make()
        off, succ = g.to_csr()
        out[name] = (g, D.DeviceCSR.from_graph(g, "cpu"),
                     J.DeviceCSR(off, succ, g.num_nodes()))
    return out


def _padded(counts, size):
    return np.concatenate([counts, np.full(size - len(counts), counts[-1])])


# ----------------------------------------------------------------------
# against the JAX package's algo/device.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GRAPHS))
def test_bfs_and_eccentricity_match_jax(name, pair):
    g, csr, jcsr = pair[name]
    n = g.num_nodes()
    for s in (0, 17, n // 2, n - 1):
        got = D.bfs_distances(csr, s)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(J.bfs_distances(jcsr, s)))
        np.testing.assert_array_equal(got.numpy(), host_bfs(g, s))
        assert D.eccentricity(csr, s) == J.eccentricity(jcsr, s)
    srcs = [4, n - 100]
    np.testing.assert_array_equal(D.bfs_distances(csr, srcs).numpy(),
                                  np.asarray(J.bfs_distances(jcsr, srcs)))
    np.testing.assert_array_equal(
        D.bfs_distances(csr, 0, max_levels=2).numpy(),
        np.asarray(J.bfs_distances(jcsr, 0, max_levels=2)))


def test_bfs_rejects_sources_out_of_range(pair):
    _, csr, _ = pair["er300"]
    for bad in (-1, [3, -2], 300, [0, 10**6]):
        with pytest.raises(ValueError, match="sources must lie"):
            D.bfs_distances(csr, bad)
    with pytest.raises(ValueError):
        D.nf64(csr, [-5])


@pytest.mark.parametrize("sources", ["first64", "few"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_nf64_matches_jax(name, sources, pair):
    g, csr, jcsr = pair[name]
    srcs = np.arange(64) if sources == "first64" else np.array([5, 5, 170])
    counts, masks, it = D.nf64(csr, srcs)
    jcounts, jmasks, jit = J.nf64(jcsr, srcs)
    assert it == int(jit)
    np.testing.assert_array_equal(_padded(counts, g.num_nodes() + 1),
                                  np.asarray(jcounts))
    np.testing.assert_array_equal(D.masks_to_jax(masks), np.asarray(jmasks))


# the batch runners are held to the JAX package's on a few batches of each
# graph (the ER graph's last batch is partial); the whole-graph functions
# on the ER graph
BATCHES = {"er300": (0, 5), "weblike2000": (13, 3)}  # first batch, count
BC_STARTS = {"er300": (0, 288), "weblike2000": (0, 992, 1984)}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_nf_batches_match_jax(name, pair):
    _, csr, jcsr = pair[name]
    cap = 32
    start, nb = BATCHES[name]
    counts, deepest = D.make_nf_batches(csr, cap)(start, nb)
    jcounts, jdeep = J.make_nf_batches(jcsr, cap)(start, nb)
    assert deepest == int(jdeep)
    jcounts = np.asarray(jcounts)
    np.testing.assert_array_equal(counts, jcounts[:, : deepest + 1])
    np.testing.assert_array_equal(
        jcounts[:, deepest + 1:],
        np.repeat(counts[:, -1:], cap - deepest, axis=1))


def test_nf_matches_jax_and_host(pair):
    g, csr, jcsr = pair["er300"]
    nf = D.neighbourhood_function_device(csr, batches_per_dispatch=3)
    np.testing.assert_array_equal(nf, J.neighbourhood_function_device(jcsr))
    np.testing.assert_array_equal(nf, NeighbourhoodFunction.compute(g))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_geometric_batches_match_jax(name, pair):
    """reach and the distance sums exact; the reciprocal and exponential
    sums within rtol 1e-5 (JAX sums in float32)."""
    _, csr, jcsr = pair[name]
    start, nb = BATCHES[name]
    got = D.make_geometric_batches(csr, csr.n, 0.5)(start, nb)
    ref = J.make_geometric_batches(jcsr, jcsr.n, 0.5)(start, nb)
    for i, (a, b) in enumerate(zip(got, ref)):
        if i < 2:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert a.dtype == torch.float64
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_geometric_matches_jax(pair):
    _, csr, jcsr = pair["er300"]
    got = D.geometric_centralities_device(csr, alpha=0.5,
                                          batches_per_dispatch=2)
    ref = J.geometric_centralities_device(jcsr, alpha=0.5)
    np.testing.assert_array_equal(got[4], ref[4])  # reachable
    for a, b in zip(got[:4], ref[:4]):  # closeness, harmonic, lin, exp
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-5)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_betweenness_batches_match_jax(name, pair):
    _, csr, jcsr = pair[name]
    run = D.make_betweenness_batches(csr, csr.n, 16)
    jrun = J.make_betweenness_batches(jcsr, jcsr.n, 16)
    for start in BC_STARTS[name]:
        np.testing.assert_allclose(run(start).numpy(),
                                   np.asarray(jrun(start)), rtol=1e-4)


def test_betweenness_matches_jax(pair):
    _, csr, jcsr = pair["er300"]
    np.testing.assert_allclose(D.betweenness_device(csr),
                               J.betweenness_device(jcsr), rtol=1e-4)


def test_from_graph_decodes_a_bvgraph(tmp_path):
    g = weblike_graph(2_000)
    base = os.path.join(tmp_path, "g")
    BVGraph.store(g, base)
    csr = D.DeviceCSR.from_graph(BVGraph.load(base), "cpu")
    off, succ = g.to_csr()
    np.testing.assert_array_equal(csr.offsets.numpy(), off)
    np.testing.assert_array_equal(csr.dst.numpy(), succ)
    src = np.repeat(np.arange(g.num_nodes()), np.diff(off))
    order = np.lexsort((src, succ))
    np.testing.assert_array_equal(csr.in_src.numpy(), src[order])
    np.testing.assert_array_equal(
        csr.in_off.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(succ, minlength=2000))]))
