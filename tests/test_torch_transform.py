"""The port's device transforms (webgraph_tpu_torch/transform/device.py)
against the host copy of transform/transform.py and against the JAX
package's transform/device.py, on the seeded graphs of
tests/test_transform_device.py.  Exact.  Card twins skip without one."""

import os

import numpy as np
import pytest
import torch

from webgraph_tpu.graph.builders import MutableGraph as JMG
from webgraph_tpu.transform import device as JD
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.synth import weblike_graph
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)
from webgraph_tpu_torch.transform import device as D
from webgraph_tpu_torch.transform import transform as T

GRAPHS = {
    "er400": lambda: MutableGraph.erdos_renyi(400, 0.02, seed=8),
    "er300": lambda: MutableGraph.erdos_renyi(300, 0.02, seed=3),
    "weblike2000": lambda: weblike_graph(2_000),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _perms(n):
    """A permutation with deletions, and a map that merges nodes (so arcs
    land on one another and the dedup removes them)."""
    rng = np.random.default_rng(5)
    perm = rng.permutation(n).astype(np.int64)
    perm[perm % 7 == 0] = -1
    merge = (np.arange(n) // 3).astype(np.int64)
    merge[5] = -1
    return {"deletions": perm, "merges": merge}


def _eq(got, ref):
    roff, rsucc = ref.to_csr()
    np.testing.assert_array_equal(got[0], roff)
    np.testing.assert_array_equal(got[1], rsucc)
    assert got[0].dtype == np.int64


@pytest.mark.parametrize("name", list(GRAPHS))
def test_transpose_and_symmetrize_match_host_copy(name):
    g = GRAPHS[name]()
    _eq(D.transpose_device(g, device="cpu"), T.transpose(g))
    _eq(D.symmetrize_device(g, device="cpu"), T.symmetrize(g))


@pytest.mark.parametrize("kind", ["deletions", "merges"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_map_matches_host_copy(name, kind):
    g = GRAPHS[name]()
    perm = _perms(g.num_nodes())[kind]
    _eq(D.map_device(g, perm, device="cpu"), T.map_graph(g, perm))


@pytest.mark.parametrize("seed,n,p", [(8, 400, 0.02), (3, 300, 0.02),
                                      (11, 120, 0.1)])
def test_match_the_jax_package(seed, n, p):
    """The same seeded ER graph through both packages' device transforms."""
    g, jg = MutableGraph.erdos_renyi(n, p, seed=seed), \
        JMG.erdos_renyi(n, p, seed=seed)
    for mine, theirs in ((D.transpose_device(g, device="cpu"),
                          JD.transpose_device(jg)),
                         (D.symmetrize_device(g, device="cpu"),
                          JD.symmetrize_device(jg))):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
    for perm in _perms(n).values():
        for a, b in zip(D.map_device(g, perm, device="cpu"),
                        JD.map_device(jg, perm)):
            np.testing.assert_array_equal(a, b)


def test_sort_dedup_tensor_form():
    """Duplicates and deleted arcs are compacted away; the tail is SENT,
    and ``m`` stays a tensor on the device."""
    src = torch.tensor([3, 1, 1, D.SENT, 0, 3, 1], dtype=torch.int32)
    dst = torch.tensor([2, 0, 0, D.SENT, 5, 2, 4], dtype=torch.int32)
    s1, s2, m = D.sort_dedup_arcs(src, dst)
    assert torch.is_tensor(m) and int(m) == 4
    assert s1.tolist() == [0, 1, 1, 3] + [D.SENT] * 3
    assert s2.tolist() == [5, 0, 4, 2] + [D.SENT] * 3
    off, succ = D.sorted_arcs_to_csr(s1, s2, 4, m)
    assert off.tolist() == [0, 1, 3, 3, 4]


def test_empty_inputs_give_no_arcs():
    """Reference defect 4 (ROADMAP C): on no arcs the JAX sort_dedup_arcs
    does not give m = 0 (it reads ``pos[-1]`` of an empty array: an
    IndexError with this JAX, m = 1 as first recorded); the port gives 0."""
    e = torch.zeros(0, dtype=torch.int32)
    assert int(D.sort_dedup_arcs(e, e)[2]) == 0
    try:
        jm = int(JD.sort_dedup_arcs(np.zeros(0, np.int32),
                                    np.zeros(0, np.int32))[2])
    except IndexError:
        jm = None
    assert jm != 0
    for g in (CSRGraph.from_lists([[], [], []]), CSRGraph.from_lists([])):
        n = g.num_nodes()
        for got in (D.transpose_device(g, device="cpu"),
                    D.symmetrize_device(g, device="cpu"),
                    D.map_device(g, np.arange(n), device="cpu")):
            np.testing.assert_array_equal(got[0], np.zeros(n + 1))
            assert got[1].size == 0
    g = CSRGraph.from_lists([[1], [0]])
    off, succ = D.map_device(g, np.array([-1, -1]), device="cpu")
    assert off.tolist() == [0] and succ.size == 0


def test_bvgraph_is_decoded_on_the_device(tmp_path):
    """``graph_csr`` decodes a BVGraph through the port's decode route (its
    plain versions on the CPU), not through ``to_csr``."""
    g = GRAPHS["weblike2000"]()
    base = os.path.join(tmp_path, "g")
    BVGraph.store(g, base)
    bv = BVGraph.load(base)
    bv.to_csr = None  # the host decode must not be used
    off, succ = D.graph_csr(bv, "cpu")
    toff, tsucc = g.to_csr()
    np.testing.assert_array_equal(off.numpy(), toff)
    np.testing.assert_array_equal(succ.numpy(), tsucc)
    _eq(D.transpose_device(bv, device="cpu"), T.transpose(g))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GRAPHS))
def test_transforms_on_card(name, cuda):
    g = GRAPHS[name]()
    _eq(D.transpose_device(g, device=cuda), T.transpose(g))
    _eq(D.symmetrize_device(g, device=cuda), T.symmetrize(g))
    for perm in _perms(g.num_nodes()).values():
        _eq(D.map_device(g, perm, device=cuda), T.map_graph(g, perm))
