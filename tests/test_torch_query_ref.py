"""Batched random access: the port's ``QueryPlanner.successors_batch``
(webgraph_tpu_torch/kernels/query2.py, its plain versions on the CPU)
against the JAX package's (webgraph_tpu/pallas/query2.py, its K1 lane
kernel in interpret mode), on the same stored graphs and batches: the same
zero-padded block and the same counts, exactly.

Each graph's reference planner is made once for the module, and its
batches share one compilation of the reference kernel (about 10 s on the
CPU)."""

import os

import numpy as np
import pytest

from webgraph_tpu.formats.bvgraph import BVGraph as JBV
from webgraph_tpu.graph.builders import MutableGraph
from webgraph_tpu.pallas.query2 import QueryPlanner as JQueryPlanner
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.kernels.query2 import QueryPlanner

# name -> (n, p, seed, store keywords)
GRAPHS = {
    "er_default": (300, 0.04, 0, {}),
    "er_minint3": (200, 0.08, 1, dict(min_interval_length=3)),
}
BATCHES = [
    ("er_default", "random64"),
    ("er_default", "random200"),
    ("er_default", "duplicates"),
    ("er_minint3", "random64"),
    ("er_minint3", "duplicates"),
]


@pytest.fixture(scope="module")
def planners(tmp_path_factory):
    """name -> (reference planner, port planner on the CPU), both loading
    the files the JAX package stored."""
    tmp = tmp_path_factory.mktemp("query_ref")
    out = {}
    for name, (n, p, seed, kw) in GRAPHS.items():
        base = os.path.join(tmp, name)
        JBV.store(MutableGraph.erdos_renyi(n, p, seed=seed), base, **kw)
        out[name] = (JQueryPlanner(JBV.load(base)),
                     QueryPlanner(BVGraph.load(base), "cpu"))
    return out


def _batch(name, kind):
    n, _, seed, _ = GRAPHS[name]
    if kind == "duplicates":
        return np.array([5] * 10 + [0, n - 1] * 5 + list(range(44)))
    size = int(kind[len("random"):])
    return np.random.default_rng(seed + size).integers(0, n, size)


@pytest.mark.parametrize("name,kind", BATCHES)
def test_successors_batch_matches_reference(name, kind, planners):
    ref, port = planners[name]
    nodes = _batch(name, kind)
    want_out, want_counts = ref.successors_batch(nodes, interpret=True)
    out, counts = port.successors_batch(nodes)
    assert counts.numpy().dtype == want_counts.dtype
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert out.numpy().dtype == want_out.dtype
    np.testing.assert_array_equal(out.numpy(), want_out)
