"""K1: the port's decode against the JAX package's K1
(webgraph_tpu/pallas/decode2.py, its kernel run in interpret mode).  Exact.
The kernels themselves are held to their plain versions on the card by
tests/test_torch_bvgraph.py, and their parts on the CPU by
tests/test_torch_k1_parts.py."""

import os

import numpy as np
import pytest
import torch

from webgraph_tpu.bits import codes as C
from webgraph_tpu.formats.bvgraph import BVGraph, BVGraphSettings
from webgraph_tpu.graph.builders import MutableGraph
from webgraph_tpu.pallas import decode2 as R
from webgraph_tpu.pallas.plan import scan_structure
import webgraph_tpu_torch as wgt
from webgraph_tpu_torch.kernels import decode2 as D2


def _store(g, tmp, name="g", **kw):
    base = os.path.join(tmp, name)
    BVGraph.store(g, base, **kw)
    return BVGraph.load(base)


def _slab_take(plan, d):
    """Flat slab positions of the real nodes' arcs, in CSR order."""
    d = d[plan.lo:plan.hi].astype(np.int64)
    prow = np.asarray(plan.prow, np.int64)[: plan.hi - plan.lo]
    start = np.cumsum(d) - d
    return np.repeat(prow, d) + (np.arange(d.sum()) - np.repeat(start, d))


@pytest.fixture(scope="module")
def default_graph(tmp_path_factory):
    """The 300-node default graph and its decode by the reference kernel
    (interpret mode): (bv, reference plan, slab, wp)."""
    tmp = tmp_path_factory.mktemp("default")
    g = MutableGraph.erdos_renyi(300, 0.03, seed=0)
    bv = _store(g, tmp, window_size=7, max_ref_count=3,
                min_interval_length=4)
    plan, slab, wp, _ = R.decode_to_slab(bv, interpret=True)
    return bv, plan, slab, wp


def test_slice_matches_reference_kernel(default_graph):
    """The port's whole path gives the CSR the reference kernel's slab
    holds (decode2.decode_to_csr's assembly)."""
    bv, ref_plan, ref_slab, _ = default_graph
    d = scan_structure(bv).d
    off, succ = wgt.decode_to_csr(bv, device="cpu")
    np.testing.assert_array_equal(np.diff(off.numpy()), d)
    np.testing.assert_array_equal(
        succ.numpy(), ref_slab.reshape(-1)[_slab_take(ref_plan, d)])


def test_unsupported_graph_raises(tmp_path):
    g = MutableGraph.erdos_renyi(100, 0.05, seed=12)
    s = BVGraphSettings(window_size=4, max_ref_count=2)
    s.codings["RESIDUALS"] = C.GOLOMB
    bv = _store(g, tmp_path, settings=s)
    assert not D2.supports(bv)
    assert D2.supports(_store(g, tmp_path, "std"))
    with pytest.raises(NotImplementedError, match="K2"):
        wgt.decode_to_csr(bv, device="cpu")


@pytest.mark.parametrize("fault,message", [
    ("stream", "invalid code"),
])
def test_lane_errors_raise(fault, message, tmp_path):
    """A graph whose stream holds no valid code fails loudly instead of
    returning garbage, on the port's K1 route."""
    g = MutableGraph.erdos_renyi(200, 0.05, seed=4)
    bv = _store(g, tmp_path)
    prep = D2.prepare(bv, "cpu")
    words = torch.zeros_like(prep.words)  # 64 zero bits: no γ code
    args = (words,) + prep.args()[1:]
    with pytest.raises(RuntimeError, match=message):
        D2.decode_records(*args, **prep.sizes())
