"""K1: the port's lane planning and plain PyTorch decoder against the JAX
package's (webgraph_tpu/pallas/decode2.py, its kernel run in interpret
mode).  Exact.  The kernel itself is held to the plain decoder on the
card by tests/test_torch_bvgraph.py."""

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


def _assert_plan_equal(port, ref):
    for f in D2._PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    for f in D2._PLAN_SCALARS:
        assert getattr(port, f) == getattr(ref, f), f


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


@pytest.mark.parametrize("window,maxref,minint,seed,n,p", [
    (7, 3, 4, 0, 300, 0.03),
    (0, 0, 4, 2, 150, 0.05),
    (7, 7, 2, 5, 400, 0.02),
])
def test_plan_lanes_matches_reference(window, maxref, minint, seed, n, p,
                                      tmp_path):
    g = MutableGraph.erdos_renyi(n, p, seed=seed)
    bv = _store(g, tmp_path, window_size=window, max_ref_count=maxref,
                min_interval_length=minint)
    scan = scan_structure(bv)
    _assert_plan_equal(D2.plan_lanes(bv, scan), R.plan_lanes(bv, scan))


def test_plan_tiles_matches_reference(tmp_path):
    g = MutableGraph.erdos_renyi(3000, m=30000, seed=11)
    bv = _store(g, tmp_path)
    scan = scan_structure(bv)
    port = D2.plan_tiles(bv, scan, tile_arcs=5000)
    ref = R.plan_tiles(bv, scan, tile_arcs=5000)
    assert len(port) == len(ref) >= 5
    for p, r in zip(port, ref):
        _assert_plan_equal(p, r)


def test_plain_decoder_matches_reference_kernel(default_graph):
    """Fed the reference's own plan, the plain decoder emits the same count
    in every lane and the same value in every real slab slot."""
    bv, ref_plan, ref_slab, ref_wp = default_graph
    plan = D2.plan_from_reference(ref_plan)
    words = D2.stream_words(bv, "cpu")
    bo = torch.from_numpy(np.asarray(bv.bit_offsets, np.int64))
    slab, wp = D2.decode_lanes(words, bo, D2.LaneInputs.of(plan, "cpu"),
                               D2.coding_key(bv.settings))
    np.testing.assert_array_equal(wp.numpy(), ref_wp[: plan.lanes])
    np.testing.assert_array_equal(wp.numpy(), plan.exp_wp.numpy())
    take = _slab_take(ref_plan, scan_structure(bv).d)
    np.testing.assert_array_equal(slab.numpy().reshape(-1)[take],
                                  ref_slab.reshape(-1)[take])


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
    ("slab", "slab row overflow"),
    ("stream", "invalid code"),
])
def test_lane_errors_raise(fault, message, tmp_path):
    """A lane whose lists do not fit its slab row, or whose stream holds
    no valid code, fails loudly instead of returning garbage."""
    g = MutableGraph.erdos_renyi(200, 0.05, seed=4)
    bv = _store(g, tmp_path)
    plan = D2.plan_lanes(bv, scan_structure(bv))
    words = D2.stream_words(bv, "cpu")
    bo = torch.from_numpy(np.asarray(bv.bit_offsets, np.int64))
    li = D2.LaneInputs.of(plan, "cpu")
    if fault == "slab":
        li.slabw = 1
    else:
        words = torch.zeros_like(words)  # 64 zero bits: no γ code
    with pytest.raises(RuntimeError, match=message):
        D2.decode_lanes(words, bo, li, D2.coding_key(bv.settings))
