"""Routing of the port's bulk decode against the JAX package's
``decode_to_csr_auto``: K1 where it takes its streaming kernel, K2 where it
takes its block-phase kernel, NotImplementedError where it falls back to
the host decoder, over windows, codings and maxref."""

import os

import pytest

from webgraph_tpu.formats.bvgraph import BVGraph as JBV
from webgraph_tpu.pallas import decode2 as JD2
from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.formats import bvgraph as F
from webgraph_tpu_torch.formats.bvgraph import BVGraph, BVGraphSettings
from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.synth import deep_chain_graph

MAXREF_INF = 2**31 - 1


@pytest.mark.parametrize("maxref", [3, 100, MAXREF_INF])
@pytest.mark.parametrize("codings", ["default", "delta", "golomb", "nibble"])
@pytest.mark.parametrize("window", [4, 7, 8])
def test_routes_like_decode_to_csr_auto(window, codings, maxref, tmp_path):
    s = BVGraphSettings(window_size=window, max_ref_count=maxref,
                        min_interval_length=2)
    if codings == "delta":
        s.codings["OUTDEGREES"] = C.DELTA
        s.codings["RESIDUALS"] = C.GAMMA
    elif codings == "golomb":
        s.codings["RESIDUALS"] = C.GOLOMB
    elif codings == "nibble":
        s.codings["BLOCKS"] = C.NIBBLE
    base = os.path.join(tmp_path, "g")
    BVGraph.store(deep_chain_graph(1200), base, settings=s)
    bv, jbv = BVGraph.load(base), JBV.load(base)
    so = jbv.settings
    ok1 = so.window_size <= 7 and all(
        c in (C.GAMMA, C.DELTA, C.ZETA, C.UNARY) for c in (
            so.outdegree_coding, so.reference_coding, so.block_count_coding,
            so.block_coding, so.residual_coding))
    ref_route = "k1" if JD2.supports(jbv) else "k2" if ok1 else "host"
    port_route = "k1" if D2.supports(bv) else "k2" if K2.supports(bv) \
        else "host"
    assert port_route == ref_route
    if port_route == "host":
        with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
            F.prepare(bv, "cpu")
    else:
        prep = F.prepare(bv, "cpu")
        assert isinstance(prep, K2.LevelPrepared) == (port_route == "k2")
