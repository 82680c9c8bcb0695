"""K2 against the JAX package's block-phase kernel itself
(webgraph_tpu/pallas/decode.py, run in interpret mode as its own tests run
it): one call on a deep-chain graph that spans several 96-node blocks (800 nodes, reach 264) and
that K1 does not take.  The port's routed decode on the CPU (the plain
level decoder) must give the identical CSR.  Exact: the outputs are
integers.  One call of the reference costs 35-45 s, so it has a file of its
own."""

import os

import numpy as np
import pytest

from webgraph_tpu.formats.bvgraph import BVGraph as JBV
import webgraph_tpu_torch as wgt
from webgraph_tpu_torch.formats import bvgraph as F
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.synth import deep_chain_graph

pytest.importorskip("jax")

from webgraph_tpu.pallas import decode as R  # noqa: E402


def test_levels_match_reference_kernel(tmp_path):
    base = os.path.join(tmp_path, "g")
    BVGraph.store(deep_chain_graph(800), base, window_size=7,
                  max_ref_count=2**31 - 1, min_interval_length=2)
    bv = BVGraph.load(base)
    assert not D2.supports(bv)
    prep = F.prepare(bv, "cpu")
    assert isinstance(prep, K2.LevelPrepared) and prep.bounds.size > 100
    roff, rsucc = R.decode_to_csr(JBV.load(base), interpret=True, lanes=96)
    off, succ = wgt.decode_to_csr(bv, device="cpu")
    assert len(roff) - 1 > 5 * 96  # several blocks of the reference
    np.testing.assert_array_equal(off.numpy(), roff)
    np.testing.assert_array_equal(succ.numpy(), rsucc)
