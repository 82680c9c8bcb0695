"""The port's encoder (webgraph_tpu_torch/formats/bvgraph_encode.py) against
the JAX package's device encoder (webgraph_tpu/formats/bvgraph_jax_encode.py)
on one graph, ``erdos_renyi(90, 0.08, seed=3)``, at window 3, maxref 2,
minint 2, ζ_3, exactly (integers, tolerance 0), on the CPU through the
kernels' plain versions:

* ``compute_costs`` (costs and valid, also at ``shard_start`` 5),
  ``select_references`` (refs, depths), ``plan_sizes``;
* ``emit_graph``: words, starts, the stats vector and both gap
  histograms; the port's starts come from the costs (``node_bits_of``),
  the JAX module's from its ``_chosen_structure``;
* ``emit_offsets``: the words.

Its own file: the JAX module's programs compile for some seconds each.
The port's bytes against the host store: tests/test_torch_encode.py."""

import numpy as np
import pytest
import torch

from webgraph_tpu.formats import bvgraph_jax_encode as JE
from webgraph_tpu.formats.bvgraph import BVGraphSettings as JSettings
from webgraph_tpu.graph.builders import MutableGraph as JMutableGraph
from webgraph_tpu_torch.formats import bvgraph_encode as E
from webgraph_tpu_torch.formats.bvgraph import BVGraphSettings
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)

KW = dict(zeta_k=3, window_size=3, max_ref_count=2, min_interval_length=2)


@pytest.fixture(scope="module")
def both():
    """The JAX module's arrays and the port's, from one CSR."""
    import jax.numpy as jnp

    g = JMutableGraph.erdos_renyi(90, 0.08, seed=3)
    off, succ = (np.asarray(a) for a in g.to_csr())
    js, s = JSettings(**KW), BVGraphSettings(**KW)
    skey = JE.skey_of(js)
    assert skey == E.skey_of(s)
    d = np.diff(off)
    iters = max(int(d.max()).bit_length(), 1)
    src = np.repeat(np.arange(len(d), dtype=np.int32), d)
    o, sc, sr = (jnp.asarray(a.astype(np.int32)) for a in (off, succ, src))
    j = {}
    j["costs"], j["valid"] = JE.compute_costs(o, sc, sr, skey, iters)
    j["costs5"], j["valid5"] = JE.compute_costs(o, sc, sr, skey, iters, 5)
    j["refs"], j["depths"] = JE.select_references(j["costs"], j["valid"],
                                                  skey)
    j["plan"] = tuple(int(v) for v in JE.plan_sizes(o, sc, sr, j["refs"],
                                                    skey, iters))
    (j["words"], j["starts"], j["stats"], j["succ_hist"],
     j["res_hist"]) = JE.emit_graph(o, sc, sr, j["refs"], j["depths"], skey,
                                    iters, 0, *j["plan"])
    node_bits = j["starts"][1:] - j["starts"][:-1]
    olens = np.asarray(JE.make_len_fn(js.offset_coding, js.zeta_k)(
        jnp.asarray(np.concatenate([[0], np.asarray(node_bits)])
                    .astype(np.uint32))))
    j["owords"] = JE.emit_offsets(node_bits, js.offset_coding, js.zeta_k,
                                  int(olens.sum()))
    j = {k: v if k == "plan" else np.asarray(v) for k, v in j.items()}

    toff = torch.as_tensor(off.astype(np.int64))
    tsucc = torch.as_tensor(succ.astype(np.int32))
    p = {}
    p["costs"], p["valid"] = E.compute_costs(toff, tsucc, None, skey)
    p["costs5"], p["valid5"] = E.compute_costs(toff, tsucc, None, skey, 5)
    p["refs"], p["depths"] = E.select_references(p["costs"], p["valid"],
                                                 skey)
    p["plan"] = E.plan_sizes(toff, tsucc, None, p["refs"], skey)
    (p["words"], p["starts"], p["stats"], p["succ_hist"],
     p["res_hist"]) = E.emit_graph(toff, tsucc, None, p["refs"], p["depths"],
                                   skey, costs=p["costs"])
    p["node_bits"] = E.node_bits_of(toff, p["costs"], p["refs"], skey)
    p["owords"] = E.emit_offsets(p["starts"][1:] - p["starts"][:-1],
                                 s.offset_coding, s.zeta_k)
    p = {k: v if k == "plan" else v.numpy() for k, v in p.items()}
    return j, p


@pytest.mark.parametrize("name", ["costs", "valid", "costs5", "valid5",
                                  "refs", "depths"])
def test_costs_and_selection_match_jax(both, name):
    j, p = both
    np.testing.assert_array_equal(p[name], j[name], err_msg=name)


def test_plan_sizes_match_jax(both):
    j, p = both
    assert p["plan"] == j["plan"]


def test_node_bits_rule_matches_jax_starts(both):
    """node_bits = outdegree code + costs[x, refs[x]] (for d > 0) equals
    the bit lengths of the JAX module's records."""
    j, p = both
    np.testing.assert_array_equal(p["node_bits"], np.diff(j["starts"]))
    np.testing.assert_array_equal(p["starts"], j["starts"])


@pytest.mark.parametrize("name", ["words", "owords"])
def test_streams_match_jax(both, name):
    j, p = both
    np.testing.assert_array_equal(p[name].view(np.uint32), j[name])


@pytest.mark.parametrize("name", ["stats", "succ_hist", "res_hist"])
def test_stats_and_histograms_match_jax(both, name):
    j, p = both
    np.testing.assert_array_equal(p[name], j[name].astype(np.int64))
