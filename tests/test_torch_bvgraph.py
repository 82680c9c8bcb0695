"""The port's bulk decode (webgraph_tpu_torch.decode_to_csr) against the host
oracle bvgraph_np.decode_to_csr, exactly, on the graph set of
tests/test_pallas_decode2.py: on the CPU through the plain versions, and on
the card through K1's kernels, each of which must also equal its plain
version (``k1_parse`` in every slot it writes, the decode after
``k2_resolve``).  Only the port's own modules here: no JAX and nothing of the
JAX package, so the card tests run without them."""

import os

import numpy as np
import pytest
import torch

import webgraph_tpu_torch as wgt
from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.formats import bvgraph as F
from webgraph_tpu_torch.formats import bvgraph_np
from webgraph_tpu_torch.formats.bvgraph import BVGraph, BVGraphSettings
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels.plan import scan_structure
from webgraph_tpu_torch.synth import weblike_graph


def _structures():
    lists = []
    for x in range(120):
        if x % 17 == 0:
            lists.append([])
        elif x % 3 == 0:
            lists.append(list(range(x, x + 40)))           # pure interval
        elif x % 3 == 1:
            lists.append(list(range(x, x + 40)) + [200 + x, 400 + x])
        else:
            lists.append([1, 5, 9, 200 + 2 * x])           # residual-ish
    return CSRGraph.from_lists(lists)


def _delta():
    s = BVGraphSettings(window_size=4, max_ref_count=2, min_interval_length=2)
    s.codings["OUTDEGREES"] = C.DELTA
    s.codings["BLOCKS"] = C.DELTA
    s.codings["RESIDUALS"] = C.GAMMA
    return s


def _er(n, p=0.0, m=None, seed=0):
    return lambda: MutableGraph.erdos_renyi(n, p, m=m, seed=seed)


# name -> (graph factory, store keywords, long_arcs: None for the default)
GRAPHS = {
    "default": (_er(300, 0.03, seed=0),
                dict(window_size=7, max_ref_count=3, min_interval_length=4),
                None),
    "w7r3i3": (_er(200, 0.08, seed=1),
               dict(window_size=7, max_ref_count=3, min_interval_length=3),
               None),
    "no_refs": (_er(150, 0.05, seed=2),
                dict(window_size=0, max_ref_count=0, min_interval_length=4),
                None),
    "no_intervals": (_er(150, 0.05, seed=3),
                     dict(window_size=1, max_ref_count=1,
                          min_interval_length=0), None),
    "w2r2i2": (_er(250, 0.04, seed=4),
               dict(window_size=2, max_ref_count=2, min_interval_length=2),
               None),
    "deep_chains": (_er(400, 0.02, seed=5),
                    dict(window_size=7, max_ref_count=7,
                         min_interval_length=2), None),
    "structures": (_structures,
                   dict(window_size=7, max_ref_count=3,
                        min_interval_length=4), None),
    "delta": (_er(200, 0.05, seed=9), dict(settings=_delta()), None),
    "tiled": (_er(3000, m=30000, seed=11), {}, 2),
    "weblike": (lambda: weblike_graph(2000, seed=1, hubs=0),
                dict(window_size=7, max_ref_count=3, min_interval_length=3,
                     zeta_k=3), None),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stored(name, tmp):
    make, kw, long_arcs = GRAPHS[name]
    base = os.path.join(tmp, name)
    BVGraph.store(make(), base, **kw)
    return BVGraph.load(base), long_arcs


def _prepare(bv, device, long_arcs):
    """K1's plan, through the router at the default ``long_arcs``."""
    if long_arcs is None:
        return F.prepare(bv, device)
    return D2.prepare(bv, device, long_arcs=long_arcs)


def _assert_oracle(bv, off, succ):
    toff, tsucc = bvgraph_np.decode_to_csr(bv)
    np.testing.assert_array_equal(off.cpu().numpy(), toff)
    np.testing.assert_array_equal(succ.cpu().numpy(), tsucc)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_decode_matches_oracle(name, tmp_path):
    bv, long_arcs = _stored(name, tmp_path)
    prep = _prepare(bv, "cpu", long_arcs)
    assert isinstance(prep, D2.Prepared)
    if long_arcs:
        assert prep.long.numel() > 0.9 * bv.num_nodes()
    off, succ = F.decode_prepared(prep)
    assert off.dtype == torch.int64 and succ.dtype == torch.int32
    _assert_oracle(bv, off, succ)


def test_to_csr_matches_host_backend(tmp_path):
    bv, _ = _stored("default", tmp_path)
    off, succ = wgt.to_csr(bv, device="cpu")
    hoff, hsucc = bv.to_csr(backend="numpy")
    np.testing.assert_array_equal(off, hoff)
    np.testing.assert_array_equal(succ, hsucc)


def test_weblike_graph_exercises_every_record_part(tmp_path):
    g = weblike_graph(3000, seed=0, hubs=1)
    assert g.num_nodes() == 3000
    assert 8 * 3000 < g.num_arcs() < 14 * 3000
    base = os.path.join(tmp_path, "w")
    BVGraph.store(g, base, window_size=7, max_ref_count=3,
                  min_interval_length=3, zeta_k=3)
    scan = scan_structure(BVGraph.load(base))
    m = g.num_arcs()
    assert scan.copied.sum() / m > 0.2
    assert scan.int_count.sum() > 0 and scan.res_count.sum() > 0


def _counts():
    return dict(D2.decode_records.counts)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GRAPHS))
def test_kernel_matches_plain_and_oracle_on_card(name, tmp_path, cuda):
    bv, long_arcs = _stored(name, tmp_path)
    prep = _prepare(bv, cuda, long_arcs)
    assert isinstance(prep, D2.Prepared)
    args, sizes = prep.args(), prep.sizes()
    before = D2.parse_records.launches
    parsed = D2.parse_records(*args, **sizes)
    assert D2.parse_records.launches == before + 1
    plain = D2.parse_records_plain(*args[:7], **sizes)
    for got, want in zip(parsed, plain):
        assert torch.equal(got, want)
    before = _counts()
    succ = D2.decode_records(*args, **sizes)
    torch.cuda.synchronize()
    # k1_parse, and k2_resolve when a node has a parent; one read, the
    # error check
    deep = int(len(prep.bounds) > 2)
    assert _counts() == {"k1_parse": before["k1_parse"] + 1,
                         "k2_resolve": before["k2_resolve"] + deep,
                         "reads": before["reads"] + 1,
                         "levels": before["levels"] + len(prep.bounds) - 1}
    psucc, perr = D2.resolve_copies_plain(plain, prep.order, prep.bounds,
                                          prep.offsets, prep.bstart)
    assert not perr.any()
    assert torch.equal(succ, psucc)
    off, succ = wgt.decode_to_csr(bv, device=cuda)
    _assert_oracle(bv, off, succ)


@pytest.mark.gpu
def test_any_long_list_decodes_the_same_on_card(tmp_path, cuda):
    """``long`` decides only which records ``k1_parse`` gives a block each:
    a list that disagrees with ``long_arcs``, is unsorted, repeats a
    position or lies past ``order`` decodes the same CSR, since every record
    the kernel does not find in it gets a thread."""
    bv, _ = _stored("weblike", tmp_path)
    prep = D2.prepare(bv, cuda)
    n = prep.order.numel()
    want = D2.decode_prepared(prep)[1]
    rng = np.random.default_rng(3)
    for long in (np.arange(0, n, 3), rng.permutation(n)[:500],
                 np.array([5, 5, 7, n, n + 9, -1])):
        args = prep.args()[:7] + (
            torch.tensor(long, dtype=torch.int32, device=cuda),)
        assert torch.equal(D2.decode_records(*args, **prep.sizes()), want)
