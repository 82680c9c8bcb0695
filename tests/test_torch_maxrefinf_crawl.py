"""A web crawl stored for sequential access (window 7, maxref 2^31-1,
minint 3, zeta_3: the benchmark's ``uk2002size-maxrefinf`` configuration)
through the port's normal path: ``BVGraph.load`` -> ``prepare`` ->
``decode_prepared``, and ``encode_device``.

The graph comes from the benchmark's own generator under the
configuration's parameters, cut to a few tens of thousands of nodes; the
references are independent of the port: the generator's CSR for the
decode, the benchmark's frozen encoder for the encode.  The CPU runs the
kernels' plain versions; the ``gpu`` tests run the kernels at ~2 M nodes:

    python -m pytest -m gpu tests/test_torch_maxrefinf_crawl.py
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import encoder, generator
from webgraph_tpu_torch import timing
from webgraph_tpu_torch.formats import bvgraph as B
from webgraph_tpu_torch.formats import bvgraph_encode as E
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels.plan import scan_structure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "configs",
                       "uk2002size-maxrefinf.json")) as f:
    CONFIG = json.load(f)
STORE = CONFIG["store"]
SMALL = 20_000  # nodes of the CPU tests' crawl
SEEDS = (1, 2**33 + 7)


def crawl(nodes, seed):
    """The configuration's crawl at ``nodes`` nodes: ``(offsets, succ)``."""
    return generator.weblike_graph(nodes, seed,
                                   dict(CONFIG["graph"], nodes=nodes))


def settings():
    return B.BVGraphSettings(
        window_size=STORE["window_size"],
        max_ref_count=STORE["max_ref_count"],
        min_interval_length=STORE["min_interval_length"],
        zeta_k=STORE["zeta_k"])


@pytest.fixture(scope="module", params=SEEDS)
def stored(request, tmp_path_factory):
    """``(offsets, succ, BVGraph)``: the small crawl written by the frozen
    encoder and loaded by the port, as the benchmark's set-up does."""
    off, succ = crawl(SMALL, request.param)
    base = str(tmp_path_factory.mktemp("crawl") / "g")
    encoder.store(base, off, succ, STORE)
    return off, succ, B.BVGraph.load(base)


def test_small_crawl_has_the_configurations_shape(stored):
    """Stored unbounded, the chains run 20 and more deep, each copy still
    within K1's reach, so ``prepare`` takes K1 with a level a depth."""
    off, _, g = stored
    s = g.settings
    assert (s.window_size, s.max_ref_count, s.min_interval_length,
            s.zeta_k) == (7, 2**31 - 1, 3, 3)
    scan = scan_structure(g)
    n = off.size - 1
    assert int(scan.depth.max()) >= 20
    assert int((np.arange(n) - D2._minanc(scan, n)).max()) <= D2.MAX_REACH
    prep = B.prepare(g, "cpu")
    assert isinstance(prep, D2.Prepared)
    assert len(prep.bounds) - 1 == int(scan.depth.max()) + 1
    assert prep.long.numel() > 0  # the hubs: records a block each


def test_decode_through_the_normal_path_equals_the_generator(stored):
    off, succ, g = stored
    o, s = B.decode_prepared(B.prepare(g, "cpu"))
    np.testing.assert_array_equal(o.numpy(), off)
    np.testing.assert_array_equal(s.numpy(), succ)


def test_levels_count_on_the_resolve_span_equals_the_plans_levels(stored):
    _, _, g = stored
    prep = B.prepare(g, "cpu")
    with timing.recording() as spans:
        B.decode_prepared(prep)
    got = [sp.counts["levels"] for sp in spans
           if sp.name == "decode.k2_resolve"]
    assert got == [len(prep.bounds) - 1] and got[0] > 20


def test_encode_device_equals_the_frozen_encoder(stored):
    off, succ, _ = stored
    gb, gbits, ob, obits, stats = E.encode_device(off, succ, settings(),
                                                  device="cpu")
    assert (gb, gbits, ob, obits) == encoder.encode(off, succ, STORE)
    assert stats["tot_links"] == int(off[-1])


# ----------------------------------------------------------------------
# the same on the card, at ~2 M nodes
# ----------------------------------------------------------------------

CARD_NODES = 2_000_000


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stored_large(cuda, tmp_path_factory):
    off, succ = crawl(CARD_NODES, 2**31 + 5)
    base = str(tmp_path_factory.mktemp("crawl2m") / "g")
    encoder.store(base, off, succ, STORE)
    return off, succ, base


@pytest.mark.gpu
def test_decode_on_card_equals_the_generator(stored_large, cuda):
    off, succ, base = stored_large
    prep = B.prepare(B.BVGraph.load(base), cuda)
    assert isinstance(prep, D2.Prepared) and len(prep.bounds) > 30
    before = dict(D2.decode_records.counts)
    with timing.recording() as spans:
        o, s = B.decode_prepared(prep)
    torch.cuda.synchronize()
    levels = len(prep.bounds) - 1
    assert [sp.counts["levels"] for sp in spans
            if sp.name == "decode.k2_resolve"] == [levels]
    assert D2.decode_records.counts["levels"] == before["levels"] + levels
    assert D2.decode_records.counts["k2_resolve"] == before["k2_resolve"] + 1
    np.testing.assert_array_equal(o.cpu().numpy(), off)
    np.testing.assert_array_equal(s.cpu().numpy(), succ)


@pytest.mark.gpu
def test_encode_on_card_equals_the_frozen_encoder(stored_large, cuda):
    off, succ, base = stored_large
    got = E.encode_device(torch.from_numpy(off).to(cuda),
                          torch.from_numpy(succ).to(cuda), settings())
    with open(base + ".graph", "rb") as f:
        gb = f.read()
    with open(base + ".offsets", "rb") as f:
        ob = f.read()
    assert got[0] == gb and got[2] == ob
    props = dict(line.strip().split("=", 1) for line in open(
        base + ".properties") if "=" in line)
    assert (got[1], got[3]) == (int(props["graphbits"]),
                                int(props["offsetbits"]))



@pytest.mark.parametrize("window", [1, 7, 300])
def test_chain_roots_follow_each_reference_to_its_end(window):
    """``plan.chain_roots`` (the scan's depths, K1's reach test) against
    following each node's references one at a time."""
    from webgraph_tpu_torch.kernels.plan import chain_roots

    rng = np.random.default_rng(window)
    n = 5000
    ref = np.minimum(rng.integers(-1, window + 1, n), np.arange(n))
    ref[rng.random(n) < 0.3] = 0
    root, depth = chain_roots(ref)
    for x in range(n):
        y, k = x, 0
        while ref[y] > 0:
            y, k = y - ref[y], k + 1
        assert (root[x], depth[x]) == (y, k), x
    with pytest.raises(ValueError):
        chain_roots(np.array([0, 2, 1]))  # node 1 refers before node 0


@pytest.mark.parametrize("n, gap", [(1, 5), (9, 0), (1000, 1), (100_000, 300),
                                    (5000, 10**9)])
def test_bulk_decode_of_the_offsets_index_equals_its_selects(n, gap):
    """``EliasFanoMonotoneList.get_array`` (the bit offsets that the scan
    and the upload read) against one select a value."""
    from webgraph_tpu_torch.bits.elias_fano import EliasFanoMonotoneList

    rng = np.random.default_rng(n)
    v = np.cumsum(rng.integers(0, gap + 1, n)).astype(np.int64)
    ef = EliasFanoMonotoneList(v)
    np.testing.assert_array_equal(ef.get_array(), v)
    np.testing.assert_array_equal(ef.get(np.arange(n)), v)
