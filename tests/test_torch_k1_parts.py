"""K1's parts (webgraph_tpu_torch/kernels/decode2.py) on the CPU: the
doubling that finds a long record's code starts (``code_starts_plain``)
against the scalar reader, the plan's long records and host sizes, and
the route on a graph of long records, a window-0 graph and a corrupted
long record against the JAX package's host decoder.  Exact: the outputs
are integers.  The kernels themselves are held to these plain versions on
the card by tests/test_torch_bvgraph.py and chip_smoke.py."""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from webgraph_tpu.formats import bvgraph_np as J_np
from webgraph_tpu.formats.bvgraph import BVGraph as JBV
from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits.bitstream import OutputBitStream, bytes_to_words
from webgraph_tpu_torch.formats import bvgraph as F
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels.plan import scan_structure
from webgraph_tpu_torch.synth import deep_chain_graph, long_record_graph

CNR = dict(window_size=7, max_ref_count=3, min_interval_length=3, zeta_k=3)
CODINGS = [("gamma", C.GAMMA, 0), ("delta", C.DELTA, 0), ("unary", C.UNARY, 0)
           ] + [(f"zeta{k}", C.ZETA, k) for k in range(1, 8)]


def _stream(write):
    """The scalar writer's stream of ``write(obs)`` as int64 words with two
    zero pads."""
    obs = OutputBitStream()
    write(obs)
    w = np.concatenate([bytes_to_words(obs.to_bytes()), np.zeros(2, np.uint64)])
    return torch.from_numpy(w.view(np.int64)), obs.written_bits


def _codes(coding, k, values, lead):
    """``lead`` one-bit γ codes, then ``values`` in ``coding``: the stream,
    each value's start and the end."""
    pos = []

    def write(obs):
        for _ in range(lead):
            obs.write_gamma(0)
        for v in values:
            pos.append(obs.written_bits)
            obs.write(coding, int(v), k)

    words, end = _stream(write)
    return words, pos, end


@pytest.mark.parametrize("name,coding,k", CODINGS)
@settings(max_examples=20, deadline=None)
@given(data=st.data())
def test_code_starts_match_scalar_reader(name, coding, k, data):
    """Every start of a run of codes that crosses tile ends, found by
    doubling tile by tile, is where the scalar writer put it."""
    hi = 40 if coding == C.UNARY else (1 << data.draw(st.integers(1, 20)))
    values = data.draw(st.lists(st.integers(0, hi), min_size=1, max_size=300))
    lead = data.draw(st.integers(0, 70))
    tile = data.draw(st.sampled_from([64, 96, 256, 8192]))
    words, pos, end = _codes(coding, k, values, lead)
    count = data.draw(st.integers(0, len(values)))
    starts, got_end, err = D2.code_starts_plain(words, lead, count, coding, k,
                                                tile_bits=tile)
    assert err == 0
    np.testing.assert_array_equal(starts.numpy(), pos[:count])
    assert got_end == (pos[count] if count < len(values) else end)


@pytest.mark.parametrize("where", ["on", "off"])
def test_invalid_code_fails_only_on_the_chain(where):
    """γ codes of 2**30 - 1 are 30 zeros, a one and 30 zeros, so two of them
    hold a 60-bit run of zeros: positions inside it have no valid γ code,
    but none of them starts a code of the chain.  A run of 64 zeros after
    the last code is invalid on the chain, and fails only when the count
    reaches it."""
    values = [5, 2**30 - 1, 2**30 - 1, 7, 0, 3]

    def write(obs):
        for v in values:
            obs.write_gamma(v)
        obs.write_unary(70)  # 70 zeros then a one

    words, _ = _stream(write)
    count = len(values) + (1 if where == "on" else 0)
    starts, end, err = D2.code_starts_plain(words, 0, count, C.GAMMA,
                                            tile_bits=64)
    assert starts.numel() == len(values)
    assert err == (D2.ERR_CODE if where == "on" else 0)
    assert end == sum(2 * (int(v + 1).bit_length() - 1) + 1 for v in values)


@pytest.fixture(scope="module")
def long_graph(tmp_path_factory):
    """The long-record graph stored with cnr-2000's parameters: the port's
    BVGraph and the JAX package's host decode of it."""
    base = os.path.join(tmp_path_factory.mktemp("long"), "g")
    BVGraph.store(long_record_graph(), base, **CNR)
    return BVGraph.load(base), J_np.decode_to_csr(JBV.load(base))


@pytest.mark.parametrize("long_arcs", [None, 2])
def test_long_records_match_jax_host_decoder(long_graph, long_arcs):
    bv, (toff, tsucc) = long_graph
    prep = F.prepare(bv, "cpu") if long_arcs is None else \
        D2.prepare(bv, "cpu", long_arcs=long_arcs)
    assert isinstance(prep, D2.Prepared)
    scan = scan_structure(bv)
    assert scan.res_count[10] > 3000 and scan.int_count[13] > 512
    assert int(bv.bit_offsets[11] - bv.bit_offsets[10]) > 4 * D2.TILE_BITS
    off, succ = F.decode_prepared(prep)
    np.testing.assert_array_equal(off.numpy(), toff)
    np.testing.assert_array_equal(succ.numpy(), tsucc)


@pytest.mark.parametrize("long_arcs", [D2.LONG_ARCS, 2])
def test_plan_lists_long_records(long_graph, long_arcs):
    """``long`` holds the positions in ``order`` of exactly the records of
    at least ``long_arcs`` arcs, ascending; the sizes are host ints."""
    bv, _ = long_graph
    prep = D2.prepare(bv, "cpu", long_arcs=long_arcs)
    d = np.diff(prep.offsets.numpy())
    order = prep.order.numpy().astype(np.int64)
    want = np.flatnonzero(d[order] >= long_arcs)
    np.testing.assert_array_equal(prep.long.numpy(), want)
    assert prep.long.dtype == torch.int32 and prep.long_arcs == long_arcs
    assert type(prep.m) is int and prep.m == int(prep.offsets[-1])
    assert type(prep.nblocks) is int and prep.nblocks == int(prep.bstart[-1])


def test_k2_plan_keeps_sizes_on_the_host(tmp_path):
    base = os.path.join(tmp_path, "g")
    BVGraph.store(deep_chain_graph(1200), base, max_ref_count=2**31 - 1,
                  min_interval_length=2)
    prep = F.prepare(BVGraph.load(base), "cpu")
    assert isinstance(prep, K2.LevelPrepared)
    assert prep.sizes() == {"m": int(prep.offsets[-1]),
                            "nblocks": int(prep.bstart[-1])}


def test_window0_graph_has_no_copy_level(tmp_path):
    """Without references every node has depth 0: one level, no copy
    launch, every list straight from the parse."""
    base = os.path.join(tmp_path, "g")
    g = MutableGraph.erdos_renyi(400, 0.05, seed=7)
    BVGraph.store(g, base, window_size=0, max_ref_count=0,
                  min_interval_length=2)
    bv = BVGraph.load(base)
    prep = D2.prepare(bv, "cpu", long_arcs=2)
    assert len(prep.bounds) == 2 and prep.nblocks == 0
    assert prep.long.numel() > 300
    off, succ = D2.decode_prepared(prep)
    toff, tsucc = J_np.decode_to_csr(JBV.load(base))
    np.testing.assert_array_equal(off.numpy(), toff)
    np.testing.assert_array_equal(succ.numpy(), tsucc)


def test_corrupted_long_record_raises(long_graph):
    """Node 10's residuals zeroed from their middle on: no ζ_3 code reads
    there, so the node fails, and so does node 11, which copies it."""
    bv, _ = long_graph
    prep = D2.prepare(bv, "cpu", long_arcs=2)
    lo, hi = int(bv.bit_offsets[10]), int(bv.bit_offsets[11])
    w = prep.words.numpy().view(np.uint64).copy()
    for p in range((lo + hi) // 2, hi):
        w[p >> 6] &= ~(np.uint64(1) << np.uint64(63 - (p & 63)))
    words = torch.from_numpy(w.view(np.int64))
    with pytest.raises(RuntimeError, match="invalid code, parent failed"):
        D2.decode_records(words, *prep.args()[1:], **prep.sizes())
