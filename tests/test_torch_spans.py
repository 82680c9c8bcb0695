"""Host spans of the port (webgraph_tpu_torch/timing.py): off unless
recorded, and the span trees of a decode, a batch of queries, an encode
and their set-up, on the CPU through the plain versions of the kernels."""

import os

import numpy as np
import pytest

from webgraph_tpu_torch import timing
from webgraph_tpu_torch.formats import bvgraph as F
from webgraph_tpu_torch.formats import bvgraph_encode as E
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels.query2 import QueryPlanner
from webgraph_tpu_torch.synth import weblike_graph

DECODE = ["decode.check", "decode.k1_parse", "decode.k2_resolve",
          "decode.wait"]
# each call's spans in the order they start, with their parents' names
TREES = {
    "decode": [("decode", None)] + [(c, "decode") for c in DECODE],
    "query": [("query", None), ("query.plan", "query")]
    + [("query.upload", "query")] * 3 + [("decode", "query")]
    + [(c, "decode") for c in DECODE]
    + [("query.gather", "query"), ("query.upload", "query.gather")],
    "encode": [("encode", None)] + [
        (f"encode.{c}", "encode") for c in (
            "costs", "select", "layout", "read_totals", "emit",
            "read_streams", "unpack")],
    "prepare": [("prepare", None)] + [
        (f"prepare.{c}", "prepare") for c in ("scan", "plan", "upload")],
    "planner": [("prepare", None), ("prepare.scan", "prepare"),
                ("prepare.upload", "prepare")],
}


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    """``(g, its BVGraph)``: a web-like graph stored for K1 (window 7,
    maxref 3), with copies, intervals and residuals."""
    g = weblike_graph(400, seed=1)
    base = os.path.join(tmp_path_factory.mktemp("spans"), "w")
    BVGraph.store(g, base, window_size=7, max_ref_count=3,
                  min_interval_length=3, zeta_k=3)
    return g, BVGraph.load(base)


def _nodes(n):
    return np.random.default_rng(5).integers(0, n, 64)


def _call(kind, g, bv):
    if kind == "decode":
        prep = F.prepare(bv, "cpu")
        with timing.recording() as spans:
            F.decode_prepared(prep)
    elif kind == "query":
        qp = QueryPlanner(bv, "cpu")
        with timing.recording() as spans:
            qp.successors_batch(_nodes(bv.num_nodes()))
    elif kind == "encode":
        off, succ = g.to_csr()
        with timing.recording() as spans:
            E.encode_device(off, succ, bv.settings, device="cpu")
    elif kind == "prepare":
        with timing.recording() as spans:
            F.prepare(bv, "cpu")
    else:
        with timing.recording() as spans:
            QueryPlanner(bv, "cpu")
    return spans


def _assert_well_formed(spans):
    """Ids in start order, one call id for each top-level span and its
    spans, every child inside its parent, siblings one after another,
    times rising."""
    by_id = {s.id: s for s in spans}
    assert [s.id for s in spans] == list(range(len(spans)))
    starts = [s.start_ns for s in spans]
    assert starts == sorted(starts)
    last_end = {}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.call == s.id
        else:
            p = by_id[s.parent]
            assert p.id < s.id and s.call == p.call
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.start_ns >= last_end.get(s.parent, 0)
        last_end[s.parent] = s.end_ns


def test_recording_is_off_by_default(graph):
    g, bv = graph
    off = timing.span("decode")
    assert timing.span("query.plan") is off  # one shared object
    with off as s:
        assert s.count(records=3) is off
    F.decode_prepared(F.prepare(bv, "cpu"))  # nothing records these
    with timing.recording() as spans:
        pass
    assert spans == []
    assert timing.span("decode") is off


def test_recordings_do_not_nest():
    with timing.recording() as spans:
        with pytest.raises(RuntimeError, match="already"):
            with timing.recording():
                pass
        with timing.span("outer"):
            pass
    assert [s.name for s in spans] == ["outer"]
    with timing.recording() as again:  # the first one ended
        pass
    assert again == []


def test_nesting_ids_and_counts_of_hand_made_spans():
    with timing.recording() as spans:
        with timing.span("a") as a:
            a.count(bytes=4)
            with timing.span("b") as b:
                b.count(bytes=1, rows=2)
                b.count(bytes=1)
            a.count(bytes=4)
        with timing.span("c"):
            with timing.span("d"):
                pass
    _assert_well_formed(spans)
    got = [(s.name, s.id, s.parent, s.call, s.counts) for s in spans]
    assert got == [("a", 0, None, 0, {"bytes": 8}),
                   ("b", 1, 0, 0, {"bytes": 2, "rows": 2}),
                   ("c", 2, None, 2, {}), ("d", 3, 2, 2, {})]


def test_a_span_ends_when_its_call_raises():
    with timing.recording() as spans:
        with pytest.raises(ValueError, match="non-empty"):
            E.encode_device(np.zeros(1, np.int64), np.zeros(0, np.int32),
                            F.BVGraphSettings(), device="cpu")
    assert [s.name for s in spans] == ["encode"]
    assert spans[0].end_ns >= spans[0].start_ns


@pytest.mark.parametrize("kind", list(TREES))
def test_span_tree(kind, graph):
    g, bv = graph
    spans = _call(kind, g, bv)
    _assert_well_formed(spans)
    by_id = {s.id: s for s in spans}
    tree = [(s.name, None if s.parent is None else by_id[s.parent].name)
            for s in spans]
    assert tree == TREES[kind]
    assert len({s.call for s in spans}) == 1


def test_query_plan_counts_the_closure_and_the_uploads(graph):
    _, bv = graph
    qp = QueryPlanner(bv, "cpu")
    nodes = _nodes(bv.num_nodes())
    plan = qp.plan(nodes)  # made apart from the recorded call
    with timing.recording() as spans:
        qp.successors_batch(nodes)
    (p,) = [s for s in spans if s.name == "query.plan"]
    assert p.counts == {"records": plan.order.size,
                        "levels": plan.bounds.size - 1}
    up = sum(s.counts["h2d_bytes"] for s in spans
             if s.name == "query.upload")
    # counts and nodes as int64, the closure and its long records as int32
    assert up == 16 * nodes.size + 4 * (plan.order.size + plan.long.size)


def test_encode_counts_the_bytes_it_reads(graph):
    g, bv = graph
    off, succ = g.to_csr()
    with timing.recording() as spans:
        gb, _, ob, _, _ = E.encode_device(off, succ, bv.settings,
                                          device="cpu")
    reads = {s.name: s.counts["d2h_bytes"] for s in spans
             if "d2h_bytes" in s.counts}
    # three int64 totals and enc_select's three counts
    assert reads["encode.read_totals"] == 48
    assert reads["encode.read_streams"] >= len(gb) + len(ob)
    # the words are on the host already: nothing lands in page-locked memory
    (streams,) = [s for s in spans if s.name == "encode.read_streams"]
    assert streams.counts["pinned_bytes"] == 0


def test_cpu_decode_counts_no_read_from_the_card(graph):
    """``decode_records.counts["reads"]`` counts the error check's read
    from the card; the plain route reads nothing from one."""
    _, bv = graph
    prep = F.prepare(bv, "cpu")
    before = dict(D2.decode_records.counts)
    F.decode_prepared(prep)
    assert "reads" in before and D2.decode_records.counts == before
