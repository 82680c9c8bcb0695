"""The port's host spans read against a traced window (benchmark/spans.py)
and the span readers of benchmark/metrics/: gap labels, clock check and
readers on hand-made spans and traces, and the harness's runs on the CPU
at the tiny size, traced and untraced (CPU)."""

import gc
import os
import types

import pytest

from benchmark import harness, trace
from benchmark import spans as S
from webgraph_tpu_torch import timing
from webgraph_tpu_torch.timing import Span

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]
# the per-layer metrics that read the port's spans and counts
SPAN_METRICS = [m["name"] for m in SPEC["per_layer"]
                if m["source"] in ("program_span", "program_counter")]

US = 1000  # ns


def _spans(*rows):
    """Spans from ``(name, parent id, start µs, end µs[, counts])`` rows,
    ids in row order, each call that of its top-level span."""
    out = []
    for i, (name, parent, a, b, *counts) in enumerate(rows):
        call = i if parent is None else out[parent].call
        out.append(Span(name, i, parent, call, a * US, b * US,
                        counts[0] if counts else {}))
    return out


# two query calls, 0-100 and 120-200 µs; device busy 30-40, 60-70, 150-160
CALLS = [(0, 100 * US), (120 * US, 200 * US)]
BUSY = [[30 * US, 40 * US], [60 * US, 70 * US], [150 * US, 160 * US]]
QUERY = _spans(
    ("query", None, 2, 98),
    ("query.plan", 0, 3, 20, {"records": 30, "levels": 2}),
    ("query.upload", 0, 22, 28, {"h2d_bytes": 64}),
    ("decode", 0, 29, 50),
    ("decode.wait", 3, 45, 50),
    ("query.gather", 0, 55, 90),
    ("query", None, 125, 195),
    ("query.plan", 6, 126, 140, {"records": 10, "levels": 1}),
    ("query.gather", 6, 165, 190),
)


def test_segments_name_the_innermost_span():
    seg = S.segments(QUERY[:5])
    assert seg == [(2 * US, 3 * US, "query"), (3 * US, 20 * US, "query.plan"),
                   (20 * US, 22 * US, "query"),
                   (22 * US, 28 * US, "query.upload"),
                   (28 * US, 29 * US, "query"), (29 * US, 45 * US, "decode"),
                   (45 * US, 50 * US, "decode.wait"),
                   (50 * US, 98 * US, "query")]


def test_gaps_by_span():
    idle = S.idle_by_span(BUSY, CALLS, QUERY, "q")
    assert idle == pytest.approx({
        # call 1 idles 0-30, 40-60, 70-100; call 2 120-150, 160-200
        "q: host before its first device op": 7e-6,    # 0-2, 120-125
        "q: host in query": 38e-6,
        "q: host in query.plan": 31e-6,                # 3-20, 126-140
        "q: host in query.upload": 6e-6,
        "q: host in decode": 6e-6,                     # 29-30, 40-45
        "q: host in decode.wait": 5e-6,
        "q: host in query.gather": 50e-6,              # 55-60, 70-90, 165-190
        "q: host after its last device op": 7e-6,      # 98-100, 195-200
        "between calls": 20e-6,
    }, abs=1e-12)
    named = sum(v for k, v in idle.items() if k.startswith("q: host in"))
    inside = sum(v for k, v in idle.items() if k.startswith("q:"))
    assert S.in_spans_share(idle, "q") == pytest.approx(named / inside)
    # the harness's breakdown: the longest gaps first, and the share
    tr = types.SimpleNamespace(events=[("k", a, b) for a, b in BUSY])
    gaps, share = S.named_gaps(tr, CALLS, QUERY, "q")
    assert gaps[0] == ["q: host in query.gather", pytest.approx(50e-6)]
    assert dict(gaps) == pytest.approx(idle, abs=1e-12)
    assert [v for _, v in gaps] == sorted(idle.values(), reverse=True)
    assert share == pytest.approx(named / inside)


def test_gaps_without_spans_are_labelled_as_the_trace_labels_them():
    idle = S.idle_by_span(BUSY, CALLS, [], "q")
    want = trace.idle_by_host([list(map(float, b)) for b in BUSY],
                              [tuple(map(float, c)) for c in CALLS], "q")
    assert idle == pytest.approx({k: v / 1e9 for k, v in want.items()},
                                 abs=1e-12)
    assert S.in_spans_share(idle, "q") == 0.0


def _read(op, spans, setup):
    """The span readers of ``benchmark/metrics/`` on a run of ``op`` with
    ``spans`` and ``setup``: name -> value, those that find something."""
    run = types.SimpleNamespace(op=op, spans=spans, setup_spans=setup)
    out = {}
    for name in SPAN_METRICS:
        mod = harness.load_module(
            os.path.join(harness.ROOT, "benchmark", "metrics", name + ".py"),
            "benchmark_metric_" + name)
        v = mod.read(run)
        if v is not None:
            out[name] = v
    return out


def test_readers_on_hand_made_spans():
    got = _read("query", QUERY, [])
    assert got == pytest.approx({"query_plan_us": (17 + 14) / 2,
                                 "query_gather_us": (35 + 25) / 2,
                                 "query_closure_records": 20.0})
    decode = _spans(("decode", None, 0, 10), ("decode.wait", 0, 6, 9),
                    ("decode", None, 20, 24), ("decode.wait", 2, 22, 24))
    setup = _spans(("prepare", None, 0, 5000),
                   ("prepare.scan", 0, 0, 3000))
    assert _read("decode", decode, setup) == pytest.approx(
        {"decode_host_us": (7 + 2) / 2, "scan_ms": 3.0})
    encode = _spans(("encode", None, 0, 100),
                    ("encode.read_totals", 0, 10, 15,
                     {"d2h_bytes": 48, "select_rerun_nodes": 7}),
                    ("encode.read_streams", 0, 60, 90, {"d2h_bytes": 800}))
    assert _read("encode", encode, setup) == {"encode_host_us": 65.0,
                                              "select_rerun_nodes": 7.0}
    # a program without spans, or a run that recorded none: nothing to read
    assert _read("decode", [], []) == {}
    assert _read("query", None, None) == {}
    us, counts = S.per_call(encode)
    assert us == pytest.approx({"encode": 65.0, "encode.read_totals": 5.0,
                                "encode.read_streams": 30.0})
    assert counts == {"encode.read_totals.d2h_bytes": 48.0,
                      "encode.read_totals.select_rerun_nodes": 7.0,
                      "encode.read_streams.d2h_bytes": 800.0}


def test_follows_pairs_launches_with_their_spans():
    sp = _spans(("decode", None, 0, 50), ("decode.k1_parse", 0, 5, 10),
                ("decode", None, 60, 90), ("decode.k1_parse", 2, 62, 70))
    dev = [("k1_parse", 8 * US, 20 * US), ("k2_resolve", 20 * US, 30 * US),
           ("k1_parse", 61 * US, 75 * US)]
    f = S.follows(dev, sp, "decode.k1_parse", "k1_parse")
    assert f["share"] == 0.5 and f["lag_us"] == {
        "min": -1.0, "median": 1.0, "max": 3.0, "first_tenth": 3.0,
        "last_tenth": -1.0}
    f = S.follows(dev[:1], sp, "decode.k1_parse", "k1_parse")
    assert f == {"spans": 2, "share": None}
    tmpl = [("enc_costs<7>", 8 * US, 9 * US)]
    enc = _spans(("encode", None, 0, 50), ("encode.costs", 0, 5, 10))
    assert S.follows(tmpl, enc, "encode.costs", "enc_costs")["share"] == 1.0


@pytest.mark.parametrize("name,want", [
    ("cnr2000-maxref3.decode", {"decode_host_us", "scan_ms"}),
    ("cnr2000-maxref3.query", {"query_plan_us", "query_gather_us",
                               "query_closure_records", "scan_ms"}),
    ("cnr2000-maxref3.encode", {"encode_host_us", "select_rerun_nodes"}),
])
def test_a_cpu_window_reads_its_cells_quantities(name, want, tiny_cell):
    """A traced run of each tiny cell reports exactly its span metrics (a
    CPU trace holds no device activity, so no device metric reads), a
    value for each, and what the command line prints of it."""
    run, r = harness.measure(tiny_cell(name), 3_000_000_017, 0.05, True,
                             "cpu", 0.0)
    assert r["correct"] and run.failed == 0 and len(run.trace.spans) >= 1
    assert set(r["metrics"]) == want
    assert want == {m["name"] for m in SPEC["per_layer"]
                    if m["name"] in SPAN_METRICS
                    and name in m.get("workloads", CELLS)}
    for k, m in r["metrics"].items():
        counter = k in ("query_closure_records", "select_rerun_nodes")
        assert m["value"] >= 0 if counter else m["value"] > 0, k
    out = S.report(run, r)
    root = name.rsplit(".", 1)[1]
    assert out["self_us_per_call"][root] > 0
    assert out["metrics"] == {k: m["value"] for k, m in r["metrics"].items()}
    assert "idle_gaps" not in out  # no device traced on the CPU
    assert r["breakdown"]["idle_gaps"] == run.trace.idle_gaps == []


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_records_no_span(name, tiny_cell, monkeypatch):
    """Untraced, the recorder stays off through set-up and the window:
    ``timing.span`` is the shared do-nothing object in every call, and the
    run holds no spans."""
    cell = tiny_cell(name)
    step, seen = cell.op.step, []

    def watched(ctx, state, i):
        seen.append(timing.span("x") is timing._OFF
                    and timing._REC.events is None)
        return step(ctx, state, i)

    monkeypatch.setattr(cell.op, "step", watched)
    run, r = harness.measure(cell, 3_000_000_019, 0.05, False, "cpu", 0.0)
    assert r["correct"] and seen and all(seen)
    assert run.spans is None and run.setup_spans is None
    assert "breakdown" not in r
    assert timing._REC.events is None


@pytest.mark.parametrize("trace_on", [False, True])
def test_only_a_traced_window_pauses_the_collector(trace_on, tiny_cell,
                                                   monkeypatch):
    """Traced, the collector is off through the window's calls, so that
    the spans' records set off no collection there, and on again after;
    untraced, the window runs as it always has."""
    window, seen = harness.window, []

    def watched(*args, **kw):
        seen.append(gc.isenabled())
        return window(*args, **kw)

    monkeypatch.setattr(harness, "window", watched)
    assert gc.isenabled()
    run, r = harness.measure(tiny_cell(CELLS[0]), 3_000_000_029, 0.05,
                             trace_on, "cpu", 0.0)
    assert r["correct"] and seen == [not trace_on]
    assert gc.isenabled()


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_run_counters_are_the_info_lines(name, trace_on, tiny_cell):
    run, r = harness.measure(tiny_cell(name), 3_000_000_023, 0.05, trace_on,
                             "cpu", 0.0)
    assert run.counters == r["info"]["counters_per_call"]
    assert set(run.counters) == set(tiny_cell(name).op.counters())


def test_span_cost_is_measured():
    cost = S.span_cost_ns(reps=2000, rounds=1)
    assert set(cost) == {"off", "on"}
    assert cost["on"] > 0


def test_clock_offset_is_bounded_from_both_sides():
    """A launch starts after its span opens: the device clock runs ahead
    by at most the least lag (2 µs); a copy the host waits for ends
    before its span ends: ahead by at least the most it ends past it
    (-1 µs: 1 µs before the span's end in the later call)."""
    sp = _spans(("decode", None, 0, 50), ("decode.k1_parse", 0, 5, 10),
                ("decode.wait", 0, 30, 45),
                ("decode", None, 60, 100), ("decode.k1_parse", 3, 62, 70),
                ("decode.wait", 3, 80, 95))
    dev = [("k1_parse", 7 * US, 20 * US), ("Memcpy DtoH", 35 * US, 40 * US),
           ("k1_parse", 66 * US, 75 * US), ("Memcpy DtoH", 90 * US, 94 * US)]
    assert S.clock_offset(dev, sp) == {"low": -1.0, "high": 2.0}
    assert S.clock_offset(dev[:3], sp) == {"low": None, "high": 2.0}
    assert S.clock_offset([], []) == {"low": None, "high": None}
