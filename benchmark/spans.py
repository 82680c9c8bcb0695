"""The port's host spans (``webgraph_tpu_torch.timing``) read against a
traced window: what the harness and the span readers of
``benchmark/metrics/`` share, and a command line for what only it prints.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--seconds 3]

From the root of a checkout, on the card.  One traced run of the cell
through the harness (``harness.measure``, as ``run.py --trace 1``: the
spans recorded in ``op.setup`` and in the window of at most ``--seconds``
under ``torch.profiler``), then one JSON line:

* ``correct``, ``metrics`` (the cell's per-layer metrics), ``idle_gaps``
  (the result's breakdown: the device's idle time inside the calls by the
  innermost span open over it, :func:`idle_by_span`),
  ``idle_in_spans_share`` (the share of it that a span names) and
  ``idle_gaps_by_position`` as ``trace.read`` labels it;
* ``self_us_per_call``, ``counts_per_call``: each span name's self time
  (its duration less its children's) and each count, summed over the
  window and divided by its calls; ``setup_ms``: each set-up span's time;
* ``follows``: for ``k1_parse`` and ``enc_costs``, the share of calls in
  which the kernel's device start follows the start of the span that
  launches it (:func:`follows`), the check that spans and device events
  share one clock; ``clock_offset_us`` bounds the two clocks' offset
  from both sides (:func:`clock_offset`), ``realtime_ppm`` their drift
  over the run;
* ``span_cost_ns``: one span's host cost off and on (:func:`span_cost_ns`).

Each call is one top-level span of the port (``decode``, ``query``,
``encode``).  torch and the port are imported when a function runs.
"""

import argparse
import bisect
import json
import os
import statistics
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import trace  # noqa: E402

# (span, kernel it launches): the clock checks
FOLLOWS = (("decode.k1_parse", "k1_parse"), ("encode.costs", "enc_costs"))
# spans that each wait for one device-to-host copy to end
READS = ("decode.wait", "encode.read_totals", "encode.read_streams")
COPY = "Memcpy DtoH"


def calls(spans) -> int:
    """The calls the spans cover: their top-level spans."""
    return sum(s.parent is None for s in spans)


def total_ns(spans, name) -> int:
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name)


def self_ns(spans) -> dict:
    """Each span's duration less what its children cover, by id."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent is not None:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def per_call(spans):
    """``(self µs, counts)``: each span name's self time and each
    ``name.count`` summed over the spans, over their calls."""
    n = calls(spans)
    if not n:
        return {}, {}
    own = self_ns(spans)
    us, counts = {}, {}
    for s in spans:
        us[s.name] = us.get(s.name, 0.0) + own[s.id] / 1e3 / n
        for k, v in s.counts.items():
            key = f"{s.name}.{k}"
            counts[key] = counts.get(key, 0.0) + v / n
    return us, counts


def us_per_call(spans, name, less=()):
    """The spans ``name`` less the spans ``less``, µs a call; None where
    no call was recorded."""
    n = calls(spans)
    if not n:
        return None
    ns = total_ns(spans, name) - sum(total_ns(spans, x) for x in less)
    return ns / 1e3 / n


def count_per_call(spans, name, key):
    """The count ``key`` summed over the spans ``name``, a call; None
    where no such span carries it."""
    got = [s.counts[key] for s in spans if s.name == name and key in s.counts]
    n = calls(spans)
    return sum(got) / n if got and n else None


def segments(spans) -> list:
    """``(start, end, name)`` of the innermost span open over each stretch
    of time that some span covers, sorted."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out = []

    def walk(s):
        t = s.start_ns
        for k in kids.get(s.id, []):
            if k.start_ns > t:
                out.append((t, k.start_ns, s.name))
            walk(k)
            t = max(t, k.end_ns)
        if s.end_ns > t:
            out.append((t, s.end_ns, s.name))

    for s in kids.get(None, []):
        walk(s)
    out.sort()
    return out


def idle_by_span(busy, stamps, spans, label: str) -> dict:
    """The device's idle time in seconds from the first call's start to
    the last call's end, as ``trace.idle_by_host`` splits it, with each
    piece inside a call split again by the innermost span open over it:
    ``"<label>: host in <span>"``; a piece no span covers keeps its
    label.  ``busy``: the device's merged busy intervals, ``stamps``: the
    calls, ``(start, end)``, all in ns of ``time.time_ns()``."""
    seg = segments(spans)
    seg_starts = [a for a, _, _ in seg]
    starts = [a for a, _ in busy]
    idle = {}

    def add(key, ns):
        if ns > 0:
            idle[key] = idle.get(key, 0.0) + ns / 1e9

    def piece(x, y, where):
        """The idle stretch ``[x, y)`` inside a call, ``where`` its label
        where no span covers it."""
        left = y - x
        i = max(bisect.bisect_right(seg_starts, x) - 1, 0)
        for a, b, name in seg[i:]:
            if a >= y:
                break
            cut = min(b, y) - max(a, x)
            if cut > 0:
                add(f"{label}: host in {name}", cut)
                left -= cut
        add(f"{label}: {where}", left)

    stamps = sorted(stamps)
    for k, (a, b) in enumerate(stamps):
        inside = []
        for x, y in busy[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if x >= b:
                break
            if y > a:
                inside.append((max(x, a), min(y, b)))
        if not inside:
            piece(a, b, "no device work")
        else:
            piece(a, inside[0][0], "host before its first device op")
            for (_, y), (x, _) in zip(inside, inside[1:]):
                piece(y, x, "host between device ops")
            piece(inside[-1][1], b, "host after its last device op")
        if k + 1 < len(stamps):
            c = stamps[k + 1][0]
            add("between calls", (c - b) - trace.overlap(busy, starts, b, c))
    return idle


def in_spans_share(idle: dict, label: str) -> float | None:
    """The share of the idle time inside calls that a span names."""
    inside = {k: v for k, v in idle.items() if k.startswith(label + ":")}
    total = sum(inside.values())
    named = sum(v for k, v in inside.items()
                if k.startswith(f"{label}: host in "))
    return named / total if total > 0 else None


def named_gaps(tr, stamps, spans, label: str):
    """``(gaps, share)`` of a traced window (``trace.Trace`` ``tr``, its
    calls ``stamps`` in ns): the :data:`trace.TOP` longest idle gaps of
    :func:`idle_by_span`, ``[label, seconds]``, and
    :func:`in_spans_share`."""
    busy = trace.union((a, b) for _, a, b in tr.events)
    idle = idle_by_span(busy, stamps, spans, label)
    top = sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])
    return top[:trace.TOP], in_spans_share(idle, label)


def _paired(spans, names, device, op):
    """The spans of ``names`` and the device ops ``op`` (a name up to its
    template arguments), ``((start, end), (start, end))`` pairs in order
    of their starts; None where their numbers differ (the profiler
    dropped records)."""
    sp = sorted((s.start_ns, s.end_ns) for s in spans if s.name in names)
    ev = sorted((a, b) for n, a, b in device if n.split("<")[0] == op)
    return list(zip(sp, ev)) if len(sp) == len(ev) else None


def follows(device, spans, span_name: str, kernel: str):
    """The launches of ``kernel`` (device ops ``(name, start, end)``)
    paired in order with the spans ``span_name``, one launch a span: the
    share whose device start follows the span's start, and the lags in
    µs (the medians of the first and last tenth of the calls show a drift
    between the two clocks).  ``share`` None where the launches do not
    pair one to one with the spans."""
    pairs = _paired(spans, (span_name,), device, kernel)
    if not pairs:
        return {"spans": sum(s.name == span_name for s in spans),
                "share": None}
    lags = [(e[0] - s[0]) / 1e3 for s, e in pairs]
    tenth = max(len(lags) // 10, 1)
    return {"spans": len(lags),
            "share": sum(v >= 0 for v in lags) / len(lags),
            "lag_us": {"min": min(lags), "median": statistics.median(lags),
                       "max": max(lags),
                       "first_tenth": statistics.median(lags[:tenth]),
                       "last_tenth": statistics.median(lags[-tenth:])}}


def clock_offset(device, spans) -> dict:
    """Bounds on how far, in µs, the device events' times run ahead of
    the spans' clock (``time.time_ns()``): no further than the least lag
    of a launch of :data:`FOLLOWS` behind the start of the span that
    issues it (``high``), and no less than the most that a device-to-host
    copy ends past the end of the :data:`READS` span that waits for it
    (``low``).  A bound with nothing to pair is None."""
    high = [e[0] - s[0] for name, kernel in FOLLOWS
            for s, e in _paired(spans, (name,), device, kernel) or []]
    low = [e[1] - s[1] for s, e in _paired(spans, READS, device, COPY) or []]
    return {"low": max(low) / 1e3 if low else None,
            "high": min(high) / 1e3 if high else None}


def report(run, result) -> dict:
    """What the command line prints of a traced run (``harness.measure``):
    the module's docstring lists it, but ``realtime_ppm`` and
    ``span_cost_ns``."""
    tr, sp = run.trace, run.spans
    us, counts = per_call(sp)
    setup = {}
    for s in run.setup_spans:
        setup[s.name] = setup.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    out = {"correct": result["correct"], "calls": len(tr.spans),
           "failed": run.failed,
           "metrics": {k: m["value"] for k, m in result["metrics"].items()},
           "self_us_per_call": us, "counts_per_call": counts,
           "setup_ms": setup, "window_s": tr.window_s, "busy_s": tr.busy_s}
    if tr.busy_s is not None:
        out.update(
            idle_gaps=result["breakdown"]["idle_gaps"],
            idle_in_spans_share=result["info"]["idle_in_calls_named_by_spans"],
            idle_gaps_by_position=tr.idle_gaps,
            follows={k: follows(tr.events, sp, s, k) for s, k in FOLLOWS
                     if any(x.name == s for x in sp)},
            clock_offset_us=clock_offset(tr.events, sp))
    return out


def span_cost_ns(reps: int = 100_000, rounds: int = 5) -> dict:
    """The host cost of one ``with span(...)`` block, recording off and
    on, over an empty loop's turn: the medians of ``rounds`` timings of
    ``reps`` spans, ns a span."""
    from webgraph_tpu_torch import timing

    def loop(body):
        t = time.perf_counter_ns()
        for _ in range(reps):
            body()
        return (time.perf_counter_ns() - t) / reps

    def one():
        with timing.span("cost"):
            pass

    def none():
        pass

    got = {"off": [], "on": []}
    base = []
    for _ in range(rounds):
        base.append(loop(none))
        got["off"].append(loop(one))
        with timing.recording():
            got["on"].append(loop(one))
    b = statistics.median(base)
    return {k: statistics.median(v) - b for k, v in got.items()}


def main(argv=None) -> int:
    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=harness.TRACE_SECONDS)
    a = p.parse_args(argv)

    import torch

    from benchmark.run import power_limit

    if not torch.cuda.is_available():
        print("spans.py: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(a.workload)
    raw = time.CLOCK_MONOTONIC_RAW
    clocks = [(time.time_ns(), time.clock_gettime_ns(raw))]
    run, result = harness.measure(cell, a.seed, a.seconds, True, "cuda",
                                  time.perf_counter())
    clocks.append((time.time_ns(), time.clock_gettime_ns(raw)))
    out = report(run, result)
    # how far time.time_ns() ran from the raw monotonic clock over the
    # run, parts a million
    out["realtime_ppm"] = 1e6 * ((clocks[1][0] - clocks[0][0])
                                 / (clocks[1][1] - clocks[0][1]) - 1)
    out["span_cost_ns"] = span_cost_ns()
    print(json.dumps({"cell": a.workload, "seed": a.seed,
                      "card": power_limit(), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
