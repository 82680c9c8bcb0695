"""The traced run's reading of a ``torch.profiler`` trace taken with device
activity only: device busy time, each device operation's time, and the
idle gaps by where the host was in the calls.

The host side comes from the harness's own clock: the start and end of
each call as ``time.time_ns()`` read them, on the clock that the
profiler's events are given on (Unix time in nanoseconds).  The profiler
traces no host operation; the harness names the host's part of a gap by
the port's own spans (``benchmark/spans.py``).

The benchmark's own copy of the ideas of the port's
``webgraph_tpu_torch/timing.py`` (device activity summed from the
profiler's events), so that a change to the port cannot change how it is
measured.  torch is imported when a function runs.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

TOP = 10  # entries of each breakdown list


@dataclass
class Trace:
    """What one traced window holds, in seconds."""

    window_s: float                      # first call's start to last's end
    spans: list                          # (start, end) of each call
    busy_s: float | None                 # union of device activity
    span_busy_s: float | None            # device activity inside the calls
    device_ops: list = field(default_factory=list)  # [name, seconds]
    idle_gaps: list = field(default_factory=list)   # [host label, seconds]
    kernels: dict = field(default_factory=dict)     # name -> launches
    # (short name, start, end) of each device op, in ns of time.time_ns()
    events: list = field(default_factory=list)


def short(name: str) -> str:
    """A kernel's name without its namespace, return type and argument
    list, at most 100 characters."""
    name = name.replace("(anonymous namespace)::", "").strip()
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()[:100] or name[:100]


def union(intervals):
    """The sorted, merged union of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(merged, starts, a, b) -> float:
    """Length of ``[a, b]`` that the merged intervals cover (``starts``:
    their starts)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    for x, y in merged[i:]:
        if x >= b:
            break
        total += max(0.0, min(b, y) - max(a, x))
    return total


def idle_by_host(merged, spans, label) -> dict:
    """The device's idle time from the first call's start to the last
    call's end, by where the host was: in a call before its first device
    operation, between two of them, after its last one, or between calls.
    ``merged``: the device's busy intervals; ``spans``: the calls."""
    starts = [a for a, _ in merged]
    idle = {}

    def add(key, seconds):
        if seconds > 0:
            idle[key] = idle.get(key, 0.0) + seconds

    for k, (a, b) in enumerate(spans):
        inside = []
        for x, y in merged[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if x >= b:
                break
            if y > a:
                inside.append((max(x, a), min(y, b)))
        if not inside:
            add(f"{label}: no device work", b - a)
        else:
            add(f"{label}: host before its first device op",
                inside[0][0] - a)
            add(f"{label}: host between device ops",
                sum(x - y for (_, y), (x, _) in zip(inside, inside[1:])))
            add(f"{label}: host after its last device op", b - inside[-1][1])
        if k + 1 < len(spans):
            c = spans[k + 1][0]
            add("between calls", (c - b) - overlap(merged, starts, b, c))
    return idle


def read(prof, spans_ns, label: str) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` of
    device activity, whose calls ran in ``spans_ns`` (``(start, end)``
    pairs of ``time.time_ns()``); ``label`` names a call."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    if not spans_ns:
        raise RuntimeError("the traced window holds no call")
    # seconds from the first call's start, exact to the nanosecond
    base = min(a for a, _ in spans_ns)
    spans = sorted(((a - base) / 1e9, (b - base) / 1e9) for a, b in spans_ns)
    t0, t1 = spans[0][0], spans[-1][1]
    # kernels, copies and memsets; not the device side of an annotation
    events = [(short(e.name()), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and not e.is_user_annotation()]
    if not events:
        return Trace(t1 - t0, spans, None, None)
    device = [(n, (a - base) / 1e9, (b - base) / 1e9) for n, a, b in events]
    merged = union((a, b) for _, a, b in device)
    busy = sum(b - a for a, b in merged)
    starts = [a for a, _ in merged]
    span_busy = sum(overlap(merged, starts, a, b) for a, b in spans)
    per, kernels = {}, {}
    for name, a, b in device:
        per[name] = per.get(name, 0.0) + (b - a)
        kernels[name] = kernels.get(name, 0) + 1
    idle = idle_by_host(merged, spans, label)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
    gtop = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(t1 - t0, spans, busy, span_busy,
                 [[k, v] for k, v in top], [[k, v] for k, v in gtop],
                 kernels, events)
