"""Timing of the port: CUDA events around whole calls, ``torch.profiler``
traces for each kernel's own device time and a call's busy share, and host
spans inside the port's decode, query and encode calls.

The device timers serve ``chip_smoke.py``,
:mod:`webgraph_tpu_torch.profile_k2` and ``tools/analytics_times.py``.
The spans (:func:`span`, :func:`recording`) are read by whoever records
them: each holds a name, its start and end as ``time.time_ns()`` reads
them (the Unix clock that ``torch.profiler`` gives its device events on,
so a span lines up with the kernels it launched), its parent and the id
of the top-level call it belongs to.  A span never waits for the card or
reads from it; the device's own time is the profiler's to take.  torch is
imported when a function runs, so the module imports anywhere."""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field

TRACES = 3  # traces kernel_runs and trace_busy take before they give up


class NoWholeRun(RuntimeError):
    """Every trace :func:`kernel_runs` took dropped a record of a run."""


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_runs(fn, reps, names):
    """``reps`` runs of ``fn()`` in one ``torch.profiler`` trace, split
    into runs at the launches of ``names[0]`` (one a run): a list of the
    runs whose share of the trace shows every launch, each a dict from the
    kernel names of ``names`` to the (start, end) of their one launch in
    microseconds.  A run whose records the trace dropped is left out; a
    trace that shows no whole run is taken again, up to :data:`TRACES`
    times, then this raises :class:`NoWholeRun`."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    for _ in range(TRACES):
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as t:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        spans = {name: sorted((e.time_range.start, e.time_range.end)
                              for e in t.events() if name in e.name)
                 for name in names}
        starts = [s for s, _ in spans[names[0]]] + [float("inf")]
        runs = []
        for a, b in zip(starts[:-1], starts[1:]):
            run = {k: [x for x in v if a <= x[0] < b]
                   for k, v in spans.items()}
            if all(len(v) == 1 for v in run.values()):
                runs.append({k: v[0] for k, v in run.items()})
        if runs:
            return runs
    raise NoWholeRun(f"no run of {reps} shows every launch of {names} "
                       f"in {TRACES} traces")


def kernel_ms(fn, reps, names):
    """Median device milliseconds of each kernel of ``names`` over ``reps``
    runs of ``fn()`` (:func:`kernel_runs`)."""
    runs = kernel_runs(fn, reps, names)
    return {k: statistics.median((r[k][1] - r[k][0]) / 1e3 for r in runs)
            for k in names}


def trace_busy(fn, kernel, launches=0):
    """``(device ms, ms of each launch of kernel)`` of one run of ``fn``
    under ``torch.profiler``, device activity only: the summed durations of
    its kernels, copies and memsets, and those of its launches of the kernel
    whose name holds ``kernel``.  A trace that holds no device activity, or
    fewer than ``launches`` launches of it (the profiler dropped records),
    is taken again, up to :data:`TRACES` times; then ``(None, [])``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as t:
            fn()
            torch.cuda.synchronize()
        dur = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
               for e in t.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        runs = [d for k, d in dur if kernel in k]
        if dur and len(runs) >= launches:
            return sum(d for _, d in dur), runs
    return None, []


# ----------------------------------------------------------------------
# host spans
# ----------------------------------------------------------------------


@dataclass
class Span:
    """One finished host span, as :func:`recording` gives it: ``name``;
    ``start_ns`` and ``end_ns`` (``time.time_ns()``); ``id``, its place in
    the order the recording's spans started; ``parent``, the id of the
    span it opened inside (None at the top); ``call``, the id of the
    top-level span it lies in; ``counts``, what ``count`` added."""

    name: str
    id: int
    parent: int | None
    call: int
    start_ns: int
    end_ns: int
    counts: dict = field(default_factory=dict)


class _On:
    """A span while recording: logs its start, and its end with its
    counts, to the recording; :func:`recording` makes the
    :class:`Span` records when it ends, so that a span costs two clock
    reads and two appends."""

    __slots__ = ("name", "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts = None

    def __enter__(self):
        _REC.events.append((self.name, time.time_ns()))
        return self

    def __exit__(self, *exc):
        t = time.time_ns()
        _REC.events.append(t if self.counts is None else (t, self.counts))
        return False

    def count(self, **kw):
        """Add ``kw``'s numbers to the span's counts."""
        if self.counts is None:
            self.counts = {}
        for k, v in kw.items():
            self.counts[k] = self.counts.get(k, 0) + v
        return self


class _Off:
    """What :func:`span` returns while nothing records: enters, counts
    and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **kw):
        return self


class _Recorder:
    """The recording in progress: the log of span starts and ends, None
    while nothing records.  The port calls the card from one host thread
    and so does this: spans of two threads at once would nest wrongly."""

    def __init__(self):
        self.events = None


_OFF = _Off()
_REC = _Recorder()


def span(name: str):
    """A context manager that records the host span ``name`` while
    :func:`recording` is on; ``with span(...) as s: s.count(bytes=n)``
    attaches counts.  Off, it is one shared object that does nothing: no
    allocation, no clock read."""
    if _REC.events is None:
        return _OFF
    return _On(name)


def _spans(events) -> list:
    """The :class:`Span` records of a recording's log, in the order they
    started."""
    spans, open_ = [], []
    for e in events:
        if isinstance(e, tuple) and isinstance(e[0], str):
            i = len(spans)
            top = open_[-1] if open_ else None
            s = Span(e[0], i, None if top is None else top.id,
                     i if top is None else top.call, e[1], e[1])
            spans.append(s)
            open_.append(s)
        else:
            s = open_.pop()
            s.end_ns, counts = (e, None) if isinstance(e, int) else e
            s.counts = counts or {}
    return spans


@contextlib.contextmanager
def recording():
    """Record the spans that run inside the block: yields a list that
    holds their :class:`Span` records, in the order they started, once
    the block has ended.  Recordings do not nest."""
    if _REC.events is not None:
        raise RuntimeError("spans are being recorded already")
    out = []
    _REC.events = []
    try:
        yield out
    finally:
        events, _REC.events = _REC.events, None
        out.extend(_spans(events))
