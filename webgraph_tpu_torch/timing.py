"""Device timing of the port's kernels: CUDA events around whole calls, and
``torch.profiler`` traces for each kernel's own device time and a call's
busy share.  Used by ``chip_smoke.py``, :mod:`webgraph_tpu_torch.profile_k2`
and ``tools/analytics_times.py``; torch is imported when a function runs,
so the module imports anywhere."""

from __future__ import annotations

import statistics

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
