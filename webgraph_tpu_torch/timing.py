"""Device timing of the port's kernels: CUDA events around whole calls, and
``torch.profiler`` traces for each kernel's own device time.  Used by
``chip_smoke.py`` and :mod:`webgraph_tpu_torch.profile_k2`; torch is
imported when a function runs, so the module imports anywhere."""

from __future__ import annotations

import statistics


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


def kernel_spans(fn, reps, names):
    """``reps`` runs of ``fn()`` traced with ``torch.profiler``: for each
    of ``names`` (kernel names), the (start, end) of its launches in
    microseconds, in launch order.  The trace may drop a few kernels'
    records; raises if it shows none of a named kernel, or more than
    ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as t:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    spans = {}
    for name in names:
        got = sorted((e.time_range.start, e.time_range.end) for e in t.events()
                     if name in e.name)
        if not 0 < len(got) <= reps:
            raise RuntimeError(f"the trace shows {len(got)} {name} kernels "
                               f"for {reps} runs")
        spans[name] = got
    return spans


def kernel_ms(fn, reps, names):
    """Median device milliseconds of each kernel of ``names`` over ``reps``
    traced runs of ``fn()``."""
    spans = kernel_spans(fn, reps, names)
    return {k: statistics.median((e - s) / 1e3 for s, e in v)
            for k, v in spans.items()}
