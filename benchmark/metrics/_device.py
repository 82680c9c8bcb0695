"""Helpers of the per-layer readers: shares of a traced window, None where
the trace holds no device activity (a run that traced no device)."""


def idle_pct(run, op):
    t = run.trace
    if run.op != op or t is None or t.busy_s is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(run, op):
    """The least time of the traced calls on one H100 over the device time
    they took (all their kernels, copies and memsets)."""
    t = run.trace
    if (run.op != op or t is None or not t.busy_s or run.least_s is None
            or not t.spans):
        return None
    return 100.0 * len(t.spans) * run.least_s / t.busy_s
