"""query_host_ms: a batch's wall time less the device's busy time, the mean
over the traced window's ``query`` calls, in milliseconds: the host closure
plan, the wrappers, the gather's launches and the waits.  The wall time is
the harness's clock around each call; the busy time is the union of the
device activity in the trace, which is taken with device activity alone.
Both are read as the traced run makes them: under the profiler, whose
hooks on each launch and copy add host time, and with the port's spans
recorded (about a microsecond each, 13 a batch)."""


def read(run):
    t = run.trace
    if run.op != "query" or t is None or t.busy_s is None or not t.spans:
        return None
    wall = sum(b - a for a, b in t.spans)
    return 1e3 * (wall - t.busy_s) / len(t.spans)
