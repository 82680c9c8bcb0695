"""query_p95_ms: the 95th percentile (nearest rank) of the host-clock
latency of every ``query`` call in the window, from the call to its answer
on the device, in milliseconds."""

import math


def read(run):
    if run.op != "query" or not run.latencies_s:
        return None
    lat = sorted(run.latencies_s)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
