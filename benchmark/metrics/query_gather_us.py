"""query_gather_us: a ``query`` batch's gather, the port's ``query.gather``
span (the decoded closure's lists moved into the batch's rows by torch
calls on the device), the mean over the traced window's calls, in
microseconds of host time (program spans)."""

from benchmark.spans import us_per_call


def read(run):
    if run.op != "query" or not run.spans:
        return None
    return us_per_call(run.spans, "query.gather")
