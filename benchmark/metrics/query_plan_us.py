"""query_plan_us: a ``query`` batch's closure plan on the host, the port's
``query.plan`` span (the closure of the batch's nodes and its depth
order, in NumPy), the mean over the traced window's calls, in
microseconds (program spans)."""

from benchmark.spans import us_per_call


def read(run):
    if run.op != "query" or not run.spans:
        return None
    return us_per_call(run.spans, "query.plan")
