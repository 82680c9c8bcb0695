"""query_closure_records: the records a ``query`` batch decodes, its nodes
and every node their reference chains reach, the port's ``records`` count
on ``query.plan``, the mean over the traced window's calls (a program
counter)."""

from benchmark.spans import count_per_call


def read(run):
    if run.op != "query" or not run.spans:
        return None
    return count_per_call(run.spans, "query.plan", "records")
