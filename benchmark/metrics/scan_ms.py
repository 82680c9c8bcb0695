"""scan_ms: the structure scan of set-up in a ``decode`` or ``query`` cell,
the port's ``prepare.scan`` spans recorded in ``op.setup`` of a traced
run (the stored graph's records read on the host before the plan), in
milliseconds (program spans)."""

from benchmark.spans import total_ns


def read(run):
    if run.op not in ("decode", "query") or not run.setup_spans:
        return None
    if not any(s.name == "prepare.scan" for s in run.setup_spans):
        return None
    return total_ns(run.setup_spans, "prepare.scan") / 1e6
