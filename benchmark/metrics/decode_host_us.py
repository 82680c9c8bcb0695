"""decode_host_us: a ``decode`` call's host time, the port's ``decode`` span
less its ``decode.wait`` (the one read, which waits for the card): checks,
allocations and the kernels' launches, the mean over the traced window's
calls, in microseconds (program spans)."""

from benchmark.spans import us_per_call


def read(run):
    if run.op != "decode" or not run.spans:
        return None
    return us_per_call(run.spans, "decode", less=("decode.wait",))
