"""encode_host_us: an ``encode`` call's host time, the port's ``encode``
span less its two reads (``encode.read_totals``, ``encode.read_streams``,
which wait for the card): the launches, the layout and the unpacking of
the bytes, the mean over the traced window's calls, in microseconds
(program spans)."""

from benchmark.spans import us_per_call


def read(run):
    if run.op != "encode" or not run.spans:
        return None
    return us_per_call(run.spans, "encode",
                       less=("encode.read_totals", "encode.read_streams"))
