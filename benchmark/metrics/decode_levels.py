"""decode_levels: the depth levels a ``decode`` call resolves, the port's
``levels`` count on ``decode.k2_resolve`` (the plan's chain depths, each
waiting on the one before it inside ``k2_resolve``), the mean over the
traced window's calls (a program counter); None where the port records
no such count."""

from benchmark.spans import count_per_call


def read(run):
    if run.op != "decode" or not run.spans:
        return None
    return count_per_call(run.spans, "decode.k2_resolve", "levels")
