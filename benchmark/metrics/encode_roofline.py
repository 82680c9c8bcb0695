"""encode_roofline: the least time of the traced ``encode`` calls on one H100
(``benchmark/work.py``: the graph's bytes once at 3.35 TB/s, an operation
an arc at 67 T/s) over the device time of all their kernels, copies and
memsets in the trace, in percent."""

from benchmark.metrics._device import roofline_pct


def read(run):
    return roofline_pct(run, "encode")
