"""device_idle.decode: the share of the traced window in which no kernel, copy
or memset ran on the device, in a ``decode`` cell (torch.profiler)."""

from benchmark.metrics._device import idle_pct


def read(run):
    return idle_pct(run, "decode")
