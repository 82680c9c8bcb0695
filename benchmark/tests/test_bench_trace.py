"""The traced run's reading, on a hand-made trace (CPU)."""

import types

import pytest
import torch

from benchmark import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
BASE = 1_700_000_000 * 10**9  # Unix time, as the profiler gives it


class Event:
    def __init__(self, name, start_us, end_us, device=CUDA, kind="kernel"):
        self._n, self._a, self._b = name, start_us, end_us
        self._d, self._k = device, kind

    def name(self):
        return self._n

    def start_ns(self):
        return BASE + int(self._a * 1000)

    def end_ns(self):
        return BASE + int(self._b * 1000)

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._k in ("user_annotation", "gpu_user_annotation")


def prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=res))


def spans(*us):
    return [(BASE + a * 1000, BASE + b * 1000) for a, b in us]


def test_busy_idle_gaps_and_kernels():
    ev = [
        # device: two kernels overlapping in the first call, a copy in the
        # second, an annotation's device side (not device work)
        Event("void (anonymous namespace)::k1_parse<7>(unsigned long)",
              20, 50),
        Event("(anonymous namespace)::k2_resolve(int*)", 40, 90),
        Event("Memcpy DtoH", 160, 170, kind="gpu_memcpy"),
        Event("bench", 0, 100, kind="gpu_user_annotation"),
        Event("cudaLaunchKernel", 10, 12, CPU, "cuda_runtime"),
    ]
    # three calls: 0-100, 120-200 and 210-230 us (the last with no
    # device work)
    t = trace.read(prof(ev), spans((0, 100), (120, 200), (210, 230)),
                   "decode call")
    assert t.window_s == pytest.approx(230e-6)
    assert t.spans[1][1] - t.spans[1][0] == pytest.approx(80e-6)
    assert t.busy_s == pytest.approx(80e-6)  # 20-90 and 160-170
    assert t.span_busy_s == pytest.approx(80e-6)
    assert t.kernels == {"k1_parse<7>": 1, "k2_resolve": 1, "Memcpy DtoH": 1}
    assert dict((k, v) for k, v in t.device_ops) == pytest.approx(
        {"k1_parse<7>": 30e-6, "k2_resolve": 50e-6, "Memcpy DtoH": 10e-6})
    idle = dict((k, v) for k, v in t.idle_gaps)
    assert idle == pytest.approx({
        "decode call: host before its first device op": 60e-6,  # 0-20, 120-160
        "decode call: host after its last device op": 40e-6,   # 90-100, 170-200
        "decode call: no device work": 20e-6,                  # 210-230
        "between calls": 30e-6,                                # 100-120, 200-210
    }, abs=1e-12)


def test_gaps_between_device_ops_of_one_call():
    ev = [Event("a", 10, 20), Event("b", 50, 60), Event("c", 65, 90)]
    t = trace.read(prof(ev), spans((0, 100)), "q")
    idle = dict((k, v) for k, v in t.idle_gaps)
    assert idle == pytest.approx({
        "q: host before its first device op": 10e-6,
        "q: host between device ops": 35e-6,
        "q: host after its last device op": 10e-6}, abs=1e-12)


def test_a_trace_without_device_activity_reads_no_busy_time():
    t = trace.read(prof([Event("x", 0, 5, CPU, "cpu_op")]), spans((0, 5)),
                   "q")
    assert t.busy_s is None and t.window_s == pytest.approx(5e-6)


def test_short_names():
    assert trace.short("void (anonymous namespace)::enc_select<7>(int*)") \
        == "enc_select<7>"
    assert trace.short("Memset (Device)") == "Memset"
    assert len(trace.short("x" * 300)) == 100
