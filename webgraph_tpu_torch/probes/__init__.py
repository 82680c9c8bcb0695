"""Fragment probes of the decoders on the card: the counterparts of the JAX
package's TPU probe scripts, one module a script.

* :mod:`.winmach` — ``scripts/pallas_winmach_chip.py``: sequential ζ₃
  reads a lane (``wgt::BufReader``), kernel ``probe_winmach``;
* :mod:`.gamma` — ``scripts/pallas_probe.py``: one γ read at a position,
  through K0's ``k0_probe``;
* :mod:`.composite` — ``scripts/pallas_composite_probe.py``: relayout,
  merge trip, refill, slab compaction and page fetch (``probe_relayout``,
  ``probe_merge_trip``, ``probe_refill``, ``probe_compaction``,
  ``probe_page_fetch``);
* :mod:`.fetch` — ``scripts/pallas_fetch_bench.py``: pool gathers, summed
  (``probe_fetch``);
* :mod:`.onehot` — ``scripts/pallas_onehot_probe.py``: a table-row gather
  (``probe_row_gather``);
* :mod:`.timing5`, :mod:`.bisect4`, :mod:`.bisect3`, :mod:`.perf` —
  ``scripts/pallas_timing5.py``, ``pallas_bisect4.py``, ``pallas_bisect3.py``,
  ``pallas_perf_probe.py``: primitives timed in a loop (trip recurrence,
  gather, int8 product, byte-plane refill, transpose, async copy, stack
  fetch, compaction frame), on the eight kernel families of :mod:`.loops`;
* :mod:`.caps`, :mod:`.bisect`, :mod:`.bisect2` —
  ``scripts/pallas_caps_probe.py``, ``pallas_bisect_probe.py``,
  ``pallas_bisect2.py``: single-shot forms (gathers, relayouts, rolls,
  products, one-hot products, copies at device-held offsets, clz, a counted
  loop), on the seven kernel families of :mod:`.forms`;
* :mod:`.v6`, :mod:`.v6b` — ``scripts/v6_probe.py``, ``v6_probe2.py``: the
  streaming decoder's primitives (two forms; the state machine's trip, the
  stream fetch, the fetch body's primitives in a loop), on :mod:`.forms`
  and three more kernels of :mod:`.loops`.

Each module makes the script's inputs from the script's seeds, has a plain
PyTorch version of each kernel and a wrapper that counts its launches (CPU
tensors take the plain version; CUDA tensors launch the kernel or raise),
and a ``main()`` for ``python -m webgraph_tpu_torch.probes.<name>``, which
runs on the card unless ``--device cpu`` is given.  The kernels are in
``csrc/probes.cu``, ``csrc/loops.cu`` (:mod:`.loops`) and ``csrc/forms.cu``
(:mod:`.forms`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from webgraph_tpu_torch.kernels import _build

M32 = 0xFFFFFFFF


def s32(x):
    """int64 tensor -> the int32 value of its low 32 bits (still int64)."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def check(fn: str, name: str, t, dtype, shape, dev):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev``."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def launch(wrapper, entry: str, dev, *args):
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of ``dev``, raise on a refused launch, count it on ``wrapper``."""
    if dev.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {dev}")
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(entry, rc)
    wrapper.launches += 1


def tensors(arrays, casts, dev):
    """numpy ``arrays`` as tensors on ``dev``, array i cast to ``casts[i]``
    where that is given and not None (e.g. bf16, which numpy lacks)."""
    out = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        cast = casts[i] if i < len(casts) else None
        out.append(t if cast is None else t.to(cast))
    return out


def device_of(name):
    """The torch device for ``--device`` (a name or a device): the card
    unless ``cpu``; raises where the card was asked for and there is
    none."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card "
                           "(pass --device cpu for the plain versions)")
    return dev


def device_ms(dev, fn):
    """Median CUDA-event milliseconds of ``fn()`` over 5 runs after one
    warm-up run; None (not timed) off the card."""
    from webgraph_tpu_torch.timing import cuda_ms

    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    return cuda_ms(fn, 5)


def timed(ms) -> str:
    """A run's time for a probe's printed line."""
    return "not timed (cpu)" if ms is None else f"{ms:.4f} ms on the card"


def parser(doc: str):
    """The probes' command line: ``--device`` (default ``cuda``)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels, timed) or cpu (the plain versions)")
    return p
