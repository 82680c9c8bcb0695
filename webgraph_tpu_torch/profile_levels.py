"""Where K2's time goes, level by level, on the card.

For each K2 cell of ``synth.CELLS`` (the web-like graph of cnr-2000's
size stored with unbounded maxref, and config 3's deep-chain graph at
minint 2) this times the whole decode (one C loop of launches,
:func:`cuda_ms`, median of 5 after a warm-up), then traces one more
decode with ``torch.profiler`` and reads each level's kernel from the
trace, in launch order.  It prints one JSON line per cell: the sum of the per-level kernel
times and the device's busy share over the traced span (the rest is the
gap between dependent launches), level 0's time and size, the slowest
level, and how many levels fill fewer than the card's SMs with 128-thread
blocks, with the time they take.

    python3 -m webgraph_tpu_torch.profile_levels
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile(bv, label, card):
    import numpy as np
    import torch

    from webgraph_tpu_torch.kernels import decode as K2

    prep = K2.prepare(bv, "cuda")
    args = (prep.words, prep.bo, prep.order, prep.bounds, prep.offsets,
            prep.skey)
    K2.decode_levels(*args)
    whole = cuda_ms(lambda: K2.decode_levels(*args), 5)

    # one decode traced: the device time of every level's kernel
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as t:
        K2.decode_levels(*args)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in t.events()
                   if "k2_level" in e.name)
    bounds = np.asarray(prep.bounds, dtype=np.int64)
    levels = len(bounds) - 1
    if len(spans) != levels:
        raise RuntimeError(f"{label}: the trace shows {len(spans)} k2_level "
                           f"kernels, expected {levels}")
    per = np.array([(e - s) / 1e3 for s, e in spans])  # ms
    traced_ms = (spans[-1][1] - spans[0][0]) / 1e3
    n, m = prep.order.numel(), int(prep.offsets[-1])
    sizes = np.diff(bounds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-sizes // 128)
    out = {
        "cell": label, "card": card, "n": n, "m": m, "levels": levels,
        "decode_ms": whole, "traced_ms": traced_ms,
        "sum_level_ms": float(per.sum()),
        "busy_share": float(per.sum() / traced_ms),
        "mean_gap_us": float((traced_ms - per.sum()) / max(levels - 1, 1)
                             * 1e3),
        "level0_ms": float(per[0]), "level0_nodes": int(sizes[0]),
        "median_level_ms": float(np.median(per)),
        "max_level_ms": float(per.max()),
        "max_level": int(per.argmax()),
        "max_level_nodes": int(sizes[per.argmax()]),
        "levels_under_sms": int((blocks < sms).sum()), "sms": sms,
        "levels_one_warp": int((sizes <= 32).sum()),
        "ms_in_levels_under_sms": float(per[blocks < sms].sum()),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_levels: no CUDA device", file=sys.stderr)
        return 1
    from webgraph_tpu_torch.formats.bvgraph import BVGraph
    from webgraph_tpu_torch.synth import CELLS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        for label, (make, kw, kernel) in CELLS.items():
            if kernel != "k2":
                continue
            base = os.path.join(tmp, label)
            BVGraph.store(make(), base, **kw)
            profile(BVGraph.load(base), label, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
