"""Times the device analytics on the card: BFS from 6 sources, 4 NF and 2
geometric batches on the web-like graph of cnr-2000's size (seed 0), and
SumSweep on the symmetrized 20,000-node and the directed 8,000-node
web-like graphs: ``chip_smoke.py``'s analytics operations, without its
checks.  For each: CUDA-event ms (median of 3 after one counted run; the
directed SumSweep its counted run only), ``or_pull`` launches, host
reads, the median ``or_pull`` launch's device ms and the busy share
(device time in a ``torch.profiler`` trace over that ms).

    python3 webgraph_tpu_torch/tools/analytics_times.py [CHECKOUT]

``CHECKOUT`` (default: the checkout holding this file) names the checkout
whose ``webgraph_tpu_torch`` is timed, so that two commits compare on one
card (the checkout's ``webgraph_tpu_torch/timing.py`` must have
``trace_busy``).  Prints the card's name and power limit, then one JSON
line.  Needs a CUDA device; the graphs are built on the host."""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SOURCES = 6  # BFS sources, from XoRoShiRo128PlusRandom(0)
NF_BATCHES = 4
GEO_BATCHES = 2
SUMSWEEP_NODES = 20_000
SUMSWEEP_DIRECTED_NODES = 8_000


def main(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from webgraph_tpu_torch.algo import device as A
    from webgraph_tpu_torch.algo.sumsweep import (
        OutputLevel, SumSweepDirectedDiameterRadius)
    from webgraph_tpu_torch.kernels import propagate as P
    from webgraph_tpu_torch.synth import weblike_graph
    from webgraph_tpu_torch.timing import cuda_ms, trace_busy
    from webgraph_tpu_torch.transform import transform as T
    from webgraph_tpu_torch.utils.rng import XoRoShiRo128PlusRandom

    if not A.__file__.startswith(os.path.join(root, "")):
        raise SystemExit(f"analytics_times: imported {A.__file__}, "
                         f"not the checkout {root}")
    g = weblike_graph()
    off, succ = g.to_csr()
    n = g.num_nodes()
    csr = A.DeviceCSR(off, succ, n, "cuda")
    rng = XoRoShiRo128PlusRandom(0)
    sources = [rng.next_int(n) for _ in range(SOURCES)]
    g20 = T.symmetrize(weblike_graph(SUMSWEEP_NODES))
    gdir = weblike_graph(SUMSWEEP_DIRECTED_NODES)

    def sumsweep(gg):
        s = SumSweepDirectedDiameterRadius(
            gg, OutputLevel.RADIUS_DIAMETER, use_device=True)
        s.compute()
        return [s.get_diameter(), s.get_radius(), s.iterations]

    ops = {f"bfs {s}": (lambda s=s: A.bfs_distances(csr, s))
           for s in sources}
    ops["nf"] = lambda: A.make_nf_batches(csr, n)(0, NF_BATCHES)
    ops["geometric"] = lambda: A.make_geometric_batches(
        csr, n, 0.5)(0, GEO_BATCHES)
    ops["sumsweep"] = lambda: sumsweep(g20)
    ops["sumsweep directed"] = lambda: sumsweep(gdir)
    out = {}
    for name, fn in ops.items():
        pulls, reads = P.or_pull.launches, sum(A.host_reads.values())
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        o = {"launches": P.or_pull.launches - pulls,
             "reads": sum(A.host_reads.values()) - reads,
             "first_ms": a.elapsed_time(b)}
        if name.startswith("sumsweep"):
            o["result"] = res
        if name == "sumsweep directed":  # some 10^4-10^5 launches: untraced
            o.update(ms=o["first_ms"], pull_ms=None, busy=None)
        else:
            o["ms"] = cuda_ms(fn, 3)
            busy, times = trace_busy(fn, "or_pull", o["launches"])
            o["pull_ms"] = statistics.median(times) if times else None
            o["busy"] = None if busy is None else busy / o["ms"]
        out[name] = o
    return out


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("analytics_times: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"checkout": root, "card": card, "ops": main(root)}))
