"""Where K2's time goes on the card: the parse, the resolve and the chain.

For each K2 cell of ``synth.CELLS`` (the web-like graph of cnr-2000's
size stored with unbounded maxref, and config 3's deep-chain graph at
minint 2) this times the whole decode (``timing.cuda_ms``, median of 5
after a warm-up), then traces 5 more decodes with ``torch.profiler`` and
reads the device time of each kernel (``timing.kernel_runs``).  It prints
one JSON line per cell: ``k2_parse`` and ``k2_resolve`` ms (medians), the
device's busy share from the start of ``k2_parse`` to the end of
``k2_resolve`` (the rest is the gap between them), ``k2_resolve``'s time
over the links of the longest chain (max depth), an upper bound of the time
a link takes, and the longest record's bits and arcs.

    python3 -m webgraph_tpu_torch.profile_k2
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

from webgraph_tpu_torch.timing import cuda_ms, kernel_runs


def profile(bv, label, card):
    import numpy as np

    from webgraph_tpu_torch.kernels import decode as K2

    prep = K2.prepare(bv, "cuda")
    K2.decode_prepared(prep)
    whole = cuda_ms(lambda: K2.decode_prepared(prep), 5)
    runs = kernel_runs(lambda: K2.decode_prepared(prep), 5,
                       ("k2_parse", "k2_resolve"))
    parse = [(r["k2_parse"][1] - r["k2_parse"][0]) / 1e3 for r in runs]
    resolve = [(r["k2_resolve"][1] - r["k2_resolve"][0]) / 1e3 for r in runs]
    span = [(r["k2_resolve"][1] - r["k2_parse"][0]) / 1e3 for r in runs]
    busy = [(p + q) / s for p, q, s in zip(parse, resolve, span)]
    links = len(prep.bounds) - 2
    bits = (prep.bo[1:] - prep.bo[:-1]).cpu().numpy()
    longest = int(bits.argmax())
    arcs = (prep.offsets[1:] - prep.offsets[:-1]).cpu().numpy()
    n, m = prep.order.numel(), prep.m
    res_ms = statistics.median(resolve)
    out = {
        "cell": label, "card": card, "n": n, "m": m,
        "levels": len(prep.bounds) - 1, "depth0_nodes": int(prep.bounds[1]),
        "decode_ms": whole, "k2_parse_ms": statistics.median(parse),
        "k2_resolve_ms": res_ms, "span_ms": statistics.median(span),
        "busy_share": statistics.median(busy), "traced_decodes": len(runs),
        "chain_links": links,
        "resolve_us_per_link": res_ms / max(links, 1) * 1e3,
        "largest_level": int(np.diff(prep.bounds).max()),
        "longest_record_bits": int(bits[longest]),
        "longest_record_arcs": int(arcs[longest]),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_k2: no CUDA device", file=sys.stderr)
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
