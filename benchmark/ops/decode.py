"""Operation kind ``decode``: the port's bulk decode of a stored graph into
a CSR on the device, ``formats.bvgraph.decode_prepared(prep)``, back to
back on the prepared graph.

Set-up stores the generator's graph with the benchmark's frozen encoder
under the configuration's store parameters, loads it with the port's
``BVGraph.load`` and prepares it (``formats.bvgraph.prepare``: the scan,
the route, the depth plan, the stream moved to the device).  A call's
work is the graph's m arcs.  The check: each checked call's CSR equals
the generator's, entry for entry.
"""

from __future__ import annotations

from benchmark import inputs, work
from benchmark.reference import compare


def setup(ctx):
    from webgraph_tpu_torch.formats import bvgraph as B

    g, sizes = inputs.stored_graph(ctx)
    with ctx.mark("prepare"):
        prep = B.prepare(g, ctx.device)
    return {"prep": prep, "sizes": sizes, "m": int(ctx.offsets[-1])}


def step(ctx, state, i):
    from webgraph_tpu_torch.formats import bvgraph as B

    return B.decode_prepared(state["prep"]), state["m"]


def warmup(ctx, state):
    for i in range(int(ctx.mix.get("warmup_calls", 2))):
        step(ctx, state, i)


def poison_sizes(ctx, state):
    """The successor buffers a call allocates: its output and the extras
    of the same size."""
    return [4 * state["m"]] * 2


def counters():
    from webgraph_tpu_torch.kernels import decode as K2
    from webgraph_tpu_torch.kernels import decode2 as D2

    return {**{f"decode_records.{k}": v
               for k, v in D2.decode_records.counts.items()},
            **{f"decode_levels.{k}": v
               for k, v in K2.decode_levels.counts.items()}}


def check(ctx, state, kept):
    """``csr_mismatch``: the most entries of one checked call's CSR that
    differ from the generator's."""
    worst = 0
    for off, succ in kept.values():
        worst = max(worst, compare.csr_mismatch(
            off.cpu().numpy(), succ.cpu().numpy(), ctx.offsets, ctx.succ))
    return {"csr_mismatch": (worst, 0)}


def least_s(ctx, state):
    s = state["sizes"]
    return work.least_s(*work.decode_work(s["nodes"], s["arcs"],
                                          s["graph_bytes"]))


def control(ctx, state, i):
    """The reference in the program's place with one guarantee broken:
    the generator's lists, each in decreasing order (the same arcs, not
    the sorted lists the format stores)."""
    import numpy as np
    import torch

    off, succ = ctx.offsets, ctx.succ
    node = np.repeat(np.arange(off.size - 1), np.diff(off))
    rev = succ[np.lexsort((-succ.astype(np.int64), node))]
    return torch.from_numpy(off.copy()), torch.from_numpy(rev)
