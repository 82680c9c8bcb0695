"""The stored graph a cell reads: the generator's CSR written by the
benchmark's frozen encoder under the configuration's store parameters,
then loaded by the port's ``BVGraph.load``, as a user loads a graph."""

from __future__ import annotations

import os

from benchmark.reference import encoder


def stored_graph(ctx):
    """``(BVGraph, sizes)``: the loaded graph and the stored sizes
    (``nodes``, ``arcs``, ``graph_bytes``, ``offsets_bytes``)."""
    from webgraph_tpu_torch.formats.bvgraph import BVGraph

    base = os.path.join(ctx.tmp, "graph")
    with ctx.mark("store"):
        sizes = encoder.store(base, ctx.offsets, ctx.succ,
                              ctx.config["store"])
    with ctx.mark("load"):
        g = BVGraph.load(base)
    return g, sizes
