"""Operation kind ``query``: batched random access, one
``kernels.query2.QueryPlanner.successors_batch(nodes)`` a call, from one
client in a closed loop (a library caller that waits for each answer).

Set-up stores and loads the graph as the decode does, builds the planner
on the device and draws a pool of ``pool`` batches of ``batch`` nodes,
uniform over the graph, from the seed; call i asks batch i modulo the
pool.  A call's work is its ``batch`` queried nodes.  The check: each
checked batch's rows and counts equal the generator's lists, zero-padded
to the batch's longest list.
"""

from __future__ import annotations

import numpy as np

from benchmark import inputs
from benchmark.reference import compare


def setup(ctx):
    from webgraph_tpu_torch.kernels.query2 import QueryPlanner

    g, sizes = inputs.stored_graph(ctx)
    with ctx.mark("planner"):
        planner = QueryPlanner(g, ctx.device)
    n, q = g.num_nodes(), int(ctx.mix["batch"])
    with ctx.mark("batches"):
        pool = ctx.rng(1).integers(0, n, size=(int(ctx.mix["pool"]), q))
        warm = ctx.rng(2).integers(
            0, n, size=(int(ctx.mix.get("warmup_calls", 16)), q))
    return {"planner": planner, "pool": pool, "warm": warm, "q": q,
            "m": int(ctx.offsets[-1])}


def step(ctx, state, i):
    pool = state["pool"]
    b = i % len(pool)
    out, counts = state["planner"].successors_batch(pool[b])
    return (b, out, counts), state["q"]


def warmup(ctx, state):
    for nodes in state["warm"]:
        state["planner"].successors_batch(nodes)


def poison_sizes(ctx, state):
    """The graph's m successor slots that a batch's decode writes."""
    return [4 * state["m"]] * 2


def counters():
    from webgraph_tpu_torch.kernels import decode2 as D2

    return {f"decode_records.{k}": v
            for k, v in D2.decode_records.counts.items()}


def check(ctx, state, kept):
    """``rows_mismatch``: queries of the checked batches whose row or count
    differs from the generator's."""
    bad = 0
    for b, out, counts in kept.values():
        ref_out, ref_counts = compare.rows(ctx.offsets, ctx.succ,
                                           state["pool"][b])
        bad += compare.rows_mismatch(out.cpu().numpy(), counts.cpu().numpy(),
                                     ref_out, ref_counts)
    return {"rows_mismatch": (bad, 0)}


def least_s(ctx, state):
    return None


def control(ctx, state, i):
    """The reference in the program's place with one guarantee broken:
    the generator's rows, padded past each list with its last successor
    instead of zeros."""
    import torch

    b = i % len(state["pool"])
    out, counts = compare.rows(ctx.offsets, ctx.succ, state["pool"][b])
    col = np.arange(out.shape[1])
    last = out[np.arange(out.shape[0]), np.maximum(counts - 1, 0)]
    out = np.where(col[None, :] < counts[:, None], out, last[:, None])
    return b, torch.from_numpy(out), torch.from_numpy(counts)
