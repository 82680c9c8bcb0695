"""Operation kind ``encode``: the port's encoder on the device,
``formats.bvgraph_encode.encode_device(offsets, succ, settings)``, back to
back: a CSR on the device in, the ``.graph`` and ``.offsets`` bytes on the
host out.

Set-up uploads the generator's CSR to the device once.  A call's work is
the graph's m arcs.  The check, once the window has closed: each checked
call's bytes and bit counts equal those of the benchmark's frozen encoder
under the configuration's store parameters.
"""

from __future__ import annotations

from benchmark import work
from benchmark.reference import compare, encoder


def settings(ctx):
    """The port's settings object for the configuration's store entry."""
    from webgraph_tpu_torch.formats.bvgraph import BVGraphSettings

    st = ctx.config["store"]
    return BVGraphSettings(
        window_size=int(st["window_size"]),
        max_ref_count=int(st["max_ref_count"]),
        min_interval_length=int(st["min_interval_length"]),
        zeta_k=int(st["zeta_k"]), codings=encoder.codings(st))


def setup(ctx):
    import torch

    with ctx.mark("upload"):
        off = torch.from_numpy(ctx.offsets).to(ctx.device)
        succ = torch.from_numpy(ctx.succ).to(ctx.device)
    return {"off": off, "succ": succ, "settings": settings(ctx),
            "m": int(ctx.offsets[-1]), "ref": None}


def step(ctx, state, i):
    from webgraph_tpu_torch.formats import bvgraph_encode as E

    gb, gbits, ob, obits, _ = E.encode_device(state["off"], state["succ"],
                                              state["settings"],
                                              device=ctx.device)
    return (gb, gbits, ob, obits), state["m"]


def warmup(ctx, state):
    for i in range(int(ctx.mix.get("warmup_calls", 1))):
        step(ctx, state, i)


def poison_sizes(ctx, state):
    return []


def counters():
    from webgraph_tpu_torch.formats.bvgraph_encode import encode_device
    from webgraph_tpu_torch.kernels import encode as K

    return {"encode_device.reads": encode_device.reads,
            "enc_costs.launches": K.enc_costs.launches,
            "enc_select.launches": K.enc_select.launches,
            "enc_emit.launches": K.enc_emit.launches}


def reference(ctx, state):
    """The frozen encoder's output, made once, after the window."""
    if state["ref"] is None:
        state["ref"] = encoder.encode(ctx.offsets, ctx.succ,
                                      ctx.config["store"])
    return state["ref"]


def check(ctx, state, kept):
    """``bytes_mismatch``: the most bytes (and bits of the two bit counts)
    of one checked call's output that differ from the frozen encoder's."""
    ref = reference(ctx, state)
    worst = 0
    for out in kept.values():
        worst = max(worst, compare.bytes_mismatch(out, ref))
    return {"bytes_mismatch": (worst, 0)}


def least_s(ctx, state):
    gb, _, ob, _ = reference(ctx, state)
    n, m = ctx.offsets.size - 1, state["m"]
    return work.least_s(*work.encode_work(n, m, len(gb), len(ob)))


def control(ctx, state, i):
    """The reference in the program's place with one guarantee broken:
    the frozen encoder with a window one shorter than the configuration
    states (valid BVGraph bytes, but not the configuration's)."""
    st = dict(ctx.config["store"])
    st["window_size"] = int(st["window_size"]) - 1
    return encoder.encode(ctx.offsets, ctx.succ, st)
