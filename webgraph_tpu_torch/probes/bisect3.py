"""Where the merge trip's time goes, refill variants, an in-loop row gather
and the slab compaction's parts: the counterpart of the JAX package's
``scripts/pallas_bisect3.py`` (``probes/loops.py`` has the kernels,
``csrc/loops.cu``):

* T0-T4 ``trip_variant`` (``:38``): 8 or 16 rounds of the ``(v, rv)``
  recurrence a trip, with the queue roll on odd trips (T1-T3), the slab
  row store of ``t`` (T2, T3) and the relayout (T3); U, U64
  ``trip_1x1024`` (``:82``): 8 or 16 rounds, no slab (``probe_lane_loop``);
* G8, G128, G1024 ``gather_inloop_timed`` (``:110``): the whole (N, 128)
  take-along a trip (``probe_gather_loop``);
* R1-R4 ``refill_variant`` (``:134``): the word refill from (P8, 32)
  pages, four int8 plane products (R1) or one batched on pages pre-split
  into byte planes, int8 (R2, R4) or bf16 (R3; it holds 0-255 exactly, so
  it equals R2), P8 256 or 64 (``probe_plane_refill``);
* S ``stack_select_refill`` (``:193``): a word of a 128-row column stack
  by a 16-way select and a 3-stage roll (``probe_stack_fetch``);
* J0-J3 ``j_part`` (``:232``): 64 reps of the compaction's first parts
  (``probe_jframe`` stages p0-p3).

Every input is drawn from one ``default_rng(13)`` in the order ``main()``
(``:283``) draws them.  T0, T1 and T4 read slab row 0, which they never
write (ROADMAP C.10): the port's slab starts at ``loops.UNWRITTEN``.

    python -m webgraph_tpu_torch.probes.bisect3 [--device cpu]

runs at ``TRIPS`` on the chip and ``CPU_TRIPS`` on the CPU (R at a
sixteenth, S at a quarter, J at 64 reps), as the script does.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.probes import loops as L

TRIPS = 1 << 17      # the script's on-chip TRIPS
CPU_TRIPS = 1 << 13  # and its interpret-mode one
J_REPS = 64
_Q = L.LL_QUEUE_ODD | L.LL_OUT_SLAB
# (rounds, flags) of the trip runs
TRIP_RUNS = {"T0": (8, L.LL_OUT_SLAB), "T1": (8, _Q),
             "T2": (8, _Q | L.LL_STORE_T),
             "T3": (8, _Q | L.LL_STORE_T | L.LL_RESHAPE),
             "T4": (16, L.LL_OUT_SLAB), "U": (8, 0), "U64": (16, 0)}
# (P8, batched) of the refill runs
REFILL_RUNS = {"R1": (256, False), "R2": (256, True), "R3": (256, True),
               "R4": (64, True)}
RUNS = tuple(TRIP_RUNS) + ("G8", "G128", "G1024") + tuple(REFILL_RUNS) \
    + ("S", "J0", "J1", "J2", "J3")


def split_planes(pages):
    """The script's batched layout (``:176-180``): columns 8 i .. 8 i + 7
    hold byte i of the first eight columns."""
    p = np.zeros_like(pages)
    for i, sh in enumerate((0, 8, 16, 24)):
        p[:, 8 * i:8 * (i + 1)] = (pages[:, :8] >> sh) & 0xFF
    return p


def inputs():
    """Every run's numpy inputs, drawn as the script's ``main()`` draws
    them."""
    rng = np.random.default_rng(13)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    out = {name: (ints(1, 99, (8, 128)),) for name in TRIP_RUNS}
    for n in (8, 128, 1024):
        out[f"G{n}"] = (ints(0, 99, (n, 128)),)
    for name, (p8, batched) in REFILL_RUNS.items():
        pages = ints(0, 99, (p8, 32))
        out[name] = (split_planes(pages) if batched else pages, ints(1, 99, (8, 128)))
    out["S"] = (ints(1, 99, (8, 128)),)
    for p in range(4):
        out[f"J{p}"] = (ints(1, 99, (8, 128)), ints(0, L.JR * 100, (8, 128)))
    return out


def probes(interpret: bool = False):
    """The 23 runs as :class:`loops.Probe` s."""
    ins = inputs()
    trips = CPU_TRIPS if interpret else TRIPS
    ones = np.ones((8, 128), np.int32)
    out = [L.Probe(name, L.lane_loop, ins[name], {"flags": f, "rounds": n},
                   trips, "trip") for name, (n, f) in TRIP_RUNS.items()]
    out += [L.Probe(f"G{n}", L.gather_loop, ins[f"G{n}"] + (ones,),
                    {"mode": L.GL_ROWS}, trips, "trip") for n in (8, 128, 1024)]
    out += [L.Probe(name, L.plane_refill, ins[name], {"mode": L.PR_REFILL},
                    trips // 16, "refill") for name in REFILL_RUNS]
    out.append(L.Probe("S", L.stack_fetch, ins["S"], {}, trips // 4, "fetch"))
    out += [L.Probe(f"J{p}", L.jframe, ins[f"J{p}"], {"stage": f"p{p}"}, J_REPS,
                    "slab") for p in range(4)]
    return out


def run(device="cuda", cut=None):
    """Every run on ``device`` at the chip's loop counts, but those ``cut``
    maps a run's name to (:func:`loops.run_probes`)."""
    return L.run_probes(probes(), device, cut=cut)


def main(argv=None):
    import sys

    return L.main_for(sys.modules[__name__], argv)


if __name__ == "__main__":
    raise SystemExit(main())
