"""The throughput of the in-kernel decoder's hot primitives: the
counterpart of the JAX package's ``scripts/pallas_perf_probe.py``
(``probes/loops.py`` has the kernels, ``csrc/loops.cu``):

* F ``probe_vpu`` (``:207``): 16 rounds of four int32 operations a trip
  (``probe_lane_loop``);
* A512-A32768 ``probe_replicated`` (``:61``): the whole (8, W) take-along
  a trip, row r at ``(w + carry[r][0]) % W`` (``probe_gather_loop``);
* B64, B288, B576 ``probe_onehot`` (``:89``): a lane's (R, 128) table row
  by four int8 byte-plane products, ``carry = (carry + row[0]) % R``
  (``probe_plane_refill``);
* C128, C320 ``probe_ownrow`` (``:128``): the whole (1024, T) take-along a
  trip, each lane's own row (``probe_gather_loop``);
* D512 ``probe_rowstore`` (``:157``): the carry stored to slab row
  ``t % 512`` a trip (``probe_lane_loop``);
* E128, E512 ``probe_transpose`` (``:184``): (T, 1024) -> (1024, T) plus
  ``carry[0][0]``, 64 reps (``probe_transpose_loop``).

Each probe draws its input from its own ``default_rng`` (0-5), as the
script's do.

    python -m webgraph_tpu_torch.probes.perf [--device cpu]

runs ``TRIPS`` trips (B a sixteenth, E 64 reps) on the chip and on the CPU
alike, as the script does.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.probes import loops as L

TRIPS = 2048
E_REPS = 64
A_WIDTHS = (512, 2048, 8192, 32768)
B_ROWS = (64, 288, 576)
C_COLS = (128, 320)
D_SLAB = 512
E_ROWS = (128, 512)
RUNS = ("F",) + tuple(f"A{w}" for w in A_WIDTHS) + tuple(f"B{r}" for r in B_ROWS) \
    + tuple(f"C{t}" for t in C_COLS) + (f"D{D_SLAB}",) + tuple(f"E{t}" for t in E_ROWS)


def inputs():
    """Every run's numpy inputs: the script's table or tile from its seed,
    and the carry it starts from where the script builds one."""
    def ints(seed, shape):
        return np.random.default_rng(seed).integers(1, 97, size=shape).astype(np.int32)

    col = np.broadcast_to(np.arange(128, dtype=np.int32), (8, 128))
    out = {"F": (ints(5, (8, 128)),)}
    for w in A_WIDTHS:
        out[f"A{w}"] = (np.broadcast_to(ints(0, (1, w)), (8, w)).copy(), col * 37)
    for r in B_ROWS:
        out[f"B{r}"] = (ints(1, (r, 128)), col % r)
    for t in C_COLS:
        out[f"C{t}"] = (ints(2, (1024, t)),
                        (np.arange(1024, dtype=np.int32) % t).reshape(8, 128))
    out[f"D{D_SLAB}"] = (ints(3, (8, 128)),)
    for t in E_ROWS:
        out[f"E{t}"] = (ints(4, (t, 1024)),)
    return out


def probes(interpret: bool = False):
    """The 15 runs as :class:`loops.Probe` s (the script runs the same
    counts in interpret mode)."""
    ins = inputs()
    out = [L.Probe("F", L.lane_loop, ins["F"], {"flags": L.LL_VPU, "rounds": 16},
                   TRIPS, "trip")]
    out += [L.Probe(f"A{w}", L.gather_loop, ins[f"A{w}"], {"mode": L.GL_REPL},
                    TRIPS, "trip") for w in A_WIDTHS]
    out += [L.Probe(f"B{r}", L.plane_refill, ins[f"B{r}"], {"mode": L.PR_ROWS},
                    TRIPS // 16, "rowgather") for r in B_ROWS]
    out += [L.Probe(f"C{t}", L.gather_loop, ins[f"C{t}"], {"mode": L.GL_OWN},
                    TRIPS, "trip") for t in C_COLS]
    out.append(L.Probe(f"D{D_SLAB}", L.lane_loop, ins[f"D{D_SLAB}"],
                       {"flags": L.LL_ROWSTORE | L.LL_OUT_SLAB, "rounds": 0,
                        "slab": D_SLAB}, TRIPS, "store"))
    out += [L.Probe(f"E{t}", L.transpose_loop, ins[f"E{t}"], {"addc": L.TL_ADDC},
                    E_REPS, "transpose") for t in E_ROWS]
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
