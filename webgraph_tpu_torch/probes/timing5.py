"""The in-loop primitives timed with the dispatch overhead subtracted: the
counterpart of the JAX package's ``scripts/pallas_timing5.py``, whose ten
runs each time one primitive in a ``fori_loop`` over an (8, 128) int32
carry (``probes/loops.py`` has the kernels, ``csrc/loops.cu``):

* T32, T128, TX ``trip_core`` (``:56``): 8 or 32 rounds of the ``(v, rv)``
  recurrence a trip; TX adds the relayout, the queue roll in columns < 512
  and the slab row store of ``v`` (``probe_lane_loop``);
* G1024, G8 ``gather_loop`` (``:99``): the whole (N, 128) take-along a trip
  (``probe_gather_loop``);
* M1 ``matmul_loop`` (``:125``) prebaked, (1024, 256) x (256, 128) int8;
  M2, M3 one-hot against b (32, 128) and (288, 128) (``probe_dot_loop``);
* TR ``transpose_loop`` (``:158``): (128, 1024) -> (1024, 128) a rep
  (``probe_transpose_loop``);
* DMA ``dma_loop`` (``:178``): an (8, 1024) slice copied a rep
  (``probe_copy_loop``).

Every input is drawn from one ``default_rng(23)`` in the order ``main()``
(``:202``) draws them.  T32 and T128 read slab row 0, which they never
write (ROADMAP C.10): the port's slab starts at ``loops.UNWRITTEN``.

    python -m webgraph_tpu_torch.probes.timing5 [--device cpu]

runs each at the script's loop count on the chip (``REPS``), or at its
interpret-mode count (``reps_for``) on the CPU.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.probes import loops as L

REPS = {"T32": 1 << 20, "T128": 1 << 19, "TX": 1 << 19, "G1024": 1 << 19,
        "G8": 1 << 20, "M1": 1 << 15, "M2": 1 << 15, "M3": 1 << 14,
        "TR": 1 << 15, "DMA": 1 << 16}
RUNS = tuple(REPS)
TX_FLAGS = L.LL_RESHAPE | L.LL_QUEUE_HALF | L.LL_STORE_V | L.LL_OUT_SLAB


def reps_for(n: int, interpret: bool) -> int:
    """The script's ``reps_for``: ``n`` on the chip, ``max(n >> 8, 64)`` in
    interpret mode."""
    return max(n >> 8, 64) if interpret else n


def inputs():
    """Every run's numpy inputs, drawn as the script's ``main()`` draws
    them."""
    rng = np.random.default_rng(23)

    def ints(lo, hi, shape, dt=np.int32):
        return rng.integers(lo, hi, size=shape).astype(dt)

    out = {name: (ints(1, 99, (8, 128)),) for name in ("T32", "T128", "TX")}
    for name, n in (("G1024", 1024), ("G8", 8)):
        out[name] = (ints(0, 99, (n, 128)),)
    for name, k in (("M1", 256), ("M2", 32), ("M3", 288)):
        out[name] = (ints(-5, 5, (1024, k), np.int8), ints(-5, 5, (k, 128), np.int8))
    out["TR"] = (ints(0, 99, (128, 1024)),)
    out["DMA"] = (ints(0, 99, (512, 1024)),)
    return out


def probes(interpret: bool = False):
    """The ten runs as :class:`loops.Probe` s, at the chip's loop counts or
    the interpret-mode ones."""
    ins = inputs()
    ones = np.ones((8, 128), np.int32)

    def mk(name, kernel, arrays, unit, **params):
        return L.Probe(name, kernel, arrays, params,
                       reps_for(REPS[name], interpret), unit)

    return [
        mk("T32", L.lane_loop, ins["T32"], "trip", flags=L.LL_OUT_SLAB, rounds=8),
        mk("T128", L.lane_loop, ins["T128"], "trip", flags=L.LL_OUT_SLAB, rounds=32),
        mk("TX", L.lane_loop, ins["TX"], "trip", flags=TX_FLAGS, rounds=8),
        mk("G1024", L.gather_loop, ins["G1024"] + (ones,), "trip", mode=L.GL_ROWS),
        mk("G8", L.gather_loop, ins["G8"] + (ones,), "trip", mode=L.GL_ROWS),
        mk("M1", L.dot_loop, ins["M1"], "iter", onehot=False),
        mk("M2", L.dot_loop, ins["M2"], "iter", onehot=True),
        mk("M3", L.dot_loop, ins["M3"], "iter", onehot=True),
        mk("TR", L.transpose_loop, ins["TR"], "iter", addc=L.TL_MASK),
        mk("DMA", L.copy_loop, ins["DMA"], "iter"),
    ]


def run(device="cuda", cut=None):
    """Every run on ``device`` at the chip's loop counts, but those ``cut``
    maps a run's name to (:func:`loops.run_probes`)."""
    return L.run_probes(probes(), device, cut=cut)


def main(argv=None):
    import sys

    return L.main_for(sys.modules[__name__], argv)


if __name__ == "__main__":
    raise SystemExit(main())
