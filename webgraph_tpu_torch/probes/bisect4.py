"""The cost of an in-loop product, transpose and copy, and the compaction
frame's prefixes: the counterpart of the JAX package's
``scripts/pallas_bisect4.py`` (``probes/loops.py`` has the kernels,
``csrc/loops.cu``):

* M1, M2 ``matmul_inloop`` (``:38``) prebaked, (1024, 256) x (256, 128)
  and (256, 64) x (64, 128) int8; M3, M4 one-hot against b (288, 128) and
  (32, 128) (``probe_dot_loop``);
* T128, T512 ``transpose_inloop`` (``:69``): (T, 1024) -> (1024, T) a rep
  (``probe_transpose_loop``);
* DMA ``dma_inloop`` (``:87``): an (8, 1024) slice copied a rep
  (``probe_copy_loop``);
* Jv0-Jv4 ``j_frame`` (``:110``): 8 trips of the compaction frame's
  variants 0-4 (``probe_jframe`` stages v0-v4).

Every input is drawn from one ``default_rng(17)`` in the order ``main()``
(``:151``) draws them.

    python -m webgraph_tpu_torch.probes.bisect4 [--device cpu]

runs ``REPS`` loops on the chip and ``CPU_REPS`` on the CPU, as the script
cuts its own in interpret mode; the J frames always run 8 trips.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.probes import loops as L

REPS = 1 << 13      # the script's on-chip REPS
CPU_REPS = 1 << 9   # and its interpret-mode one
JFRAME_TRIPS = 8
RUNS = ("M1", "M2", "M3", "M4", "T128", "T512", "DMA",
        "Jv0", "Jv1", "Jv2", "Jv3", "Jv4")


def inputs():
    """Every run's numpy inputs, drawn as the script's ``main()`` draws
    them."""
    rng = np.random.default_rng(17)

    def ints(lo, hi, shape, dt=np.int32):
        return rng.integers(lo, hi, size=shape).astype(dt)

    out = {}
    for name, (m, k) in (("M1", (1024, 256)), ("M2", (256, 64)),
                         ("M3", (1024, 288)), ("M4", (1024, 32))):
        out[name] = (ints(-5, 5, (m, k), np.int8), ints(-5, 5, (k, 128), np.int8))
    for name, t in (("T128", 128), ("T512", 512), ("DMA", 512)):
        out[name] = (ints(0, 99, (t, 1024)),)
    for v in range(5):
        out[f"Jv{v}"] = (ints(1, 99, (8, 128)), ints(0, L.JR * 100, (8, 128)))
    return out


def probes(interpret: bool = False):
    """The twelve runs as :class:`loops.Probe` s."""
    ins = inputs()
    n = CPU_REPS if interpret else REPS
    out = [L.Probe(name, L.dot_loop, ins[name], {"onehot": name in ("M3", "M4")},
                   n, "iter") for name in ("M1", "M2", "M3", "M4")]
    out += [L.Probe(name, L.transpose_loop, ins[name], {"addc": L.TL_MASK}, n, "iter")
            for name in ("T128", "T512")]
    out.append(L.Probe("DMA", L.copy_loop, ins["DMA"], {}, n, "iter"))
    out += [L.Probe(f"Jv{v}", L.jframe, ins[f"Jv{v}"], {"stage": f"v{v}"},
                    JFRAME_TRIPS, "trip") for v in range(5)]
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
