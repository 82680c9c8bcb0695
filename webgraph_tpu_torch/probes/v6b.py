"""The fetch body's primitives, each timed in a loop: the counterpart of the
JAX package's ``scripts/v6_probe2.py`` (``probes/loops.py`` has the kernel,
``csrc/loops.cu``'s ``probe_body_loop``).  ``run_loop`` (``:17``) runs a
body :data:`K` times over an (8, 128) carry from zeros, salt ``s[0, 0]``:

* A ``bodyA`` (``:72``): the (1024, 32) -> (32, 1024) transpose;
* B ``bodyB`` (``:79``), C ``bodyC`` (``:94``): a 128-word window of the
  (1024, 1152) stream through a 9-chunk select (B adds ``to_regs(32)``);
* D ``bodyD`` (``:108``): 32 rows of the transposed stream (1152, 1024) at
  one base; D2 ``bodyD2`` (``:118``): at per-lane bases;
* E ``bodyE`` (``:128``): ``place8`` into 256 columns by a 5-stage roll;
* F ``bodyF`` (``:143``): ``sel_row`` of 32 registers.

D2 fails on every platform (ROADMAP C.12): it reshapes ``acc[0:1, :]``
(1, 128) to (1, 1024).  The port runs the per-lane bases of its docstring,
from ``acc.reshape(1, 1024)``.  The inputs are the script's fixed arrays
(``words = arange % 997`` and its transpose) at salt 0, its first call.

    python -m webgraph_tpu_torch.probes.v6b [--device cpu]

runs ``K`` reps on the chip and ``CPU_K`` on the CPU.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.probes import loops as L

K = 512      # the script's in-kernel reps
CPU_K = 8
RUNS = L.BODIES


def inputs():
    """The stream, its transpose and the salt (zeros, the script's first)."""
    words = np.arange(1024 * L.LW, dtype=np.int32).reshape(1024, L.LW) % 997
    return words, words.T.copy(), np.zeros((8, 128), np.int32)


def probes(interpret: bool = False):
    """The 7 bodies as :class:`loops.Probe` s, in ``main()``'s order."""
    words, words_t, salt = inputs()
    reps = CPU_K if interpret else K
    return [L.Probe(b, L.body_loop, (words_t if b in ("D", "D2") else words, salt),
                    {"body": b}, reps, "rep") for b in RUNS]


def run(device="cuda"):
    """Every body on ``device`` at ``K`` reps (:func:`loops.run_probes`)."""
    return L.run_probes(probes(), device)


def main(argv=None):
    import sys

    return L.main_for(sys.modules[__name__], argv)


if __name__ == "__main__":
    raise SystemExit(main())
