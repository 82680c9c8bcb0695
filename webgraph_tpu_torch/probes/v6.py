"""The lowering and cost of the streaming decoder's primitives: the
counterpart of the JAX package's ``scripts/v6_probe.py`` (kernels in
``csrc/forms.cu`` and ``csrc/loops.cu``):

* P1 ``probe_ta0`` (``:32``): ``take_along_axis`` on axis 0, (128, 1024) at
  (16, 1024) (``probe_form_gather``);
* P2 ``probe_t8`` (``:49``): (8, 1024)^T written into columns 24-31 of a
  zero (1024, 128) (``probe_form_relayout``);
* P3 ``probe_trip`` (``:71``): :data:`TRIPS` trips of 8 sub-steps a lane
  over 1,024 lanes, a 32-row queue (``probe_v6_trip``);
* P4 ``probe_fetch`` (``:140``): ``fn200``'s 20 calls of the one-hot stream
  fetch and 32-chunk slab gather (``probe_v6_fetch``, a launch a call).

The script's ``main()`` (``:190``) runs P3 and P4; P1 and P2 also reach
``pallas_call``.  Its inputs are fixed arrays (no seed); P3 and P4 run at
salt 0, the script's first call.

    python -m webgraph_tpu_torch.probes.v6 [--device cpu]

runs P3 at ``TRIPS`` on the chip and ``CPU_TRIPS`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.probes import forms as F
from webgraph_tpu_torch.probes import loops as L

TRIPS = 65536    # probe_trip's default ntrips
CPU_TRIPS = 64
CALLS = 20       # fn200's calls
FORMS = ("P1", "P2")
RUNS = FORMS + ("P3", "P4")


def inputs():
    """Each probe's numpy inputs in the order of its ``pallas_call``'s
    operands (P4's bf16 planes as float32 ones)."""
    col = np.arange(16, dtype=np.int32).reshape(16, 1) * 7 % 128
    salt = np.zeros(1, np.int32)
    return {
        "P1": (np.arange(128 * 1024, dtype=np.int32).reshape(128, 1024),
               np.tile(col, (1, 1024))),
        "P2": (np.arange(8 * 1024, dtype=np.int32).reshape(8, 1024),),
        "P3": (np.arange(L.V6_QD * 1024, dtype=np.int32).reshape(L.V6_QD, 8, 128), salt),
        "P4": (np.ones((L.V6_GROUPS, L.V6_ROWS, 128), np.float32),
               np.tile(np.arange(128, dtype=np.int32) % L.V6_ROWS, (L.V6_GROUPS, 1)),
               np.arange(1024 * 4096, dtype=np.int32).reshape(L.V6_SLAB) & 0xFFFF,
               (np.arange(1024 * 128, dtype=np.int32).reshape(1024, 128) * 37) % 4096,
               salt),
    }


def forms():
    """P1 and P2 as :class:`forms.Form` s, with the script's checks."""
    ins = inputs()
    x, idx = ins["P1"]
    t8 = np.zeros((1024, 128), np.int32)
    t8[:, 24:32] = ins["P2"][0].T
    return [F.Form("P1", F.gather, ins["P1"], {"axis": 0},
                   lambda o: np.array_equal(o, np.take_along_axis(x, idx, axis=0))),
            F.Form("P2", F.relayout, ins["P2"],
                   {"mode": F.RL_TRANSPOSE, "width": 128, "col": 24},
                   lambda o: np.array_equal(o, t8))]


def probes(interpret: bool = False):
    """P3 and P4 as :class:`loops.Probe` s (P3 at ``CPU_TRIPS`` with
    ``interpret``)."""
    ins = inputs()
    return [L.Probe("P3", L.v6_trip, ins["P3"], {}, CPU_TRIPS if interpret else TRIPS,
                    "trip"),
            L.Probe("P4", L.v6_fetch, ins["P4"], {}, CALLS, "call",
                    casts=(torch.bfloat16,))]


def run(device="cuda"):
    """Every probe on ``device``: the forms (:func:`forms.run_forms`), then
    the loops at the script's counts (:func:`loops.run_probes`)."""
    return {**F.run_forms(forms(), device), **L.run_probes(probes(), device)}


def main(argv=None):
    args = F.parser(__doc__).parse_args(argv)
    cpu = args.device == "cpu"
    print(f"device={args.device} reps={'interpret' if cpu else 'chip'}")
    res = F.run_forms(forms(), args.device)
    F.print_forms(res)
    for name, r in L.run_probes(probes(interpret=cpu), args.device).items():
        print(f"{name:14s} {r['kernel']:20s} {r['reps']:8d} reps: {L.cost(r)}  "
              f"checksum {r['checksum']}")
    return int(any(r["ok"] is False for r in res.values()))


if __name__ == "__main__":
    raise SystemExit(main())
