"""The second bisection: in-kernel one-hot row gathers, a transpose inside a
loop, a dynamic roll along the rows: the counterpart of the JAX package's
``scripts/pallas_bisect2.py`` (``probes/forms.py`` has the kernels,
``csrc/forms.cu``).  Its eight runs, in ``main()``'s order (``:131``):

* oh_i8_256, oh_i8_576, oh_bf16_256 ``onehotT_gather`` (``:34``): the pool
  row of each of 1,024 lanes through a one-hot^T (R, 1024) contracted with
  the pool's four byte planes, int8 (sign-extended, masked to the byte) or
  bf16 (``probe_form_onehot``);
* tr_loop ``transpose_in_loop`` (``:72``): 4 trips of (128, 1024)^T,
  ``carry + tr[:8, :128] + t`` from zeros, no mask (``probe_transpose_loop``,
  :data:`loops.TL_NOMASK`);
* roll0 ``dyn_roll`` (``:84``): (512, 128) rolled along axis 0 by a
  device-held shift (``probe_form_roll``);
* gl1024, gl4096 ``gather_in_loop`` (``:93``): 4 trips over an (N, 128)
  table, every row at column ``carry[0, c] % 128``, ``carry = (carry +
  vals[:8, :128]) & 0xFFFF`` from ones; the script checks nothing
  (``probe_gather_loop``, :data:`loops.GL_COL`);
* scatter ``scatter_onehot`` (``:107``): bf16 values of 1,024 lanes summed
  into 256 rows in float32 through a one-hot^T product with ones,
  broadcast over 128 columns (``probe_form_onehot``).

Every input is drawn from one ``default_rng(7)`` (``:17``) in the order
``main()`` draws them (:func:`inputs`).

    python -m webgraph_tpu_torch.probes.bisect2 [--device cpu]
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.probes import forms as F
from webgraph_tpu_torch.probes import loops as L

RUNS = ("oh_i8_256", "oh_i8_576", "oh_bf16_256", "tr_loop", "roll0", "gl1024",
        "gl4096", "scatter")
ONEHOT = {"oh_i8_256": (256, F.OH_GATHER_PLANES), "oh_i8_576": (576, F.OH_GATHER_PLANES),
          "oh_bf16_256": (256, F.OH_GATHER_BF16)}
TRIPS = 4
ROLL = 5
SCATTER_ROWS = 256


def inputs():
    """Every run's numpy inputs (in the order of its ``pallas_call``'s
    operands), drawn from one ``default_rng(7)`` in ``main()``'s order."""
    rng = np.random.default_rng(7)

    def ints(hi, shape):
        return rng.integers(0, hi, size=shape).astype(np.int32)

    out = {}
    for name, (r, _) in ONEHOT.items():
        idx = ints(r, (8, 128))
        pool = rng.integers(0, 1 << 31, size=(r, 128)).astype(np.uint32).view(np.int32)
        out[name] = (idx, pool)
    out["tr_loop"] = (ints(99, (128, 1024)),)
    out["roll0"] = (ints(99, (512, 128)), np.asarray([ROLL], np.int32))
    out["gl1024"] = (ints(99, (1024, 128)),)
    out["gl4096"] = (ints(99, (4096, 128)),)
    out["scatter"] = (ints(SCATTER_ROWS, (8, 128)), ints(200, (8, 128)))
    return out


def forms():
    """The 8 runs as :class:`forms.Form` s, in ``main()``'s order."""
    ins = inputs()
    out = []
    for name, (r, mode) in ONEHOT.items():
        idx, pool = ins[name]
        out.append(F.Form(name, F.onehot, ins[name], {"rows": r, "mode": mode},
                          lambda o, idx=idx, pool=pool: np.array_equal(o, pool[idx.reshape(-1)]),
                          order=(1, 0)))
    x = ins["tr_loop"][0]
    out.append(F.Form("tr_loop", L.transpose_loop, ins["tr_loop"],
                      {"addc": L.TL_NOMASK, "reps": TRIPS},
                      lambda o, chk: np.array_equal(o, 4 * x.T[:8, :128] + 6)))
    xr = ins["roll0"][0]
    out.append(F.Form("roll0", F.roll, ins["roll0"], {"mode": F.RO_AXIS0},
                      lambda o: np.array_equal(o, np.roll(xr, ROLL, 0))))
    for name in ("gl1024", "gl4096"):
        out.append(F.Form(name, L.gather_loop, ins[name],
                          {"mode": L.GL_COL, "reps": TRIPS},
                          consts=(np.ones(L.TILE, np.int32),)))
    idx, val = ins["scatter"]
    exp = np.zeros(SCATTER_ROWS, np.int64)
    np.add.at(exp, idx.reshape(-1), val.reshape(-1))
    out.append(F.Form("scatter", F.onehot, ins["scatter"],
                      {"rows": SCATTER_ROWS, "mode": F.OH_SCATTER_SUM},
                      lambda o: np.array_equal(o[:, 0], exp), order=(1, 0)))
    return out


def run(device="cuda"):
    """Every run on ``device`` (:func:`forms.run_forms`)."""
    return F.run_forms(forms(), device)


def main(argv=None):
    import sys

    return F.main_for(sys.modules[__name__], argv)


if __name__ == "__main__":
    raise SystemExit(main())
