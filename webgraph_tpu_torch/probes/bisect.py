"""The bisection of Mosaic's compile failures in gathers, int8 products and
transposes: the counterpart of the JAX package's
``scripts/pallas_bisect_probe.py`` (``probes/forms.py`` has the kernels,
``csrc/forms.cu``).  Its twenty runs, in ``main()``'s order (``:130``),
each a single call:

* g8, g1024, g8192 ``g_n128`` (``:44``): axis-1 gathers of (N, 128) at
  (N, 128); w8x256, w8x512, w1024x256 ``g_wide`` (``:53``): (N, W) at
  full-width indices; axis0 ``g_axis0`` (``:62``): (256, 128) along axis 0
  (``probe_form_gather``);
* i8_256x64, i8_1024x256, i8_1024x288, f32, bf16 ``dot_var`` (``:72``):
  int8 products to int32 and (1024, 256) x (256, 128) in float32 and bf16
  to float32 (``probe_form_dot``);
* onehot ``dot_onehot_inkernel`` (``:86``): an int8 one-hot (1024, 256)
  built in the kernel times an int8 pool (256, 128) (``probe_form_onehot``);
* tr128x128, tr128x1024, tr512x1024 ``tr`` (``:105``); r1024x1, r1x1024,
  r1024x128 ``rshp`` (``:113``); bcast ``bcast`` (``:121``), (1, 4096) ->
  (8, 4096) (``probe_form_relayout``).

Every input is drawn from one ``default_rng(0)`` (``:40``) in the order
``main()`` draws them, so run k gets the script's arrays only when all the
runs are drawn in that order (:func:`inputs`).

    python -m webgraph_tpu_torch.probes.bisect [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.probes import forms as F

# (name, kind, arguments) in main()'s order
SPEC = (("g8", "g_n128", (8,)), ("g1024", "g_n128", (1024,)),
        ("g8192", "g_n128", (8192,)), ("w8x256", "g_wide", (8, 256)),
        ("w8x512", "g_wide", (8, 512)), ("w1024x256", "g_wide", (1024, 256)),
        ("axis0", "g_axis0", (256,)),
        ("i8_256x64", "dot", (256, 64, 128, "i8")),
        ("i8_1024x256", "dot", (1024, 256, 128, "i8")),
        ("i8_1024x288", "dot", (1024, 288, 128, "i8")),
        ("f32", "dot", (1024, 256, 128, "f32")), ("bf16", "dot", (1024, 256, 128, "bf16")),
        ("onehot", "onehot", (1024, 256)),
        ("tr128x128", "tr", (128, 128)), ("tr128x1024", "tr", (128, 1024)),
        ("tr512x1024", "tr", (512, 1024)),
        ("r1024x1", "rshp", ((8, 128), (1024, 1))), ("r1x1024", "rshp", ((8, 128), (1, 1024))),
        ("r1024x128", "rshp", ((128, 1024), (1024, 128))),
        ("bcast", "bcast", (8, 4096)))
RUNS = tuple(name for name, _, _ in SPEC)
_DTYPES = {"i8": np.int8, "f32": np.float32, "bf16": np.float32}  # bf16 cast from float32


def inputs():
    """Every run's numpy inputs (in the order of its ``pallas_call``'s
    operands), drawn from one ``default_rng(0)`` in ``main()``'s order; the
    bf16 operands as float32 (their values, small integers, are exact in
    both)."""
    rng = np.random.default_rng(0)

    def ints(lo, hi, shape, dtype=np.int32):
        return rng.integers(lo, hi, size=shape).astype(dtype)

    out = {}
    for name, kind, a in SPEC:
        if kind == "g_n128":
            out[name] = (ints(0, 99, (a[0], 128)), ints(0, 128, (a[0], 128)))
        elif kind == "g_wide":
            out[name] = (ints(0, 99, a), ints(0, a[1], a))
        elif kind == "g_axis0":
            out[name] = (ints(0, 99, (a[0], 128)), ints(0, a[0], (a[0], 128)))
        elif kind == "dot":
            m, k, n, dt = a
            out[name] = (ints(-5, 5, (m, k), _DTYPES[dt]), ints(-5, 5, (k, n), _DTYPES[dt]))
        elif kind == "onehot":
            m, r = a
            out[name] = (ints(0, r, (m // 128, 128)), ints(-100, 100, (r, 128), np.int8))
        elif kind == "tr":
            out[name] = (ints(0, 99, a),)
        elif kind == "rshp":
            out[name] = (ints(0, 99, a[0]),)
        else:
            out[name] = (ints(0, 99, (1, a[1])),)
    return out


def _expect(kind, a, ins):
    x = ins[0]
    if kind in ("g_n128", "g_wide"):
        return lambda out: np.array_equal(out, np.take_along_axis(x, ins[1], axis=1))
    if kind == "g_axis0":
        return lambda out: np.array_equal(out, np.take_along_axis(x, ins[1], axis=0))
    if kind == "dot":
        exp = x.astype(np.float64) @ ins[1].astype(np.float64)
        return lambda out: np.allclose(out.astype(np.float64), exp)
    if kind == "onehot":
        return lambda out: np.array_equal(out, ins[1].astype(np.int32)[x.reshape(-1)])
    if kind == "tr":
        return lambda out: np.array_equal(out, x.T)
    if kind == "rshp":
        return lambda out: np.array_equal(out, x.reshape(a[1]))
    return lambda out: np.array_equal(out, np.broadcast_to(x, a))


def forms():
    """The 20 runs as :class:`forms.Form` s, in ``main()``'s order."""
    ins = inputs()
    out = []
    for name, kind, a in SPEC:
        params, order, casts = {}, None, ()
        if kind in ("g_n128", "g_wide"):
            kernel, params = F.gather, {"axis": 1}
        elif kind == "g_axis0":
            kernel, params = F.gather, {"axis": 0}
        elif kind == "dot":
            kernel = F.dot
            casts = (torch.bfloat16,) * 2 if a[3] == "bf16" else ()
        elif kind == "onehot":
            kernel, order = F.onehot, (1, 0)
            params = {"rows": a[1], "mode": F.OH_GATHER_I8}
        elif kind == "tr":
            kernel, params = F.relayout, {"mode": F.RL_TRANSPOSE}
        else:
            shape = a[1] if kind == "rshp" else a
            kernel, params = F.relayout, {"mode": F.RL_COPY, "shape": shape}
        out.append(F.Form(name, kernel, ins[name], params, _expect(kind, a, ins[name]),
                          casts, order))
    return out


def run(device="cuda"):
    """Every run on ``device`` (:func:`forms.run_forms`)."""
    return F.run_forms(forms(), device)


def main(argv=None):
    import sys

    return F.main_for(sys.modules[__name__], argv)


if __name__ == "__main__":
    raise SystemExit(main())
