"""The capability probe of the in-kernel decoder's building blocks: the
counterpart of the JAX package's ``scripts/pallas_caps_probe.py``
(``probes/forms.py`` has the kernels, ``csrc/forms.cu``).  Its twelve
probes, in ``main()``'s order (``:239``), each a single call:

* clz ``probe_clz`` (``:42``): the leading zeros of (8, 128) uint32 words,
  32 for 0 (``probe_form_scalar``);
* take_narrow ``probe_take_narrow`` (``:60``), take_wide
  ``probe_take_wide`` (``:263``): axis-1 gathers, (256, 128) at (256, 16)
  and (8, 4096) at (8, 128) (``probe_form_gather``);
* var_roll ``probe_var_roll`` (``:77``): each row of (256, 128) rotated
  left by its own shift through a 7-stage roll network (``probe_form_roll``);
* onehot_scatter ``probe_onehot_scatter`` (``:101``): 256 rows scattered
  into 64 through four int8 byte-plane one-hot products
  (``probe_form_onehot``);
* fori ``probe_fori`` (``:142``): 7 adds and a count, the store under
  ``count == 7`` (``probe_form_scalar``);
* dma ``probe_dma`` (``:169``), dma_flatten ``probe_dma_flatten``
  (``:280``), prefetch ``probe_prefetch`` (``:210``): copies at device-held
  offsets (``probe_form_copy``);
* transpose ``probe_transpose`` (``:304``), reshape ``probe_reshape``
  (``:339``): (128, 128)^T, (8, 128) -> (1024, 1) (``probe_form_relayout``);
* dot_dim0 ``probe_dot_dim0`` (``:319``): int8 (64, 128)^T x (64, 128) ->
  int32 (``probe_form_dot``).

Each probe draws from its own ``default_rng(k)``, as the script's do.
``probe_dma_flatten`` raises in interpret mode (ROADMAP C.11): it copies a
(16, 128) ref into a row of rank 1; the port copies the 2,048 words into row
0, as the script's check expects, and leaves rows 1-7 ``loops.UNWRITTEN``.
``probe_dma``'s output rows that no copy writes are INT32_MIN in interpret
mode (undefined on a TPU): ``loops.UNWRITTEN`` here.

    python -m webgraph_tpu_torch.probes.caps [--device cpu]
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.probes import forms as F

RUNS = ("clz", "take_narrow", "var_roll", "onehot_scatter", "fori", "dma",
        "prefetch", "take_wide", "dma_flatten", "transpose", "dot_dim0", "reshape")
SCATTER_ROWS = 64
DMA_START = 128


def _ints(seed, hi, shape):
    return np.random.default_rng(seed).integers(0, hi, size=shape).astype(np.int32)


def inputs():
    """Each probe's numpy inputs in the order of its ``pallas_call``'s
    operands, drawn from the probe's own seed."""
    ins = {"clz": (np.random.default_rng(0).integers(0, 2**32, size=(8, 128), dtype=np.uint64)
                   .astype(np.uint32).view(np.int32),)}
    rng = np.random.default_rng(1)
    ins["take_narrow"] = (rng.integers(0, 1 << 30, size=(256, 128)).astype(np.int32),
                          rng.integers(0, 128, size=(256, 16)).astype(np.int32))
    rng = np.random.default_rng(2)
    ins["var_roll"] = (rng.integers(0, 1 << 30, size=(256, 128)).astype(np.int32),
                       rng.integers(0, 128, size=(256, 1)).astype(np.int32))
    rng = np.random.default_rng(3)
    v = np.zeros((256, 128), np.int32)
    drow = np.zeros((256, 1), np.int32)
    for i in range(256):  # disjoint column blocks where rows collide
        drow[i, 0] = i % SCATTER_ROWS
        v[i, np.arange(32) + 32 * (i // SCATTER_ROWS)] = rng.integers(0, 1 << 31, size=32)
    ins["onehot_scatter"] = (v, drow)
    ins["fori"] = (np.ones((8, 128), np.int32),)
    ins["dma"] = (np.asarray([DMA_START], np.int32), _ints(4, 1 << 30, (4096, 128)))
    ins["prefetch"] = (np.asarray([0, 2, 5, 7], np.int32), _ints(5, 100, (64, 128)))
    rng = np.random.default_rng(8)
    ins["take_wide"] = (rng.integers(0, 1 << 30, size=(8, 4096)).astype(np.int32),
                        rng.integers(0, 4096, size=(8, 128)).astype(np.int32))
    ins["dma_flatten"] = (_ints(9, 1 << 30, (16, 128)),)
    ins["transpose"] = (_ints(10, 1 << 30, (128, 128)),)
    rng = np.random.default_rng(11)
    ins["dot_dim0"] = (rng.integers(-10, 10, size=(64, 128)).astype(np.int8),
                       rng.integers(-10, 10, size=(64, 128)).astype(np.int8))
    ins["reshape"] = (_ints(12, 1 << 30, (8, 128)),)
    return ins


def _expect(ins):
    """The script's check of each probe's output."""
    def clz(out):
        x = ins["clz"][0].view(np.uint32)
        exp = 32 - np.int32(np.floor(np.log2(np.maximum(x, 1)))) - 1
        return np.array_equal(out, np.where(x > 0, exp, 32))

    def scatter(out):
        v, drow = ins["onehot_scatter"]
        exp = np.zeros((SCATTER_ROWS, 128), np.int64)
        for i in range(len(v)):
            exp[drow[i, 0]] += v[i]
        return np.array_equal(out, (exp % (1 << 32)).astype(np.uint32).view(np.int32))

    def prefetch(out):
        srows, x = ins["prefetch"]
        return all(np.array_equal(out[8 * t:8 * t + 8], x[8 * s:8 * s + 8] + 1)
                   for t, s in enumerate(srows))

    def take(name):
        return lambda out: np.array_equal(out, np.take_along_axis(*ins[name], axis=1))

    a, b = ins["dot_dim0"]
    s, h = ins["dma"]
    return {
        "clz": clz, "take_narrow": take("take_narrow"),
        "var_roll": lambda out: np.array_equal(out, np.stack(
            [np.roll(r, -int(k[0])) for r, k in zip(*ins["var_roll"])])),
        "onehot_scatter": scatter,
        "fori": lambda o, c: int(c[0, 0]) == 7 and int(o[0, 0]) == 7,
        "dma": lambda out: np.array_equal(out[136:392], h[128:384] * 2),
        "prefetch": prefetch, "take_wide": take("take_wide"),
        "dma_flatten": lambda out: np.array_equal(out[0], ins["dma_flatten"][0].reshape(-1)),
        "transpose": lambda out: np.array_equal(out, ins["transpose"][0].T),
        "dot_dim0": lambda out: np.array_equal(out, a.astype(np.int32).T @ b.astype(np.int32)),
        "reshape": lambda out: np.array_equal(out.reshape(8, 128), ins["reshape"][0]),
    }


def forms():
    """The 12 probes as :class:`forms.Form` s, in ``main()``'s order."""
    ins = inputs()
    exp = _expect(ins)
    spec = {
        "clz": (F.scalar, {"mode": F.SC_CLZ}, None),
        "take_narrow": (F.gather, {"axis": 1}, None),
        "var_roll": (F.roll, {"mode": F.RO_NET}, None),
        "onehot_scatter": (F.onehot, {"rows": SCATTER_ROWS, "mode": F.OH_SCATTER}, None),
        "fori": (F.scalar, {"mode": F.SC_FORI, "trips": 7}, None),
        "dma": (F.copy, {"mode": F.CP_DMA}, (1, 0)),
        "prefetch": (F.copy, {"mode": F.CP_PREFETCH}, (1, 0)),
        "take_wide": (F.gather, {"axis": 1}, None),
        "dma_flatten": (F.copy, {"mode": F.CP_FLATTEN}, None),
        "transpose": (F.relayout, {"mode": F.RL_TRANSPOSE}, None),
        "dot_dim0": (F.dot, {"trans_a": True}, None),
        "reshape": (F.relayout, {"mode": F.RL_COPY, "shape": (1024, 1)}, None),
    }
    return [F.Form(name, spec[name][0], ins[name], spec[name][1], exp[name],
                   order=spec[name][2]) for name in RUNS]


def run(device="cuda"):
    """Every probe on ``device`` (:func:`forms.run_forms`)."""
    return F.run_forms(forms(), device)


def main(argv=None):
    import sys

    return F.main_for(sys.modules[__name__], argv)


if __name__ == "__main__":
    raise SystemExit(main())
