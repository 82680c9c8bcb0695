"""The port's single-shot capability forms (webgraph_tpu_torch/probes: caps,
bisect, bisect2 on the kernel families of probes/forms.py, csrc/forms.cu)
against the JAX package's ``scripts/pallas_caps_probe.py``,
``pallas_bisect_probe.py`` and ``pallas_bisect2.py``, on the CPU through
the kernels' plain versions.

Each script is loaded by path (``scripts/`` is not a package; no script is
edited) and its ``main()`` runs in interpret mode (``INTERPRET`` set on the
loaded copy) with a stand-in ``pl`` that records every ``pallas_call``'s
operands (as digests, and the small ones whole) and outputs.  For every run
the port's inputs equal the script's operands, its plain version gives the
script's outputs exactly, and the script's own check holds on them.

``probe_dma_flatten`` raises in interpret mode (ROADMAP C.11): the test
pins the failure and holds the port to the script's check.  ``probe_dma``'s
rows that no copy writes read INT32_MIN in interpret mode (undefined on a
TPU): the port's are ``loops.UNWRITTEN``.  Card twins (``gpu``) hold each
kernel to its plain version and skip without one."""

import contextlib
import hashlib
import io
import types

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from webgraph_tpu_torch.probes import bisect as BI
from webgraph_tpu_torch.probes import bisect2 as B2
from webgraph_tpu_torch.probes import caps as CA
from webgraph_tpu_torch.probes import forms as F
from webgraph_tpu_torch.probes import loops as L
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)
from test_torch_probes import cuda, script  # noqa: F401  (fixture)

MODULES = {"caps": CA, "bisect": BI, "bisect2": B2}
SCRIPTS = {"caps": "pallas_caps_probe", "bisect": "pallas_bisect_probe",
           "bisect2": "pallas_bisect2"}
SMALL = 1024  # operands of at most this many elements are recorded whole


def _norm(a):
    """bf16 as float32 (the port keeps bf16 operands as float32 numpy
    arrays), uint32 as int32 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def digest(a):
    a = np.ascontiguousarray(_norm(a))
    return a.shape, a.dtype.str, hashlib.sha256(a.tobytes()).hexdigest()


class RecordingPallas(types.ModuleType):
    """``jax.experimental.pallas`` whose ``pallas_call`` results are also
    appended to ``sink`` when the call runs: ``(operands, outputs)``, each
    operand as ``(digest, array or None)``, the outputs as numpy arrays.
    With ``interpret`` every call runs in interpret mode (the v6 scripts set
    no ``interpret=``)."""

    def __init__(self, sink, interpret=False):
        super().__init__(pl.__name__)
        self._sink = sink
        self._interpret = interpret

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *args, **kwargs):
        if self._interpret:
            kwargs["interpret"] = True
        fn = pl.pallas_call(*args, **kwargs)

        def call(*operands):
            out = fn(*operands)
            n = len(operands)

            def record(*xs):
                ops = [(digest(x), _norm(x) if np.size(x) <= SMALL else None)
                       for x in xs[:n]]
                self._sink.append((ops, [_norm(x) for x in xs[n:]]))
            jax.debug.callback(record, *operands, *jax.tree.leaves(out))
            return out
        return call


def record_main(name, **settings):
    """The script's ``main()`` in interpret mode: its printed text and the
    records of its calls."""
    S = script(name)
    S.INTERPRET = True
    for k, v in settings.items():
        setattr(S, k, v)
    sink = []
    S.pl = RecordingPallas(sink)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        S.main()
    jax.effects_barrier()
    return text.getvalue(), sink


def held(record, form_or_probe, got):
    """The port's inputs equal the recorded operands, and its outputs the
    recorded outputs, exactly."""
    ops, outs = record
    assert [d for d, _ in ops] == [digest(a) for a in form_or_probe.arrays]
    assert len(got) >= len(outs)
    for g, w in zip(got, outs):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def runs():
    """Each module's runs: the script's records in interpret mode (the
    failing flatten has none) and the port's forms, computed once."""
    cache = {}

    def get(mod):
        if mod not in cache:
            text, sink = record_main(SCRIPTS[mod])
            forms = [f for f in MODULES[mod].forms() if f.name != "dma_flatten"]
            assert len(sink) == len(forms), text
            cache[mod] = text, dict(zip([f.name for f in forms], sink))
        return cache[mod]
    return get


def _forms(mod):
    return {f.name: f for f in MODULES[mod].forms()}


def _check(runs, mod, name):
    _, records = runs(mod)
    form = _forms(mod)[name]
    got = form.call(form.tensors("cpu"), plain=True)
    held(records[name], form, got)
    assert form.expect is None or form.expect(*[g.numpy() for g in got])


@pytest.mark.parametrize("name", [n for n in CA.RUNS if n != "dma_flatten"])
def test_caps_form_matches_interpret(name, runs):
    _check(runs, "caps", name)


@pytest.mark.parametrize("name", BI.RUNS)
def test_bisect_form_matches_interpret(name, runs):
    _check(runs, "bisect", name)


@pytest.mark.parametrize("name", B2.RUNS)
def test_bisect2_form_matches_interpret(name, runs):
    _check(runs, "bisect2", name)


@pytest.mark.parametrize("mod", sorted(SCRIPTS))
def test_script_reports_every_form(mod, runs):
    """bisect and bisect2 print ``[ok]`` for every run; caps 11 of its 12,
    the flatten failing (C.11)."""
    text, _ = runs(mod)
    n = len(MODULES[mod].RUNS)
    fails = 1 if mod == "caps" else 0
    assert text.count("[ok]") == n - fails and text.count("[FAIL]") == fails, text


def test_dma_flatten_fails_in_interpret_mode_the_port_copies_row_0(runs):
    """C.11: ``make_async_copy(x_ref, flat.at[0])`` copies a (16, 128) ref
    into a (2048,) row, and interpret mode refuses the ranks; the port
    copies the words in order into row 0, the script's check holds, and
    rows 1-7 stay UNWRITTEN."""
    text, _ = runs("caps")
    assert ("[FAIL] DMA flatten VMEM->VMEM: TypeError: dynamic_update_slice update "
            "must have the same rank as operand") in text
    form = _forms("caps")["dma_flatten"]
    (out,) = form.call(form.tensors("cpu"), plain=True)
    assert out.shape == (8, 2048)
    assert form.expect(out.numpy())
    assert (out[1:] == L.UNWRITTEN).all()


def test_dma_rows_no_copy_writes_are_int32_min(runs):
    """The output rows outside 136..391 are never written: INT32_MIN in
    interpret mode (undefined on a TPU), UNWRITTEN in the port."""
    _, records = runs("caps")
    want = records["dma"][1][0]
    outside = np.r_[0:136, 392:4096]
    assert (want[outside] == np.iinfo(np.int32).min).all()
    form = _forms("caps")["dma"]
    (got,) = form.call(form.tensors("cpu"), plain=True)
    assert (got.numpy()[outside] == L.UNWRITTEN).all()


def test_scatter_is_the_plane_form_not_the_int32_sum():
    """caps' one-hot scatter masks each byte plane's sum: where two rows
    write one word it differs from the int32 sum (the script's inputs never
    do)."""
    v = torch.tensor([[0x01FF] * 128, [0x0001] * 128], dtype=torch.int32)
    rows = torch.zeros((2, 1), dtype=torch.int32)
    (out,) = F.onehot_plain(v, rows, 1, F.OH_SCATTER)
    assert int(out[0, 0]) == 0x0100  # byte 0's sum 0x100 masked to 0, its carry lost
    assert int(v.long().sum(0)[0]) == 0x0200


def test_take_fills_like_take_along_axis():
    """An index below 0 counts from the end, one outside gives INT32_MIN,
    as ``jnp.take_along_axis``."""
    tbl = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    idx = torch.tensor([[-1, 5], [3, -5]], dtype=torch.int32)
    (out,) = F.gather_plain(tbl, idx, axis=1)
    want = jax.numpy.take_along_axis(jax.numpy.asarray(tbl.numpy()),
                                     jax.numpy.asarray(idx.numpy()), axis=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# entry points, wrappers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_on_the_cpu(name, capsys):
    assert MODULES[name].main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("not timed (cpu)") == len(MODULES[name].RUNS)
    assert "WRONG" not in out


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_needs_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MODULES[name].main([])


def _wrapper_calls(dev, bad=False):
    """Each wrapper on zeros on ``dev``; with ``bad`` its first tensor has
    the wrong dtype."""
    def t(*shape, dt=torch.int32, wrong=torch.int64):
        return torch.zeros(shape, dtype=wrong if bad else dt, device=dev)

    i8 = dict(dt=torch.int8, wrong=torch.int16)
    return {
        "gather": lambda: F.gather(t(8, 128), t(8, 16, dt=torch.int32, wrong=torch.int32)),
        "relayout": lambda: F.relayout(t(8, 128), F.RL_TRANSPOSE),
        "roll": lambda: F.roll(t(16, 128), t(16, 1, wrong=torch.int32), F.RO_NET),
        "dot": lambda: F.dot(t(64, 32, **i8), t(32, 128, **i8)),
        "onehot": lambda: F.onehot(t(16, 128), t(16, 1, wrong=torch.int32), 4, F.OH_SCATTER),
        "copy": lambda: F.copy(t(16, 128), mode=F.CP_FLATTEN),
        "scalar": lambda: F.scalar(t(8, 128), F.SC_CLZ),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_wrapper_raises_off_the_card(name):
    """A tensor neither on the CPU nor on a CUDA device is refused, not
    taken by the plain version."""
    with pytest.raises(ValueError):
        _wrapper_calls("meta")[name]()


@pytest.mark.parametrize("call", [
    lambda t: F.gather(t(8, 128), t(4, 16), axis=1),
    lambda t: L.gather_loop(t(12, 128), t(8, 128), L.GL_COL, reps=2),
    lambda t: L.transpose_loop(t(128, 1024), 3, reps=2),
    lambda t: F.relayout(t(8, 128), F.RL_COPY, shape=(3, 100)),
    lambda t: F.relayout(t(8, 128), F.RL_TRANSPOSE, width=16, col=12),
    lambda t: F.roll(t(16, 100), t(16, 1), F.RO_NET),
    lambda t: F.dot(t(48, 32, dt=torch.int8), t(32, 128, dt=torch.int8)),
    lambda t: F.onehot(t(16, 128), t(16, 1), 4, 9),
    lambda t: F.copy(t(16, 128), t(1), F.CP_FLATTEN),
    lambda t: F.scalar(t(8, 128), 5)],
    ids=["gather_rows", "gather_loop_col_rows", "transpose_loop_mode", "copy_size", "transpose_width", "roll_width",
         "dot_rows", "onehot_mode", "flatten_offs", "scalar_mode"])
def test_wrapper_refuses_what_its_kernel_cannot_take(call):
    def t(*shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device="meta")
    with pytest.raises(ValueError):
        call(t)


def test_wrappers_launch_nothing_for_cpu_tensors():
    wrappers = list(F.KERNELS.values())
    before = [w.launches for w in wrappers]
    for call in _wrapper_calls("cpu").values():
        call()
    assert [w.launches for w in wrappers] == before


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


def _all_forms():
    return [(mod, f.name) for mod, m in sorted(MODULES.items()) for f in m.forms()]


@pytest.mark.gpu
@pytest.mark.parametrize("mod,name", _all_forms())
def test_kernel_matches_plain_on_the_card(mod, name, cuda):
    form = _forms(mod)[name]
    args = form.tensors(cuda)
    got = form.call(args)
    want = form.call(args, plain=True)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert form.expect is None or form.expect(*[g.cpu().numpy() for g in got])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_wrapper_raises_on_a_wrong_dtype(name, cuda):
    with pytest.raises(ValueError):
        _wrapper_calls(cuda, bad=True)[name]()


@pytest.mark.gpu
def test_forms_off_the_scripts_inputs_on_the_card(cuda):
    """Indices outside the tables, shifts past the width, offsets past the
    arrays, colliding scatter rows: kernel and plain version agree."""
    g = torch.Generator().manual_seed(3)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    cases = [
        (F.gather, (ints(-9, 9, 16, 8), ints(-12, 12, 16, 5)), {"axis": 1}),
        (F.gather, (ints(-9, 9, 16, 8), ints(-20, 20, 3, 8)), {"axis": 0}),
        (F.roll, (ints(-99, 99, 32, 64), ints(-300, 300, 32, 1)), {"mode": F.RO_NET}),
        (F.roll, (ints(-99, 99, 40, 128), torch.tensor([-77], dtype=torch.int32)),
         {"mode": F.RO_AXIS0}),
        (F.onehot, (ints(-(1 << 30), 1 << 30, 64, 128), ints(-2, 10, 64, 1)),
         {"rows": 8, "mode": F.OH_SCATTER}),
        (F.onehot, (ints(-(1 << 30), 1 << 30, 8, 128), ints(-2, 10, 4, 32)),
         {"rows": 8, "mode": F.OH_GATHER_PLANES}),
        (F.onehot, (ints(0, 1 << 10, 8, 128), ints(-2, 10, 8, 128)),
         {"rows": 8, "mode": F.OH_SCATTER_SUM}),
        (F.copy, (ints(0, 99, 300, 128), torch.tensor([100], dtype=torch.int32)),
         {"mode": F.CP_DMA}),
        (F.copy, (ints(0, 99, 64, 128), torch.tensor([7, -1, 8, 3], dtype=torch.int32)),
         {"mode": F.CP_PREFETCH}),
        (F.scalar, (ints(-(1 << 31), (1 << 31) - 1, 3, 100),), {"mode": F.SC_FORI, "trips": 6}),
    ]
    for fn, args, params in cases:
        got = fn(*[a.to(cuda) for a in args], **params)
        want = F.PLAIN[fn](*args, **params)
        for x, y in zip(got, want, strict=True):
            assert torch.equal(x.cpu(), y), (fn.__name__, params)
