"""The port's in-loop primitive probes (webgraph_tpu_torch/probes: timing5,
bisect4, bisect3, perf; kernels in csrc/loops.cu) against the JAX
package's ``scripts/pallas_timing5.py``, ``pallas_bisect4.py``,
``pallas_bisect3.py`` and ``pallas_perf_probe.py``, on the CPU through the
kernels' plain versions.

Each script is loaded by path (``scripts/`` is not a package; no script is
edited) and its ``main()`` runs every probe in interpret mode, at loop
counts set on the loaded copy (``reps_for``, ``REPS``, ``TRIPS``), with two
stand-ins: the copy's ``pl`` records every ``pallas_call``'s (8, 128)
output (a ``jax.debug.callback``, so the script's ``jax.jit`` stays), and
its ``timeit`` records each run's arguments and the script's own
``sum(out + salt)``.  For every probe the port's inputs equal the
script's arguments, and the port's plain version at the same loop count
gives the same output tile exactly, hence the same sum.

T0, T1, T4 (bisect3) and T32, T128 (timing5) read a slab row they never
write: interpret mode fills it with INT32_MIN, the TPU leaves it undefined
(ROADMAP C.10); the port's slab starts at INT32_MIN, and a test pins that
the output is the recurrence plus that fill.  Card twins (``gpu``) hold
each kernel to its plain version and skip without one."""

import contextlib
import io
import types

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from webgraph_tpu_torch.probes import bisect3 as B3
from webgraph_tpu_torch.probes import bisect4 as B4
from webgraph_tpu_torch.probes import loops as L
from webgraph_tpu_torch.probes import perf as PF
from webgraph_tpu_torch.probes import timing5 as T5
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)
from test_torch_probes import cuda, script  # noqa: F401  (fixture)

# loop counts of the interpret-mode runs (set on the loaded copies): timing5
# and bisect3 past 128 trips, so the slab row store wraps onto row 0
T5_REPS = 136
B4_REPS = 16
B3_TRIPS = 256
PF_TRIPS = 64
MODULES = {"timing5": T5, "bisect4": B4, "bisect3": B3, "perf": PF}


class _RecordingPallas(types.ModuleType):
    """``jax.experimental.pallas`` whose ``pallas_call`` results are also
    appended, as numpy arrays, to ``sink`` when the call runs."""

    def __init__(self, sink):
        super().__init__(pl.__name__)
        self._sink = sink

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *args, **kwargs):
        fn = pl.pallas_call(*args, **kwargs)

        def call(*operands):
            out = fn(*operands)
            jax.debug.callback(lambda o: self._sink.append(np.asarray(o)), out)
            return out
        return call


def _interpret_runs(name, settings, returns_pair):
    """The script's ``main()`` in interpret mode with ``settings`` set on
    its copy: ``{run: (args, checksum, out)}`` in ``main()``'s order."""
    S = script(name)
    S.INTERPRET = True
    for k, v in settings.items():
        setattr(S, k, v)
    outs, calls = [], []
    S.pl = _RecordingPallas(outs)

    def timeit(fn, *args):
        s = int(fn(*args))
        calls.append(([np.asarray(a) for a in args], s))
        return (1.0, s) if returns_pair else 1.0

    S.timeit = timeit
    with contextlib.redirect_stdout(io.StringIO()) as text:
        S.main()
    jax.effects_barrier()
    assert "FAIL" not in text.getvalue(), text.getvalue()
    assert len(outs) == len(calls)
    return [(a, s, o) for (a, s), o in zip(calls, outs)]


def _port_runs(module, patch):
    """The port's probes of ``module`` with ``patch`` set on it, each
    through its plain version at its loop count: ``{run: (probe, out)}``."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in patch.items():
            mp.setattr(module, k, v)
        probes = module.probes()
    return {p.name: (p, p.call([torch.from_numpy(a) for a in p.arrays], plain=True))
            for p in probes}


_SETUP = {
    "timing5": ("pallas_timing5", {"reps_for": lambda n: T5_REPS}, False,
                {"reps_for": lambda n, interpret: T5_REPS}),
    "bisect4": ("pallas_bisect4", {"REPS": B4_REPS}, False, {"REPS": B4_REPS}),
    "bisect3": ("pallas_bisect3", {"TRIPS": B3_TRIPS}, False, {"TRIPS": B3_TRIPS}),
    "perf": ("pallas_perf_probe", {"TRIPS": PF_TRIPS}, True, {"TRIPS": PF_TRIPS}),
}


@pytest.fixture(scope="module")
def runs():
    """Each module's runs: the script's in interpret mode and the port's
    plain ones, computed once a module and kept."""
    cache = {}

    def get(mod):
        if mod not in cache:
            name, settings, pair, patch = _SETUP[mod]
            ref = _interpret_runs(name, settings, pair)
            port = _port_runs(MODULES[mod], patch)
            assert len(ref) == len(port) == len(MODULES[mod].RUNS)
            cache[mod] = dict(zip(MODULES[mod].RUNS, ref)), port
        return cache[mod]
    return get


def _held(runs, mod, name):
    ref, port = runs(mod)
    args, checksum, want = ref[name]
    probe, got = port[name]
    assert len(args) - 1 <= len(probe.arrays) and int(args[-1]) == 1  # the salt
    for a, b in zip(args[:-1], probe.arrays):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == want.shape == (8, 128) and got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert L.checksum(got[0]) == checksum


@pytest.mark.parametrize("name", T5.RUNS)
def test_timing5_run_matches_interpret(name, runs):
    _held(runs, "timing5", name)


@pytest.mark.parametrize("name", B4.RUNS)
def test_bisect4_run_matches_interpret(name, runs):
    _held(runs, "bisect4", name)


@pytest.mark.parametrize("name", B3.RUNS)
def test_bisect3_run_matches_interpret(name, runs):
    _held(runs, "bisect3", name)


@pytest.mark.parametrize("name", PF.RUNS)
def test_perf_run_matches_interpret(name, runs):
    _held(runs, "perf", name)


@pytest.mark.parametrize("mod,name", [("bisect3", "T0"), ("bisect3", "T1"),
                                      ("bisect3", "T4"), ("timing5", "T32"),
                                      ("timing5", "T128")])
def test_trip_reads_a_slab_row_it_never_writes(mod, name, runs):
    """The interpret-mode output is ``v + rv`` plus INT32_MIN, the fill of
    a scratch row never written: on the TPU that row is undefined."""
    ref, port = runs(mod)
    probe, _ = port[name]
    params = dict(probe.params, flags=probe.params["flags"] & ~L.LL_OUT_SLAB)
    x = torch.from_numpy(probe.arrays[0])
    reps = B3_TRIPS if mod == "bisect3" else T5_REPS
    vr = L.lane_loop_plain(x, reps=reps, **params)[0].numpy().astype(np.int64)
    diff = (ref[name][2].astype(np.int64) - vr) % (1 << 32)
    assert (diff == 1 << 31).all()


def test_batched_refill_reassembles_column_0():
    """R2-R4's pages are pre-split into byte planes (``:176-180``), so the
    refill's word 0 is the raw page row's column 0; R1 reassembles the low
    bytes of columns 0, 8, 16, 24 instead."""
    pages = B3.inputs()["R1"][0]
    cur = torch.arange(1024, dtype=torch.int32).reshape(8, 128) % 256
    k = cur.long().reshape(1024)
    split = L.plane_refill_plain(torch.from_numpy(B3.split_planes(pages)), cur,
                                 L.PR_REFILL, 1)[0]
    assert torch.equal(split.long().reshape(1024), k + torch.from_numpy(pages[:, 0]).long()[k])
    raw = L.plane_refill_plain(torch.from_numpy(pages), cur, L.PR_REFILL, 1)[0]
    word = sum(torch.from_numpy(pages[:, 8 * i]).long()[k] << (8 * i) for i in range(4))
    assert torch.equal(raw.long().reshape(1024), (k + word) & 0x7FFFFFFF)


# ----------------------------------------------------------------------
# entry points, wrappers
# ----------------------------------------------------------------------


# each module's CPU loop counts, cut to a few loops for main() here
_MAIN_CUTS = {"timing5": {"reps_for": lambda n, interpret: 2},
              "bisect4": {"CPU_REPS": 2}, "bisect3": {"CPU_TRIPS": 32},
              "perf": {"TRIPS": 32, "E_REPS": 2}}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_on_the_cpu(name, capsys, monkeypatch):
    for k, v in _MAIN_CUTS[name].items():
        monkeypatch.setattr(MODULES[name], k, v)
    assert MODULES[name].main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("not timed (cpu)") == len(MODULES[name].RUNS)


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
        "lane_loop": lambda: L.lane_loop(t(8, 128), L.LL_OUT_SLAB, 2, reps=4),
        "gather_loop": lambda: L.gather_loop(t(16, 128), t(8, 128), L.GL_ROWS,
                                             reps=4),
        "dot_loop": lambda: L.dot_loop(t(32, 64, **i8), t(64, 128, **i8), False,
                                       reps=4),
        "plane_refill": lambda: L.plane_refill(t(64, 32), t(8, 128), L.PR_REFILL,
                                               reps=4),
        "transpose_loop": lambda: L.transpose_loop(t(128, 1024), False, reps=4),
        "copy_loop": lambda: L.copy_loop(t(256, 1024), reps=4),
        "stack_fetch": lambda: L.stack_fetch(t(8, 128), reps=4),
        "jframe": lambda: L.jframe(t(8, 128), t(8, 128), "p3", reps=4),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_wrapper_raises_off_the_card(name):
    """A tensor neither on the CPU nor on a CUDA device is refused, not
    taken by the plain version."""
    with pytest.raises(ValueError):
        _wrapper_calls("meta")[name]()


@pytest.mark.parametrize("call", [
    lambda t: L.gather_loop(t(12, 128), t(8, 128), L.GL_ROWS, reps=1),
    lambda t: L.gather_loop(t(8, 100), t(8, 128), L.GL_REPL, reps=1),
    lambda t: L.dot_loop(t(24, 64, dt=torch.int8), t(64, 128, dt=torch.int8),
                         False, reps=1),
    lambda t: L.dot_loop(t(8, 8, dt=torch.int8), t(2048, 128, dt=torch.int8),
                         True, reps=1),
    lambda t: L.transpose_loop(t(96, 1024), False, reps=1),
    lambda t: L.copy_loop(t(128, 1024), reps=1),
    lambda t: L.jframe(t(8, 128), t(8, 128), "v9", reps=1)],
    ids=["gather_rows", "gather_width", "dot_rows", "dot_smem", "transpose",
         "copy", "jframe_stage"])
def test_wrapper_refuses_shapes_its_kernel_cannot_take(call):
    def t(*shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device="meta")
    with pytest.raises(ValueError):
        call(t)


def test_wrappers_launch_nothing_for_cpu_tensors():
    wrappers = list(L.KERNELS.values())
    before = [w.launches for w in wrappers]
    for call in _wrapper_calls("cpu").values():
        call()
    assert [w.launches for w in wrappers] == before


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

CARD_REPS = 160  # past 128, so the slab store wraps; past 32 copies


def _all_probes():
    return [(mod, p) for mod, m in sorted(MODULES.items()) for p in m.probes()]


@pytest.mark.gpu
@pytest.mark.parametrize("mod,name", [(m, p.name) for m, p in _all_probes()])
def test_kernel_matches_plain_on_the_card(mod, name, cuda):
    probe = {p.name: p for p in MODULES[mod].probes()}[name]
    args = [torch.from_numpy(a).to(cuda) for a in probe.arrays]
    n = min(probe.reps, CARD_REPS)
    got = probe.call(args, n)
    want = probe.call(args, n, plain=True)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_wrapper_raises_on_a_wrong_dtype(name, cuda):
    with pytest.raises(ValueError):
        _wrapper_calls(cuda, bad=True)[name]()


@pytest.mark.gpu
def test_jframe_pool_rows_on_the_card(cuda):
    """p3's pool against ``index_add_`` on lanes that crowd into few rows."""
    x = torch.randint(-300, 300, (8, 128), generator=torch.Generator().manual_seed(1),
                      dtype=torch.int32)
    pre = torch.randint(0, 4 * 128, (8, 128), generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)
    got = L.jframe(x.to(cuda), pre.to(cuda), "p3", reps=9)
    want = L.jframe_plain(x, pre, "p3", 9)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
