"""The port's streaming-decoder probes (webgraph_tpu_torch/probes: v6, v6b;
kernels in csrc/forms.cu and csrc/loops.cu) against the JAX package's
``scripts/v6_probe.py`` and ``v6_probe2.py``, on the CPU through the kernels'
plain versions.

Both scripts set no ``interpret=``, so their loaded copies get the stand-in
``pl`` of ``test_torch_form_probes`` with interpret mode on, which records
every ``pallas_call``'s operands and outputs.  v6_probe's P1 and P2 run as
they are; P3 (``probe_trip``) runs at :data:`P3_TRIPS` trips and P4
(``probe_fetch``) as it is, each through a stand-in ``timed`` that calls the
script's function once at salt 0 and keeps its result.  v6_probe2's
``main()`` runs at ``K`` = :data:`K` on the loaded copy.  For every call the
port's inputs equal the script's operands and its plain version gives the
script's output exactly.

D2 fails on every platform (ROADMAP C.12): a test pins the script's FAIL
line, and holds the port's D2 to the script's own ``run_loop`` with a body
that differs from ``bodyD2`` in its one reshape.  Card twins (``gpu``) hold
each kernel to its plain version and skip without one."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgraph_tpu_torch.probes import forms as F
from webgraph_tpu_torch.probes import loops as L
from webgraph_tpu_torch.probes import v6 as V6
from webgraph_tpu_torch.probes import v6b as V6B
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)
from test_torch_form_probes import RecordingPallas, digest, held
from test_torch_probes import cuda, script  # noqa: F401  (fixture)

P3_TRIPS = 64
K = 4


def _recorded(fn_name, **kw):
    """``scripts/v6_probe.py``'s ``fn_name(**kw)`` in interpret mode: the
    records of its calls and the results of its ``timed`` calls."""
    S = script("v6_probe")
    sink, results = [], []
    S.pl = RecordingPallas(sink, interpret=True)

    def timed(fn, *args, reps=3):
        results.append(int(np.uint32(jax.jit(fn)(*args, jnp.uint32(0)))))
        return 0.0, results[-1]

    S.timed = timed
    with contextlib.redirect_stdout(io.StringIO()) as text:
        getattr(S, fn_name)(**kw)
    jax.effects_barrier()
    return text.getvalue(), sink, results


def _probe(name):
    return {p.name: p for p in V6.probes()}[name]


@pytest.mark.parametrize("name", V6.FORMS)
def test_v6_form_matches_interpret(name):
    text, sink, _ = _recorded({"P1": "probe_ta0", "P2": "probe_t8"}[name])
    assert f"{name} " in text and "OK" in text, text
    form = {f.name: f for f in V6.forms()}[name]
    got = form.call(form.tensors("cpu"), plain=True)
    (record,) = sink
    held(record, form, got)
    assert form.expect(*[g.numpy() for g in got])


def test_v6_trip_matches_interpret():
    _, sink, results = _recorded("probe_trip", ntrips=P3_TRIPS)
    (record,) = sink
    probe = _probe("P3")
    out, state = probe.call(probe.tensors("cpu"), P3_TRIPS, plain=True)
    held(record, probe, (out,))
    assert results == [int(out[0, 0]) % (1 << 32)]
    assert state.shape == (6, 8, 128)


def test_v6_trip_salt_and_the_shift_by_32():
    """The salt starts every lane's acc; the first sub-step shifts by
    ``sh`` = 0, where ``w1 >> 32`` must give 0, not w1."""
    S = script("v6_probe")
    sink = []
    S.pl = RecordingPallas(sink, interpret=True)
    S.timed = lambda fn, *args, reps=3: (0.0, int(np.uint32(jax.jit(fn)(*args, jnp.uint32(7)))))
    with contextlib.redirect_stdout(io.StringIO()):
        S.probe_trip(ntrips=1)
    jax.effects_barrier()
    w = torch.from_numpy(V6.inputs()["P3"][0])
    out, _ = L.v6_trip_plain(w, torch.tensor([7], dtype=torch.int32), 1)
    np.testing.assert_array_equal(out.numpy(), sink[0][1][0])


def test_v6_fetch_matches_interpret():
    """fn200's 20 calls at salt 0: call i's output at salt i, and the
    script's total."""
    _, sink, results = _recorded("probe_fetch")
    probe = _probe("P4")
    total, r = probe.call(probe.tensors("cpu"), plain=True)
    assert len(sink) == V6.CALLS
    for i, (ops, outs) in enumerate(sink):
        assert [d for d, _ in ops[:4]] == [digest(a) for a in probe.arrays[:4]]
        assert int(ops[4][1][0]) == i  # the call's salt
        np.testing.assert_array_equal(outs[0], r[i].reshape(1, 1).numpy())
    assert results == [int(total[0]) % (1 << 32)]


@pytest.fixture(scope="module")
def v6b_runs():
    """v6_probe2's ``main()`` in interpret mode at ``K``: its text and its
    records by body (4 calls each: salts 0, 1, 2, 3)."""
    S = script("v6_probe2")
    S.K = K
    sink = []
    S.pl = RecordingPallas(sink, interpret=True)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        S.main()
    jax.effects_barrier()
    bodies = [b for b in V6B.RUNS if b != "D2"]
    assert len(sink) == 4 * len(bodies), text.getvalue()
    return S, text.getvalue(), {b: sink[4 * j:4 * j + 4] for j, b in enumerate(bodies)}


def _hold_body(records, body):
    probe = {p.name: p for p in V6B.probes()}[body]
    x = torch.from_numpy(probe.arrays[0])
    for ops, outs in records:
        salt = ops[1][1]
        assert ops[0][0] == digest(probe.arrays[0])
        out, _ = L.body_loop_plain(x, torch.from_numpy(salt.copy()), body, K)
        np.testing.assert_array_equal(out.numpy(), outs[0])
    assert [int(ops[1][1][0, 0]) for ops, _ in records] == [0, 1, 2, 3]


@pytest.mark.parametrize("body", [b for b in V6B.RUNS if b != "D2"])
def test_v6b_body_matches_interpret(body, v6b_runs):
    _, _, records = v6b_runs
    _hold_body(records[body], body)


def test_v6b_d2_fails_and_the_port_runs_its_per_lane_bases(v6b_runs):
    """C.12: ``acc[0:1, :].reshape(1, 1024)`` cannot reshape 128 words to
    1,024, so bodyD2 never ran; the same body from ``acc.reshape(1, 1024)``
    through the script's own ``run_loop`` equals the port's D2."""
    S, text, _ = v6b_runs
    assert ("D2 sublane gather per-lane bases: FAIL TypeError('cannot reshape array "
            "of shape (1, 128) (size 128) into shape (1, 1024)") in text
    LW = L.LW

    def body_d2(i, acc, x_ref):
        base = (acc.reshape(1, 1024) * 7 + i) % (LW - 64)
        idx = jnp.clip(
            jax.lax.broadcasted_iota(jnp.int32, (32, 1024), 0)
            + jnp.broadcast_to(base, (32, 1024)), 0, LW - 1)
        g = jnp.take_along_axis(x_ref[:, :], idx, axis=0)
        return acc + g[0:1, :].reshape(8, 128) + g[31:32, :].reshape(8, 128)

    sink = []
    S.pl = RecordingPallas(sink, interpret=True)
    words_t = jnp.asarray(V6B.inputs()[1])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        S.run_loop("D2", body_d2, words_t)
    jax.effects_barrier()
    assert "FAIL" not in out.getvalue()
    _hold_body(sink, "D2")


# ----------------------------------------------------------------------
# entry points, wrappers
# ----------------------------------------------------------------------

MODULES = {"v6": V6, "v6b": V6B}
_MAIN_CUTS = {"v6": {"CPU_TRIPS": 2, "CALLS": 2}, "v6b": {"CPU_K": 2}}


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
    def t(*shape, dt=torch.int32, wrong=torch.int64):
        return torch.zeros(shape, dtype=wrong if bad else dt, device=dev)

    return {
        "v6_trip": lambda: L.v6_trip(t(32, 8, 128), t(1, wrong=torch.int32), reps=2),
        "v6_fetch": lambda: L.v6_fetch(
            t(8, 384, 128, dt=torch.bfloat16, wrong=torch.bfloat16), t(8, 128, wrong=torch.int32),
            t(1024, 4096), t(1024, 128, wrong=torch.int32), t(1, wrong=torch.int32), reps=2),
        "body_loop": lambda: L.body_loop(t(1024, L.LW), t(8, 128, wrong=torch.int32), "A",
                                         reps=2),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_wrapper_raises_off_the_card(name):
    with pytest.raises(ValueError):
        _wrapper_calls("meta")[name]()


def test_body_loop_refuses_a_body_or_a_layout():
    def t(*shape):
        return torch.zeros(shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        L.body_loop(t(1024, L.LW), t(8, 128), "G", reps=1)
    with pytest.raises(ValueError):
        L.body_loop(t(1024, L.LW), t(8, 128), "D", reps=1)


def test_wrappers_launch_nothing_for_cpu_tensors():
    wrappers = list(L.V6_KERNELS.values()) + list(F.KERNELS.values())
    before = [w.launches for w in wrappers]
    for call in _wrapper_calls("cpu").values():
        call()
    assert [w.launches for w in wrappers] == before


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

CARD_REPS = 136


@pytest.mark.gpu
@pytest.mark.parametrize("name", V6.RUNS + tuple(f"v6b/{b}" for b in V6B.RUNS))
def test_kernel_matches_plain_on_the_card(name, cuda):
    if name in V6.FORMS:
        run = {f.name: f for f in V6.forms()}[name]
        args = run.tensors(cuda)
        pair = run.call(args), run.call(args, plain=True)
    else:
        probes = {p.name: p for p in V6.probes()}
        probes.update({f"v6b/{p.name}": p for p in V6B.probes()})
        run = probes[name]
        args = run.tensors(cuda)
        n = min(run.reps, CARD_REPS)
        pair = run.call(args, n), run.call(args, n, plain=True)
    for g, w in zip(*pair, strict=True):
        assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_wrapper_raises_on_a_wrong_dtype(name, cuda):
    with pytest.raises(ValueError):
        _wrapper_calls(cuda, bad=True)[name]()


@pytest.mark.gpu
def test_v6_loops_off_the_scripts_inputs_on_the_card(cuda):
    """Random queues and salts, a random stream and random fetch indices
    (some outside the slab): kernel and plain version agree."""
    g = torch.Generator().manual_seed(5)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    w, salt = ints(-(1 << 31), (1 << 31) - 1, 32, 8, 128), ints(-999, 999, 1)
    for a, b in zip(L.v6_trip(w.to(cuda), salt.to(cuda), 50), L.v6_trip_plain(w, salt, 50)):
        assert torch.equal(a.cpu(), b)
    planes = torch.randint(0, 4, (8, 384, 128), generator=g).to(torch.bfloat16)
    args = (planes, ints(-10, 400, 8, 128), ints(0, 1 << 20, 1024, 4096),
            ints(-50, 4200, 1024, 128), salt)
    for a, b in zip(L.v6_fetch(*[x.to(cuda) for x in args], 3), L.v6_fetch_plain(*args, 3)):
        assert torch.equal(a.cpu(), b)
    words = ints(-(1 << 20), 1 << 20, 1024, L.LW)
    s = ints(0, 50, 8, 128)
    for body in L.BODIES:
        x = words.T.contiguous() if body in ("D", "D2") else words
        for a, b in zip(L.body_loop(x.to(cuda), s.to(cuda), body, 20),
                        L.body_loop_plain(x, s, body, 20)):
            assert torch.equal(a.cpu(), b), body
