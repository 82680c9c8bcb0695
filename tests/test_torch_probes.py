"""The port's fragment probes (webgraph_tpu_torch/probes) against the JAX
package's probe scripts on the scripts' own inputs, on the CPU through the
kernels' plain versions:

* B.2 ``pallas_probe.py``: ``gamma_kernel`` in interpret mode, values and
  new positions exactly;
* B.5 ``pallas_onehot_probe.py``: ``gather_kernel`` in interpret mode
  exactly, and on rows whose indices span two table rows (the row comes
  from column 0, so that is not ``T[idx]``);
* B.4 ``pallas_fetch_bench.py``: each mode's kernel in interpret mode at
  ``K`` = 8; the port equals ``f32hi``, ``f32def`` and ``bf16``; ``int8``
  (sign-extended bytes ORed into the word) differs, a reference defect;
* B.3 ``pallas_composite_probe.py``: its ``main()`` at ``TRIPS`` = 256
  with ``timeit`` capturing each run's arguments and checksum: the port's
  inputs equal them and its plain versions give the same checksums;
* B.1 ``pallas_winmach_chip.py``: its ``main()`` prints BAD here (3,625
  wrong codes, the first in lane 43), a reference defect; the port decodes
  every code to the script's oracle.

``scripts/`` is not a package: each script is loaded by path, and none is
edited.  Card twins (``gpu``) hold each kernel to its plain version and
skip without one."""

import contextlib
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from webgraph_tpu.bits import codes as JC
from webgraph_tpu.bits import jcodes as JJ
from webgraph_tpu.bits.bitstream import OutputBitStream as JOutputBitStream
from webgraph_tpu_torch import probes
from webgraph_tpu_torch.kernels import pcodes as P
from webgraph_tpu_torch.probes import composite as CP
from webgraph_tpu_torch.probes import fetch as FB
from webgraph_tpu_torch.probes import gamma as GM
from webgraph_tpu_torch.probes import onehot as OH
from webgraph_tpu_torch.probes import winmach as WM
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPOSITE_TRIPS = 256


def script(name):
    """A fresh copy of ``scripts/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ----------------------------------------------------------------------
# B.2 pallas_probe.py
# ----------------------------------------------------------------------


def test_gamma_matches_interpret():
    S = script("pallas_probe")
    vals, data, pos, ends = GM.inputs()
    obs = JOutputBitStream()
    for v in vals:
        obs.write(JC.GAMMA, int(v), 3)
    assert obs.to_bytes() == data
    words = jnp.asarray(JJ.words_from_bytes(data))
    words = jnp.pad(words, (0, -len(words) % 256))
    fn = pl.pallas_call(
        S.gamma_kernel,
        out_shape=(jax.ShapeDtypeStruct(pos.shape, jnp.uint32),
                   jax.ShapeDtypeStruct(pos.shape, jnp.int32)),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=(pl.BlockSpec(memory_space=pltpu.VMEM),) * 2,
        interpret=True)
    out, newpos = (np.asarray(a) for a in fn(words, jnp.asarray(pos)))
    got, gpos = GM.gamma(torch.from_numpy(GM.stream_words(data)),
                         torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), out.astype(np.int64))
    np.testing.assert_array_equal(gpos.numpy(), newpos)
    np.testing.assert_array_equal(gpos.numpy(), ends)
    assert gpos.dtype == torch.int32


# ----------------------------------------------------------------------
# B.5 pallas_onehot_probe.py
# ----------------------------------------------------------------------


def _onehot_interpret(S, planes, idx):
    fn = pl.pallas_call(
        S.gather_kernel,
        out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)
    return np.asarray(fn(*[jnp.asarray(p) for p in planes], jnp.asarray(idx)))


def test_onehot_matches_interpret():
    words, planes, idx = OH.inputs()
    want = _onehot_interpret(script("pallas_onehot_probe"), planes, idx)
    got = OH.row_gather(torch.from_numpy(planes), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, words[idx])


def test_onehot_row_comes_from_column_0():
    """Rows whose indices span two table rows: the kernel (and the port)
    take every word from column 0's table row, so the output is not
    ``T[idx]``."""
    words, planes, _ = OH.inputs()
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 63, size=16)
    cols = rng.integers(0, 128, size=(16, 128))
    idx = (rows[:, None] * 128 + cols).astype(np.int32)
    idx[:, 64:] += 128  # the right half in the next table row
    want = _onehot_interpret(script("pallas_onehot_probe"), planes, idx)
    got = OH.row_gather(torch.from_numpy(planes), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, words[rows[:, None] * 128 + (idx & 127)])
    assert not np.array_equal(want, words[idx])


# ----------------------------------------------------------------------
# B.4 pallas_fetch_bench.py
# ----------------------------------------------------------------------

FETCH_K = 8
FETCH_SUM = -272_258_333   # the exact sum at K = 8
FETCH_INT8 = -57_866_269   # the int8 mode's sum (sign-extended bytes)


@pytest.mark.parametrize("mode", FB.MODES)
def test_fetch_mode_matches_interpret(mode, monkeypatch):
    S = script("pallas_fetch_bench")
    monkeypatch.setattr(S, "K", FETCH_K)
    pos, pool = FB.inputs()
    fn = pl.pallas_call(
        S.make_kernel(mode),
        in_specs=[pl.BlockSpec((8, 128), lambda: (0, 0)),
                  pl.BlockSpec((S.ROWS, 128), lambda: (0, 0))],
        out_specs=pl.BlockSpec((1, 1), memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.int32),
        interpret=True)
    want = int(fn(jnp.asarray(pos), jnp.asarray(pool))[0, 0])
    got = int(FB.fetch(torch.from_numpy(pos), torch.from_numpy(pool), FETCH_K))
    assert got == FETCH_SUM
    if mode == "int8":
        assert want == FETCH_INT8  # the reference's defect, not copied
    else:
        assert want == got


# ----------------------------------------------------------------------
# B.3 pallas_composite_probe.py
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def composite_runs():
    """The script's ``main()`` at COMPOSITE_TRIPS: each run's arguments
    and checksum, in order; and the port's runs on the CPU."""
    S = script("pallas_composite_probe")
    S.TRIPS, S.INTERPRET = COMPOSITE_TRIPS, True
    captured = []

    def timeit(fn, *args):
        s = int(fn(*args))
        captured.append(([np.asarray(a) for a in args], s))
        return 1.0, s

    S.timeit = timeit
    with contextlib.redirect_stdout(io.StringIO()) as out:
        S.main()
    assert "FAIL" not in out.getvalue(), out.getvalue()
    return dict(zip(CP.RUNS, captured)), CP.run("cpu", COMPOSITE_TRIPS)


@pytest.mark.parametrize("name", CP.RUNS)
def test_composite_run_matches_script(name, composite_runs):
    ref, port = composite_runs
    args, checksum = ref[name]
    ins = CP.inputs()[name]
    assert len(args) == len(ins) + 1 and int(args[-1]) == 1  # the salt
    for a, b in zip(args, ins):
        np.testing.assert_array_equal(a, b)
    assert port[name]["checksum"] == checksum
    if name == "G":
        assert checksum == 312612


# ----------------------------------------------------------------------
# B.1 pallas_winmach_chip.py
# ----------------------------------------------------------------------


def test_winmach_reference_decodes_wrong_here():
    """The script's probe builds a 128-word table per group where
    ``D.win_refill`` reads 256 (``WTAB_COLS``), so lanes whose words lie
    past the first 128-word row decode garbage."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        script("pallas_winmach_chip").main()
    text = out.getvalue()
    assert "window machinery: BAD" in text
    assert "num bad: 3625 first: [[43, 0]" in text
    assert "start=4135" in text


def test_winmach_port_decodes_the_oracle():
    vals, words, starts = WM.inputs()
    obs = JOutputBitStream()
    for v in vals.reshape(-1):
        obs.write(JC.ZETA, int(v), 3)
    data = obs.to_bytes()
    w32 = np.frombuffer(data + b"\x00" * (-len(data) % 4), dtype=">u4")
    np.testing.assert_array_equal(words.reshape(-1)[:len(w32)].view(np.uint32),
                                  w32)
    out = WM.winmach(torch.from_numpy(WM.stream_words(words)),
                     torch.from_numpy(starts))
    assert out.shape == (WM.K, WM.LANES) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy().T, vals)


def test_winmach_plain_flags_a_code_past_the_stream():
    vals, words, starts = WM.inputs()
    w = torch.from_numpy(WM.stream_words(words))
    nbits = (w.numel() - 2) * 64
    st = torch.tensor([int(starts[5]), nbits - 3, nbits + 1, -1])
    out = WM.winmach(w, st, k=2)
    np.testing.assert_array_equal(out[:, 0].numpy(), vals[5, :2])
    assert (out[:, 1:] == -1).all()


# ----------------------------------------------------------------------
# entry points, wrappers
# ----------------------------------------------------------------------

MODULES = {"winmach": WM, "gamma": GM, "composite": CP, "fetch": FB,
           "onehot": OH}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_on_the_cpu(name, capsys, monkeypatch):
    monkeypatch.setattr(CP, "CPU_TRIPS", 64)
    monkeypatch.setattr(FB, "K", 8)
    assert MODULES[name].main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "BAD" not in out and "not timed (cpu)" in out


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

    i64 = dict(dt=torch.int64, wrong=torch.int32)
    return {
        "winmach": lambda: WM.winmach(t(6, **i64), t(4, dt=torch.int64)),
        "gamma": lambda: GM.gamma(t(6, **i64), t(4, wrong=torch.int32)),
        "relayout": lambda: CP.relayout(t(8, 128), 4),
        "merge_trip": lambda: CP.merge_trip(t(8, 128), 4),
        "refill": lambda: CP.refill(t(256, 32), t(8, 128, wrong=torch.int32), 4),
        "compaction": lambda: CP.compaction(t(8, 128), t(8, 128), 128, 4),
        "page_fetch": lambda: CP.page_fetch(t(32, 128),
                                            t(8, 128, wrong=torch.int32), 4),
        "fetch": lambda: FB.fetch(t(8, 128), t(152, 128), 4),
        "row_gather": lambda: OH.row_gather(t(4, 64, 128, dt=torch.int8,
                                              wrong=torch.int16),
                                            t(2, 128, wrong=torch.int32)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_wrapper_raises_off_the_card(name):
    """A tensor neither on the CPU nor on a CUDA device is refused, not
    taken by the plain version."""
    with pytest.raises(ValueError):
        _wrapper_calls("meta")[name]()


@pytest.mark.parametrize("call", [
    lambda t: CP.refill(t(CP.MAX_REFILL_PAGES + 1, 32), t(8, 128), 4),
    lambda t: CP.page_fetch(t(CP.MAX_FETCH_PAGES + 1, 128), t(8, 128), 4),
    lambda t: CP.compaction(t(8, 128), t(8, 128), 7, 4)],
    ids=["refill", "page_fetch", "compaction"])
def test_wrapper_refuses_what_shared_memory_cannot_hold(call):
    with pytest.raises(ValueError, match="page rows|at least 8 rows"):
        call(lambda *shape: torch.zeros(shape, dtype=torch.int32, device="meta"))


def test_wrappers_launch_nothing_for_cpu_tensors():
    wrappers = [WM.winmach, CP.relayout, CP.merge_trip, CP.refill,
                CP.compaction, CP.page_fetch, FB.fetch, OH.row_gather, P.probe]
    before = [w.launches for w in wrappers]
    for call in _wrapper_calls("cpu").values():
        call()
    assert [w.launches for w in wrappers] == before


def test_s32_wraps():
    x = torch.tensor([2**31, 2**32 + 5, -(2**31) - 1, 7])
    assert probes.s32(x).tolist() == [-(2**31), 5, 2**31 - 1, 7]


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_wrapper_calls("cpu")))
def test_wrapper_raises_on_a_wrong_dtype(name, cuda):
    with pytest.raises(ValueError):
        _wrapper_calls(cuda, bad=True)[name]()


@pytest.mark.gpu
def test_winmach_on_the_card(cuda):
    vals, words, starts = WM.inputs()
    w = torch.from_numpy(WM.stream_words(words)).to(cuda)
    st = torch.from_numpy(starts).to(cuda)
    out = WM.winmach(w, st)
    np.testing.assert_array_equal(out.cpu().numpy().T, vals)
    assert torch.equal(out, WM.winmach_plain(w, st))
    bad = torch.tensor([int(starts[5]), w.numel() * 64, -1], device=cuda)
    assert torch.equal(WM.winmach(w, bad, 3), WM.winmach_plain(w, bad, 3))


@pytest.mark.gpu
def test_gamma_on_the_card(cuda):
    assert GM.run(cuda)["ok"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CP.RUNS)
def test_composite_on_the_card(name, cuda):
    args = [torch.from_numpy(a).to(cuda) for a in CP.inputs()[name]]
    got = CP.call(name, args, 512)
    want = CP.call(name, [a.cpu() for a in args], 512)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w), name


@pytest.mark.gpu
def test_fetch_on_the_card(cuda):
    pos, pool = (torch.from_numpy(a).to(cuda) for a in FB.inputs())
    assert int(FB.fetch(pos, pool, FETCH_K)) == FETCH_SUM
    assert torch.equal(FB.fetch(pos, pool), FB.fetch_plain(pos, pool))
    far = pos + 200 * 128  # rows past the pool give 0
    assert torch.equal(FB.fetch(far, pool, 4), FB.fetch_plain(far, pool, 4))


@pytest.mark.gpu
def test_row_gather_on_the_card(cuda):
    words, planes, idx = OH.inputs()
    pl_, ix = torch.from_numpy(planes).to(cuda), torch.from_numpy(idx).to(cuda)
    out = OH.row_gather(pl_, ix)
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32), words[idx])
    ix2 = ix.clone()
    ix2[:, 64:] += 128
    ix2[0, 0] = 1 << 20  # a row outside the table gives 0
    assert torch.equal(OH.row_gather(pl_, ix2), OH.row_gather_plain(pl_, ix2))
