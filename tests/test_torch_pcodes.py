"""K0: the port's plain PyTorch code readers against the JAX readers of
webgraph_tpu/pallas/pcodes.py and the port's copy of the scalar bitstream
oracle, exactly; the probe kernel against the plain readers and the oracle
on the card.

JAX is imported inside the tests that compare with it, so the card test
runs where JAX is not installed."""

import numpy as np
import pytest
import torch

from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.bits.bitstream import OutputBitStream, bytes_to_words
from webgraph_tpu_torch.kernels import pcodes as P

CASES = [("gamma", C.GAMMA, 0), ("delta", C.DELTA, 0)] + [
    (f"zeta{k}", C.ZETA, k) for k in range(1, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _values():
    rng = np.random.default_rng(42)
    return np.concatenate([
        np.arange(64),
        rng.integers(0, 1 << 16, 200),
        rng.integers(0, 1 << 28, 100),
        np.array([2**31 - 1, 2**31], dtype=np.uint64),
    ]).astype(np.uint64)


def _encode(write_each, items):
    """(bytes, positions, lengths) of items written one after another."""
    obs = OutputBitStream()
    pos = []
    for it in items:
        pos.append(obs.written_bits)
        write_each(obs, it)
    pos = np.asarray(pos, dtype=np.int64)
    return obs.to_bytes(), pos, np.diff(np.append(pos, obs.written_bits))


def _windows(data, pos):
    """(hi, lo) uint32 windows at each bit position, from numpy."""
    pad = data + b"\x00" * (12 + (-len(data)) % 4)
    w = np.frombuffer(pad, dtype=">u4").astype(np.uint32)
    i, off = pos // 32, (pos % 32).astype(np.uint32)
    a, b, c = w[i], w[i + 1], w[i + 2]
    off2 = (np.uint32(32) - off) & np.uint32(31)
    hi = np.where(off > 0, (a << off) | (b >> off2), a)
    lo = np.where(off > 0, (b << off) | (c >> off2), b)
    return hi, lo


def _words(data):
    w = np.concatenate([bytes_to_words(data), np.zeros(2, np.uint64)])
    return torch.from_numpy(w.view(np.int64))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _jax():
    """(jax.numpy, webgraph_tpu.pallas.pcodes)"""
    jnp = pytest.importorskip("jax.numpy")
    from webgraph_tpu.pallas import pcodes

    return jnp, pcodes


@pytest.mark.parametrize("name,coding,k", CASES, ids=[c[0] for c in CASES])
def test_readers_match_jax_and_oracle(name, coding, k):
    jnp, JP = _jax()
    vals = _values()
    data, pos, lens = _encode(lambda o, v: o.write(coding, int(v), k), vals)
    hi, lo = _windows(data, pos)
    jv, jl = JP.make_window_reader(coding, k)(jnp.asarray(hi),
                                              jnp.asarray(lo))
    tv, tl = P.make_window_reader(coding, k)(_t(hi), _t(lo))
    np.testing.assert_array_equal(tv.numpy(), vals.astype(np.int64))
    np.testing.assert_array_equal(tl.numpy(), lens)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # the same codes read from the uint64 stream words the kernels take
    pv, pl = P.probe(_words(data), _t(pos), coding, k)
    np.testing.assert_array_equal(pv.numpy(), vals.astype(np.int64))
    np.testing.assert_array_equal(pl.numpy(), lens)


def test_unary_and_minimal_binary_match_jax_and_oracle():
    jnp, JP = _jax()
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 60, 100)
    data, pos, lens = _encode(lambda o, v: o.write_unary(int(v)), vals)
    hi, lo = _windows(data, pos)
    jv, jl = JP.read_unary_short(jnp.asarray(hi), jnp.asarray(lo))
    tv, tl = P.read_unary_short(_t(hi), _t(lo))
    np.testing.assert_array_equal(tv.numpy(), vals)
    np.testing.assert_array_equal(tl.numpy(), lens)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    bs = rng.integers(1, 1 << 20, 100)
    vs = (rng.random(100) * bs).astype(np.int64)
    data, pos, lens = _encode(
        lambda o, vb: o.write_minimal_binary(int(vb[0]), int(vb[1])),
        list(zip(vs, bs)))
    hi, lo = _windows(data, pos)
    jv, jl = JP.read_minimal_binary(jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(bs.astype(np.int32)))
    tv, tl = P.read_minimal_binary(_t(hi), _t(lo), _t(bs))
    np.testing.assert_array_equal(tv.numpy(), vs)
    np.testing.assert_array_equal(tl.numpy(), lens)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    pv, pl = P.probe(_words(data), _t(pos), P.MINIMAL_BINARY, b=_t(bs))
    np.testing.assert_array_equal(pv.numpy(), vs)
    np.testing.assert_array_equal(pl.numpy(), lens)


def test_nat2int_matches_jax():
    jnp, JP = _jax()
    v = np.array([0, 1, 2, 3, 4, 2**32 - 2, 2**32 - 1], dtype=np.uint32)
    got = P.nat2int_u(_t(v)).numpy()
    exp = np.asarray(JP.nat2int_u(jnp.asarray(v))).astype(np.int64)
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(
        got, [0, -1, 1, -2, 2, 2**31 - 1, -(2**31)])


def test_overlong_codes_are_flagged():
    """A window of zeros is a unary run of 64 bits or more: every reader
    marks it with a length above 64 instead of decoding garbage."""
    z = torch.zeros(1, dtype=torch.int64)
    for coding, k in ((C.GAMMA, 0), (C.DELTA, 0), (C.ZETA, 3), (C.UNARY, 0)):
        _, ln = P.make_window_reader(coding, k)(z, z)
        assert int(ln[0]) > 64
    with pytest.raises(ValueError):
        P.make_window_reader(C.GOLOMB, 0)


@pytest.mark.gpu
def test_probe_kernel_matches_plain_on_card(cuda):
    vals = _values()
    for name, coding, k in CASES:
        data, pos, lens = _encode(lambda o, v: o.write(coding, int(v), k),
                                  vals)
        words, tpos = _words(data).to(cuda), _t(pos).to(cuda)
        before = P.probe.launches
        kv, kl = P.probe(words, tpos, coding, k)
        assert P.probe.launches == before + 1
        pv, pl = P.probe_plain(words, tpos, coding, k)
        assert torch.equal(kv, pv), name
        assert torch.equal(kl.long(), pl), name
        np.testing.assert_array_equal(kv.cpu().numpy(),
                                      vals.astype(np.int64))
        np.testing.assert_array_equal(kl.cpu().numpy(), lens)
