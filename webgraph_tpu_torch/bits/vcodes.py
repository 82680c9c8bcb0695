"""Vectorized (lane-parallel) instantaneous-code readers over NumPy arrays.

Decodes one code *per lane* per call: each lane has its own bit cursor into a
shared word array, so thousands of independent streams (= graph nodes) decode
in parallel.  This is the host blueprint for the JAX package's device decoders in
``jcodes.py`` — same algorithm, same data layout (64-bit windows gathered at
arbitrary bit positions, count-leading-zeros, shift/mask extraction).

All functions take ``(words, pos)`` with ``words`` a uint64 array (MSB-first
bit stream, as produced by :func:`webgraph_tpu_torch.bits.bitstream.bytes_to_words`)
and ``pos`` an int64 array of bit cursors; they return ``(value, new_pos)``
with ``value`` int64.

Scalar oracle: :mod:`webgraph_tpu_torch.bits.bitstream`.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def peek64(words: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """64-bit windows at bit positions ``pos`` (cursor bit is bit 63)."""
    i = (pos >> 6).astype(np.int64)
    off = (pos & 63).astype(_U64)
    w = words[i] << off
    # second word contributes only when off > 0; shift by (64-off) must avoid 64
    off2 = (_U64(64) - off) & _U64(63)
    w2 = np.where(off > 0, words[i + 1] >> off2, _U64(0))
    return w | w2


def bit_length_u64(w: np.ndarray) -> np.ndarray:
    """floor(log2(w)) + 1 for uint64 (0 for 0), exact via 32-bit float exps."""
    hi = (w >> _U64(32)).astype(np.uint32)
    lo = w.astype(np.uint32)  # truncating view of low 32 bits
    bl_hi = np.frexp(hi.astype(np.float64))[1]
    bl_lo = np.frexp(lo.astype(np.float64))[1]
    return np.where(hi > 0, bl_hi + 32, bl_lo).astype(np.int64)


def extract(w: np.ndarray, start: np.ndarray, width: np.ndarray) -> np.ndarray:
    """Extract ``width`` bits of 64-bit windows starting at MSB-offset
    ``start`` (width < 64; width == 0 yields 0)."""
    start = np.asarray(start, dtype=np.int64)
    width = np.asarray(width, dtype=np.int64)
    sh = (_U64(64) - width.astype(_U64) - start.astype(_U64)) & _U64(63)
    v = (w >> sh) & ((_U64(1) << width.astype(_U64)) - _U64(1))
    return np.where(width > 0, v.astype(np.int64), 0)


def read_bits(words: np.ndarray, pos: np.ndarray, width) -> tuple[np.ndarray, np.ndarray]:
    """Read fixed ``width`` (< 64, may be per-lane array) bits per lane."""
    width = np.broadcast_to(np.asarray(width, dtype=np.int64), pos.shape)
    w = peek64(words, pos)
    v = extract(w, np.zeros_like(width), width)
    return v, pos + width


def read_unary(words: np.ndarray, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unary decode per lane; loops only for runs of zeros > 64 bits."""
    count = np.zeros(len(pos), dtype=np.int64)
    p = pos.copy()
    w = peek64(words, p)
    pending = w == 0
    while pending.any():
        count = np.where(pending, count + 64, count)
        p = np.where(pending, p + 64, p)
        w2 = peek64(words, p[pending])
        w = w.copy()
        w[pending] = w2
        pending2 = np.zeros_like(pending)
        pending2[pending] = w2 == 0
        pending = pending2
    z = 64 - bit_length_u64(w)
    return count + z, p + z + 1


def read_gamma(words: np.ndarray, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gamma decode; fast single-window path for h <= 31 (values < 2^32-1),
    which covers all BVGraph quantities on <= 2^31-node graphs."""
    w = peek64(words, pos)
    h = 64 - bit_length_u64(w)  # number of leading zeros
    # value+1 occupies bits [0, 2h+1) of the window
    v = extract(w, np.zeros_like(h), 2 * h + 1)
    return v - 1, pos + 2 * h + 1


def read_delta(words: np.ndarray, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    h, p = read_gamma(words, pos)
    rest, p = read_bits(words, p, h)
    return ((np.int64(1) << h) | rest) - 1, p


def read_minimal_binary(
    words: np.ndarray, pos: np.ndarray, b: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-lane minimal binary decode in universes ``b`` (>= 1)."""
    b = np.broadcast_to(np.asarray(b, dtype=np.int64), pos.shape)
    s = np.maximum(bit_length_u64(b.astype(_U64)) - 1, 0)
    w = peek64(words, pos)
    m = extract(w, np.zeros_like(s), s)
    threshold = (np.int64(1) << (s + 1)) - b
    is_long = m >= threshold
    extra = extract(w, s, np.ones_like(s))
    v = np.where(is_long, ((m << 1) | extra) - threshold, m)
    return v, pos + s + is_long.astype(np.int64)


def read_zeta(words: np.ndarray, pos: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    h, p = read_unary(words, pos)
    left = np.int64(1) << (h * k)
    v, p = read_minimal_binary(words, p, left * ((1 << k) - 1))
    return v + left - 1, p


def read_golomb(words: np.ndarray, pos: np.ndarray, b: int) -> tuple[np.ndarray, np.ndarray]:
    q, p = read_unary(words, pos)
    r, p = read_minimal_binary(words, p, np.full_like(pos, b))
    return q * b + r, p


def read_nibble(words: np.ndarray, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    x = np.zeros(len(pos), dtype=np.int64)
    p = pos.copy()
    done = np.zeros(len(pos), dtype=bool)
    while not done.all():
        g, p2 = read_bits(words, p, 4)
        x = np.where(done, x, (x << 3) | (g & 7))
        p = np.where(done, p, p2)
        done |= (g & 8) > 0
    return x, p


def nat2int(v: np.ndarray) -> np.ndarray:
    """Vectorized inverse zigzag."""
    return np.where((v & 1) == 0, v >> 1, -(v >> 1) - 1)


def int2nat(x: np.ndarray) -> np.ndarray:
    return np.where(x >= 0, x << 1, -((x << 1) + 1))


def make_reader(coding: int, k: int):
    """Reader factory keyed by compression-flag id."""
    from webgraph_tpu_torch.bits import codes as C

    if coding == C.GAMMA:
        return read_gamma
    if coding == C.DELTA:
        return read_delta
    if coding == C.UNARY:
        return read_unary
    if coding == C.ZETA:
        return lambda w, p: read_zeta(w, p, k)
    if coding == C.GOLOMB:
        return lambda w, p: read_golomb(w, p, k)
    if coding == C.NIBBLE:
        return read_nibble
    raise ValueError(f"unsupported coding {coding}")
