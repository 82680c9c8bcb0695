"""Succinct Elias-Fano encoding of monotone sequences (host, NumPy-backed).

Reference analogs: sux4j ``EliasFanoMonotoneLongBigList`` (the BVGraph offset
index, BVGraph.java:81,1594), ``SimpleSelectZero`` (zero-selection) and
``EliasFanoCumulativeOutdegreeList`` (HyperBall's arc-balanced work splitter,
algo/EliasFanoCumulativeOutdegreeList.java:60-142).

A monotone sequence x_0 <= ... <= x_{n-1} < u is split into lower
``l = max(0, floor(log2(u/n)))`` bits, bit-packed into a flat uint64 array,
and upper bits ``x_i >> l`` stored as unary gaps in a bit vector with one 1
per element (position ``(x_i >> l) + i``).  The ONLY retained data are the
two bit arrays plus a per-word popcount directory (o(n) bits):

  * ``get(i)``       = select1(i) - i  joined with the packed lower bits
  * ``successor``    = zero-select on the upper bits + search in one bucket

Unlike round 1's version, no dense copy of the values is kept: every query
reads the succinct arrays (``num_bits``/``resident_bits`` reflect real
storage, asserted in tests/test_efgraph.py).
"""

from __future__ import annotations

import numpy as np

_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


if hasattr(np, "bitwise_count"):
    def _popcount(w: np.ndarray) -> np.ndarray:
        return np.bitwise_count(w).astype(np.int64)
else:  # pragma: no cover - numpy < 2.0
    def _popcount(w: np.ndarray) -> np.ndarray:
        w = w.astype(np.uint64)
        w = w - ((w >> np.uint64(1)) & np.uint64(0x5555555555555555))
        w = (w & np.uint64(0x3333333333333333)) + (
            (w >> np.uint64(2)) & np.uint64(0x3333333333333333))
        w = (w + (w >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        return ((w * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
            np.int64)


def _pack_bits(values: np.ndarray, width: int) -> np.ndarray:
    """Bit-pack ``values`` (each < 2**width) LSB-first into uint64 words."""
    n = len(values)
    if width == 0 or n == 0:
        return np.zeros(0, dtype=np.uint64)
    total = n * width
    nw = (total + 63) // 64
    out = np.zeros(nw, dtype=np.uint64)
    v = values.astype(np.uint64) & np.uint64((1 << width) - 1)
    start = np.arange(n, dtype=np.int64) * width
    wi = start >> 6
    off = (start & 63).astype(np.uint64)
    lo = (v << off) & _ONES
    np.bitwise_or.at(out, wi, lo)
    spill = off.astype(np.int64) + width > 64
    if spill.any():
        hi = (v[spill] >> (np.uint64(64) - off[spill])) & _ONES
        np.bitwise_or.at(out, wi[spill] + 1, hi)
    return out


def _unpack_bits(packed: np.ndarray, width: int, idx: np.ndarray) -> np.ndarray:
    """Extract the ``width``-bit fields at positions ``idx`` (vectorized)."""
    if width == 0:
        return np.zeros(np.shape(idx), dtype=np.int64)
    idx = np.asarray(idx, dtype=np.int64)
    start = idx * width
    wi = start >> 6
    off = (start & 63).astype(np.uint64)
    mask = np.uint64((1 << width) - 1)
    lo = packed[wi] >> off
    need_hi = off.astype(np.int64) + width > 64
    hi = np.zeros_like(lo)
    if np.any(need_hi):
        hi[need_hi] = packed[wi[need_hi] + 1] << (np.uint64(64) - off[need_hi])
    return ((lo | hi) & mask).astype(np.int64)


# byte-level select table: _SELTAB[b, k] = position of the k-th set bit of
# byte b (8 if absent)
_SELTAB = np.full((256, 8), 8, dtype=np.int64)
for _b in range(256):
    _k = 0
    for _p in range(8):
        if (_b >> _p) & 1:
            _SELTAB[_b, _k] = _p
            _k += 1
del _b, _k, _p


def _select_in_word(words: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Position (0..63) of the r-th set bit within each uint64 word
    (shape-preserving: scalar in -> 0-d out, so int() stays legal)."""
    words = np.asarray(words, dtype=np.uint64)
    r = np.asarray(r, dtype=np.int64)
    pos = np.zeros(np.broadcast_shapes(words.shape, r.shape),
                   dtype=np.int64)
    rem = r.astype(np.int64).copy()
    w = words.copy()
    for _ in range(7):
        byte = (w & np.uint64(0xFF)).astype(np.int64)
        c = _popcount(np.uint64(1) * byte.astype(np.uint64))
        step = rem >= c
        pos += np.where(step, 8, 0)
        rem -= np.where(step, c, 0)
        w = np.where(step, w >> np.uint64(8), w)
    byte = (w & np.uint64(0xFF)).astype(np.int64)
    return pos + _SELTAB[byte, np.clip(rem, 0, 7)]


class BitVector:
    """Plain bit vector with rank/select (1 and 0) directories."""

    def __init__(self, length: int, one_positions: np.ndarray):
        self.length = int(length)
        nw = (self.length + 63) // 64
        self.words = np.zeros(nw, dtype=np.uint64)
        p = np.asarray(one_positions, dtype=np.int64)
        np.bitwise_or.at(
            self.words, p >> 6, np.uint64(1) << (p & 63).astype(np.uint64))
        # exclusive per-word popcount directory
        pc = _popcount(self.words)
        self._rank1w = np.zeros(nw + 1, dtype=np.int64)
        np.cumsum(pc, out=self._rank1w[1:])

    @property
    def num_ones(self) -> int:
        return int(self._rank1w[-1])

    def directory_bits(self) -> int:
        return 64 * (len(self._rank1w))

    def rank1(self, pos) -> np.ndarray:
        """Number of ones strictly before position pos (vectorized)."""
        pos = np.asarray(pos, dtype=np.int64)
        wi = pos >> 6
        base = self._rank1w[wi]
        rem = (pos & 63).astype(np.uint64)
        m = np.where(rem > 0, (np.uint64(1) << rem) - np.uint64(1), np.uint64(0))
        return base + _popcount(self.words[np.minimum(wi, len(self.words) - 1)] & m)

    def select1(self, i) -> np.ndarray:
        """Position of the i-th (0-based) one (vectorized)."""
        i = np.asarray(i, dtype=np.int64)
        wi = np.searchsorted(self._rank1w, i, side="right") - 1
        wi = np.clip(wi, 0, len(self.words) - 1)
        r = i - self._rank1w[wi]
        return (wi << 6) + _select_in_word(self.words[wi], r)

    def select0(self, i) -> np.ndarray:
        """Position of the i-th (0-based) zero (vectorized)."""
        i = np.asarray(i, dtype=np.int64)
        # zeros before word w: 64*w - rank1w[w]
        zw = 64 * np.arange(len(self.words) + 1, dtype=np.int64) - self._rank1w
        wi = np.searchsorted(zw, i, side="right") - 1
        wi = np.clip(wi, 0, len(self.words) - 1)
        r = i - zw[wi]
        return (wi << 6) + _select_in_word(~self.words[wi], r)


class EliasFanoMonotoneList:
    """Succinct random access to a monotone int64 sequence.

    ``get`` is a select1 on the upper-bit vector (word-directory + in-word
    byte walk) joined with the packed lower bits; no dense copy is kept."""

    def __init__(self, values: np.ndarray, upper_bound: int | None = None):
        values = np.asarray(values, dtype=np.int64)
        n = len(values)
        if n and np.any(np.diff(values) < 0):
            raise ValueError("sequence must be nondecreasing")
        u = int(upper_bound if upper_bound is not None else (values[-1] + 1 if n else 1))
        u = max(u, 1)
        self.n = n
        self.u = u
        self.l = max(0, (u // max(n, 1)).bit_length() - 1)
        self.lower = _pack_bits(values, self.l)
        upper = (values >> self.l).astype(np.int64)
        one_pos = upper + np.arange(n, dtype=np.int64)
        ulen = int(one_pos[-1] + 1) if n else 0
        self.upper = BitVector(ulen, one_pos)
        self._last = int(values[-1]) if n else 0

    def __len__(self) -> int:
        return self.n

    def get(self, i) -> np.ndarray | int:
        scalar = np.isscalar(i) or getattr(i, "ndim", 1) == 0
        idx = np.atleast_1d(np.asarray(i, dtype=np.int64))
        hi = self.upper.select1(idx) - idx
        v = (hi << self.l) | _unpack_bits(self.lower, self.l, idx)
        return int(v[0]) if scalar else v

    def get_array(self) -> np.ndarray:
        """Decode the whole sequence (transient, for bulk consumers): the
        upper bits' ones in one pass over the bit vector, in place of a
        select a value."""
        if self.n == 0:
            return np.zeros(0, dtype=np.int64)
        idx = np.arange(self.n, dtype=np.int64)
        bits = np.unpackbits(
            self.upper.words.astype("<u8", copy=False).view(np.uint8),
            bitorder="little")
        hi = np.flatnonzero(bits)[: self.n] - idx
        return (hi << self.l) | _unpack_bits(self.lower, self.l, idx)

    def num_bits(self) -> int:
        """Bits of the succinct payload (lower + upper arrays)."""
        return 64 * len(self.lower) + 64 * len(self.upper.words)

    def resident_bits(self) -> int:
        """Total resident storage incl. the select directory."""
        return self.num_bits() + self.upper.directory_bits()

    def successor_index(self, bound: int) -> int:
        """Least i with values[i] >= bound (n if none) — zero-select on the
        upper bits narrows to one bucket, then binary search the lowers."""
        if self.n == 0 or bound > self._last:
            return self.n
        if bound <= 0:
            return 0
        hb = int(bound) >> self.l
        # first index whose high part is >= hb: ones after the hb-th zero
        if hb == 0:
            i0 = 0
        else:
            p = int(self.upper.select0(hb - 1))
            i0 = int(self.upper.rank1(p))
        # bucket end: first index with high part > hb
        if (self._last >> self.l) <= hb:
            i1 = self.n
        else:
            p1 = int(self.upper.select0(hb))
            i1 = int(self.upper.rank1(p1))
        if i0 >= i1:
            return i0
        lows = _unpack_bits(self.lower, self.l, np.arange(i0, i1))
        target = int(bound) & ((1 << self.l) - 1) if self.l else 0
        return i0 + int(np.searchsorted(lows, target, side="left"))


class CumulativeSequence:
    """Succinct cumulative sequence with ``skip_to`` — reference analog of
    EliasFanoCumulativeOutdegreeList: given nonnegative per-item counts,
    supports "find the least index whose prefix sum is >= bound", the
    arc-balanced work splitter used by HyperBall (HyperBall.java:849-873).
    Backed by the succinct monotone list (zero-selection), not a dense
    cumsum."""

    def __init__(self, counts: np.ndarray):
        counts = np.asarray(counts, dtype=np.int64)
        cumulative = np.concatenate([[0], np.cumsum(counts)])
        self._n = len(cumulative)
        self._ef = EliasFanoMonotoneList(cumulative)
        self._index = 0

    def skip_to(self, lower_bound: int) -> int:
        """Return the least prefix sum >= lower_bound, advancing the internal
        index (reference: skipTo, EliasFanoCumulativeOutdegreeList.java:142)."""
        i = self._ef.successor_index(lower_bound)
        self._index = i
        return int(self._ef.get(i)) if i < self._n else -1

    def current_index(self) -> int:
        """The item index of the last skip_to result (number of items whose
        cumulative count is below the returned sum)."""
        return self._index

    def num_bits(self) -> int:
        return self._ef.num_bits()
