"""MSB-first bit streams over byte buffers (host side).

Functionally equivalent to the reference stream layer (dsiutils
``InputBitStream``/``OutputBitStream`` as used by
BVGraph.java:622-850): a stream of
bits packed MSB-first into bytes, with instantaneous-code readers/writers and
random repositioning at arbitrary bit offsets.

The backing store is an array of 64-bit big-endian words, so a 64-bit window
at any bit position is two word fetches + shifts; scalar readers here are the
correctness oracle for the vectorized NumPy/JAX decoders (``vcodes.py``).
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def bytes_to_words(data: bytes) -> np.ndarray:
    """Pack an MSB-first byte stream into big-endian uint64 words (padded)."""
    n = len(data)
    pad = (-n) % 8
    if pad:
        data = data + b"\x00" * pad
    return np.frombuffer(data, dtype=">u8").astype(np.uint64)


def words_to_bytes(words: np.ndarray, bit_length: int) -> bytes:
    """Unpack big-endian uint64 words back to the byte stream of a bit stream
    of ``bit_length`` bits (padded with zero bits to a byte boundary)."""
    raw = words.astype(">u8").tobytes()
    return raw[: (bit_length + 7) // 8]


class MappedWords:
    """Lazy big-endian uint64 word view over a memory-mapped byte buffer.

    The reference's mapped load mode (BVGraph.java:1551-1554,
    ByteBufferInputStream.map) keeps the graph file off the heap and decodes
    straight from the mapping; this is the NumPy equivalent: ``buf`` is an
    ``np.memmap`` (or any uint8 array) and words are assembled per access,
    so random-access decoding touches only the pages it reads.

    ``materialize()`` converts to a plain uint64 array (needed by the bulk
    vectorized/device decoders, which by nature read the whole stream).
    """

    __slots__ = ("_buf", "_n")

    def __init__(self, buf: np.ndarray):
        self._buf = buf
        self._n = (len(buf) + 7) // 8

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> int:
        b = bytes(self._buf[8 * i : 8 * i + 8])
        if len(b) < 8:
            b = b + b"\x00" * (8 - len(b))
        return int.from_bytes(b, "big")

    def materialize(self) -> np.ndarray:
        return bytes_to_words(self._buf.tobytes())


def as_u64_words(words) -> np.ndarray:
    """Plain uint64 ndarray view of a word store (materializing if mapped)."""
    if isinstance(words, MappedWords):
        return words.materialize()
    return np.asarray(words, dtype=np.uint64)


class _SentinelWords:
    """MappedWords plus an out-of-range zero sentinel word."""

    __slots__ = ("_mw",)

    def __init__(self, mw: MappedWords):
        self._mw = mw

    def __getitem__(self, i: int) -> int:
        return self._mw[i] if i < len(self._mw) else 0


class InputBitStream:
    """Sequential + random-access bit reader (scalar oracle).

    Equivalent API surface to the reference's InputBitStream: read_bits /
    read_unary / read_gamma / read_delta / read_zeta / read_golomb /
    read_nibble / read_minimal_binary, plus ``position(bit)`` seek and a
    ``read_bits_count`` accounting counter.
    """

    __slots__ = ("_words", "_nwords", "pos", "length")

    def __init__(self, data, bit_length: int | None = None):
        if isinstance(data, (bytes, bytearray, memoryview)):
            words = bytes_to_words(bytes(data))
            if bit_length is None:
                bit_length = 8 * len(data)
        elif isinstance(data, np.ndarray) and data.dtype == np.uint64:
            words = data
            if bit_length is None:
                bit_length = 64 * len(data)
        elif isinstance(data, MappedWords):
            # lazy mapped store: keep as-is (per-access word assembly); the
            # sentinel is provided by MappedWords' zero-padded tail reads.
            if bit_length is None:
                bit_length = 64 * len(data)
            self._words = _SentinelWords(data)
            self._nwords = len(data) + 1
            self.pos = 0
            self.length = bit_length
            return
        else:
            raise TypeError(f"unsupported backing store {type(data)}")
        # Python ints are much faster than numpy scalars for bit twiddling.
        self._words = words.tolist()
        self._words.append(0)  # sentinel so peek64 never falls off the end
        self._nwords = len(self._words)
        self.pos = 0
        self.length = bit_length

    def position(self, bit: int) -> None:
        self.pos = bit

    def tell(self) -> int:
        return self.pos

    def _peek64(self) -> int:
        """The next 64 bits at the cursor, MSB-aligned (cursor bit = bit 63)."""
        i, off = divmod(self.pos, 64)
        w = (self._words[i] << off) & _MASK64
        if off:
            w |= self._words[i + 1] >> (64 - off)
        return w

    def read_bits(self, width: int) -> int:
        """Read ``width`` (0..57ish) bits MSB-first as an unsigned integer.

        Works for widths up to 64.
        """
        if width == 0:
            return 0
        if width <= 64:
            v = self._peek64() >> (64 - width)
            self.pos += width
            return v
        hi = self.read_bits(width - 32)
        return (hi << 32) | self.read_bits(32)

    def read_bit(self) -> int:
        i, off = divmod(self.pos, 64)
        self.pos += 1
        return (self._words[i] >> (63 - off)) & 1

    def read_unary(self) -> int:
        count = 0
        while True:
            w = self._peek64()
            if w:
                z = 64 - w.bit_length()
                self.pos += z + 1
                return count + z
            count += 64
            self.pos += 64
            if self.pos > self.length + 64:
                raise EOFError("ran off the end of the bit stream in read_unary")

    def read_gamma(self) -> int:
        w = self._peek64()
        if w:
            h = 64 - w.bit_length()
            if 2 * h + 1 <= 64:
                v = w >> (64 - (2 * h + 1))
                self.pos += 2 * h + 1
                return v - 1
        h = self.read_unary()
        return ((1 << h) | self.read_bits(h)) - 1

    def read_delta(self) -> int:
        h = self.read_gamma()
        return ((1 << h) | self.read_bits(h)) - 1

    def read_minimal_binary(self, b: int) -> int:
        s = b.bit_length() - 1
        if b == (1 << s):
            return self.read_bits(s)
        threshold = (1 << (s + 1)) - b
        m = self.read_bits(s)
        if m < threshold:
            return m
        return ((m << 1) | self.read_bit()) - threshold

    def read_zeta(self, k: int) -> int:
        h = self.read_unary()
        left = 1 << (h * k)
        m = self.read_bits(h * k + k - 1)
        if m < left:
            return m + left - 1
        return ((m << 1) | self.read_bit()) - 1

    def read_golomb(self, b: int) -> int:
        q = self.read_unary()
        return q * b + self.read_minimal_binary(b)

    def read_nibble(self) -> int:
        x = 0
        while True:
            x <<= 3
            g = self.read_bits(4)
            x |= g & 7
            if g & 8:
                return x

    # Long variants are identical at Python-int precision.
    read_long_gamma = read_gamma
    read_long_delta = read_delta
    read_long_zeta = read_zeta
    read_long_golomb = read_golomb
    read_long_nibble = read_nibble

    def read(self, coding: int, k: int = 3) -> int:
        from webgraph_tpu_torch.bits import codes as C

        if coding == C.GAMMA:
            return self.read_gamma()
        if coding == C.DELTA:
            return self.read_delta()
        if coding == C.UNARY:
            return self.read_unary()
        if coding == C.ZETA:
            return self.read_zeta(k)
        if coding == C.GOLOMB:
            return self.read_golomb(k)
        if coding == C.NIBBLE:
            return self.read_nibble()
        raise ValueError(f"unsupported coding {coding}")


class OutputBitStream:
    """MSB-first bit writer with instantaneous-code writers.

    ``written_bits`` mirrors the reference's ``writtenBits()`` accounting used
    for offsets and the per-component bit statistics.
    """

    __slots__ = ("_words", "_acc", "_acclen", "written_bits")

    def __init__(self):
        self._words: list[int] = []
        self._acc = 0
        self._acclen = 0
        self.written_bits = 0

    def write_bits(self, bits: int, width: int) -> int:
        if width < 0 or bits >> width:
            raise ValueError(f"value 0x{bits:x} does not fit in {width} bits")
        self._acc = (self._acc << width) | bits
        self._acclen += width
        while self._acclen >= 64:
            self._acclen -= 64
            self._words.append((self._acc >> self._acclen) & _MASK64)
            self._acc &= (1 << self._acclen) - 1
        self.written_bits += width
        return width

    def write_unary(self, x: int) -> int:
        # Long unary runs are written in 64-bit chunks of zeros.
        n = x
        while n >= 63:
            self.write_bits(0, 63)
            n -= 63
        return self.write_bits(1, n + 1) + (x - n)

    def write_gamma(self, x: int) -> int:
        from webgraph_tpu_torch.bits import codes as C

        bits, width = C.encode_gamma(x)
        return self.write_bits(bits, width)

    def write_delta(self, x: int) -> int:
        from webgraph_tpu_torch.bits import codes as C

        bits, width = C.encode_delta(x)
        return self.write_bits(bits, width)

    def write_zeta(self, x: int, k: int) -> int:
        from webgraph_tpu_torch.bits import codes as C

        bits, width = C.encode_zeta(x, k)
        return self.write_bits(bits, width)

    def write_golomb(self, x: int, b: int) -> int:
        from webgraph_tpu_torch.bits import codes as C

        bits, width = C.encode_golomb(x, b)
        return self.write_bits(bits, width)

    def write_nibble(self, x: int) -> int:
        from webgraph_tpu_torch.bits import codes as C

        bits, width = C.encode_nibble(x)
        return self.write_bits(bits, width)

    def write_minimal_binary(self, x: int, b: int) -> int:
        from webgraph_tpu_torch.bits import codes as C

        bits, width = C.encode_minimal_binary(x, b)
        return self.write_bits(bits, width)

    def write(self, coding: int, x: int, k: int = 3) -> int:
        from webgraph_tpu_torch.bits import codes as C

        bits, width = C.encode(coding, x, k)
        return self.write_bits(bits, width)

    def append(self, other: "OutputBitStream") -> int:
        """Bit-level concatenation of another stream onto this one (the
        multi-shard merge step; reference: InputBitStream.copyTo as used at
        BVGraph.java:2498-2550)."""
        nbits = other.written_bits
        for w in other._words:
            self.write_bits(w, 64)
        tail = nbits & 63
        if tail:
            self.write_bits(other._acc, tail)
        # Correct the accounting: full words may exceed written bits only via
        # _acc, which we handled exactly.
        return nbits

    def append_raw(self, data: bytes, nbits: int) -> int:
        """Bit-level concatenation of an MSB-first byte stream (e.g. a
        native-encoder shard) onto this one."""
        full, tail = divmod(nbits, 64)
        need = (full + (1 if tail else 0)) * 8
        arr = np.frombuffer(data[:need].ljust(need, b"\0"), dtype=">u8")
        for i in range(full):
            self.write_bits(int(arr[i]), 64)
        if tail:
            self.write_bits(int(arr[full]) >> (64 - tail), tail)
        return nbits

    def to_bytes(self) -> bytes:
        words = list(self._words)
        acc, acclen = self._acc, self._acclen
        if acclen:
            words.append((acc << (64 - acclen)) & _MASK64)
        arr = np.array(words, dtype=np.uint64)
        return words_to_bytes(arr, self.written_bits)

    def to_words(self) -> np.ndarray:
        words = list(self._words)
        if self._acclen:
            words.append((self._acc << (64 - self._acclen)) & _MASK64)
        return np.array(words, dtype=np.uint64)
