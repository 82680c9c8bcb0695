"""Instantaneous integer codes (scalar reference implementations).

These are the bit-level codecs the whole framework rests on: unary, Elias
gamma/delta, Boldi-Vigna zeta_k, Golomb, variable-length nibble, and minimal
binary, plus the zigzag signed<->natural mapping.

Bit conventions match the reference framework's stream layer (dsiutils
``InputBitStream``/``OutputBitStream``, used throughout
BVGraph.java:622-850):

* streams are MSB-first: the first bit written is the most significant bit of
  the first byte;
* ``unary(x)`` is ``x`` zeroes followed by a one;
* ``gamma(x)`` codes ``x+1`` as ``unary(h)`` followed by the ``h`` low bits of
  ``x+1``, where ``h = floor(log2(x+1))`` — equivalently, the integer ``x+1``
  written in ``2h+1`` bits;
* ``delta(x)`` codes ``h = floor(log2(x+1))`` in gamma followed by the ``h``
  low bits of ``x+1``;
* ``zeta_k(x)`` (Boldi-Vigna, "Codes for the World-Wide Web") codes
  ``h = floor(log2(x+1)/k)`` in unary followed by the minimal-binary code of
  ``x+1 - 2^(hk)`` in the universe ``[0, 2^(hk+k) - 2^hk)``;
* ``golomb_b(x)`` is ``unary(x // b)`` followed by minimal-binary of ``x % b``
  in universe ``[0, b)``;
* ``nibble(x)`` is a sequence of 4-bit groups ``(stop, 3 value bits)``, most
  significant group first, stop bit set on the *last* group;
* minimal binary in universe ``[0, b)`` with ``s = floor(log2(b))``: values
  below ``2^(s+1) - b`` take ``s`` bits, the rest take ``s+1`` bits (offset by
  the threshold).

Every encoder returns ``(bits, length)`` where the code occupies the low
``length`` bits of the Python int ``bits`` and is emitted MSB-first.

Scalar code here is the *oracle*; vectorized NumPy and JAX equivalents live in
``vcodes.py`` / ``jcodes.py`` and are tested against this module.
"""

from __future__ import annotations

# Compression-flag code identifiers (reference: CompressionFlags.java:26-44).
NONE = 0
DELTA = 1
GAMMA = 2
GOLOMB = 3
SKEWED_GOLOMB = 4
UNARY = 5
ZETA = 6
NIBBLE = 7

CODING_NAME = ["NONE", "DELTA", "GAMMA", "GOLOMB", "SKEWED_GOLOMB", "UNARY", "ZETA", "NIBBLE"]


def int2nat(x: int) -> int:
    """Zigzag map of a signed integer to a natural (reference Fast.int2nat)."""
    return x << 1 if x >= 0 else -((x << 1) + 1)


def nat2int(x: int) -> int:
    """Inverse zigzag map (reference Fast.nat2int)."""
    return x >> 1 if (x & 1) == 0 else -(x >> 1) - 1


def encode_unary(x: int) -> tuple[int, int]:
    if x < 0:
        raise ValueError(f"negative value for unary code: {x}")
    return 1, x + 1


def encode_gamma(x: int) -> tuple[int, int]:
    if x < 0:
        raise ValueError(f"negative value for gamma code: {x}")
    z = x + 1
    h = z.bit_length() - 1
    # unary(h) ++ low h bits of z  ==  the integer z in 2h+1 bits.
    return z, 2 * h + 1


def encode_delta(x: int) -> tuple[int, int]:
    if x < 0:
        raise ValueError(f"negative value for delta code: {x}")
    z = x + 1
    h = z.bit_length() - 1
    gbits, glen = encode_gamma(h)
    return (gbits << h) | (z - (1 << h)), glen + h


def encode_minimal_binary(x: int, b: int) -> tuple[int, int]:
    """Minimal binary code of ``x`` in the universe ``[0, b)``, ``b >= 1``."""
    if not 0 <= x < b:
        raise ValueError(f"value {x} out of universe [0, {b})")
    s = b.bit_length() - 1
    if b == (1 << s):
        # Power-of-two universe: plain s-bit binary.
        return x, s
    threshold = (1 << (s + 1)) - b
    if x < threshold:
        return x, s
    return x + threshold, s + 1


def encode_zeta(x: int, k: int) -> tuple[int, int]:
    if x < 0:
        raise ValueError(f"negative value for zeta code: {x}")
    if k < 1:
        raise ValueError(f"invalid zeta parameter k={k}")
    z = x + 1
    h = (z.bit_length() - 1) // k
    ubits, ulen = encode_unary(h)
    left = 1 << (h * k)
    mbits, mlen = encode_minimal_binary(z - left, left * ((1 << k) - 1))
    return (ubits << mlen) | mbits, ulen + mlen


def encode_golomb(x: int, b: int) -> tuple[int, int]:
    if x < 0:
        raise ValueError(f"negative value for golomb code: {x}")
    if b < 1:
        raise ValueError(f"invalid golomb modulus b={b}")
    q, r = divmod(x, b)
    ubits, ulen = encode_unary(q)
    mbits, mlen = encode_minimal_binary(r, b)
    return (ubits << mlen) | mbits, ulen + mlen


def encode_nibble(x: int) -> tuple[int, int]:
    if x < 0:
        raise ValueError(f"negative value for nibble code: {x}")
    ngroups = max(1, -(-x.bit_length() // 3))
    bits = 0
    for i in range(ngroups - 1, -1, -1):
        stop = 1 if i == 0 else 0
        bits = (bits << 4) | (stop << 3) | ((x >> (3 * i)) & 7)
    return bits, 4 * ngroups


def encode(coding: int, x: int, k: int = 3) -> tuple[int, int]:
    """Encode with the code identified by a compression-flag id."""
    if coding == GAMMA:
        return encode_gamma(x)
    if coding == DELTA:
        return encode_delta(x)
    if coding == UNARY:
        return encode_unary(x)
    if coding == ZETA:
        return encode_zeta(x, k)
    if coding == GOLOMB:
        return encode_golomb(x, k)
    if coding == NIBBLE:
        return encode_nibble(x)
    raise ValueError(f"unsupported coding {coding}")


def code_length(coding: int, x: int, k: int = 3) -> int:
    return encode(coding, x, k)[1]


def gamma_length(x: int) -> int:
    return 2 * ((x + 1).bit_length() - 1) + 1


def delta_length(x: int) -> int:
    h = (x + 1).bit_length() - 1
    return gamma_length(h) + h


def zeta_length(x: int, k: int) -> int:
    z = x + 1
    h = (z.bit_length() - 1) // k
    left = 1 << (h * k)
    b = left * ((1 << k) - 1)
    s = b.bit_length() - 1
    short = z - left < (1 << (s + 1)) - b if b != (1 << s) else True
    return h + 1 + (s if short else s + 1)
