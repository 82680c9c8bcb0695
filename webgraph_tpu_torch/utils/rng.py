"""Seeded xoroshiro128+ PRNG (reference analog: dsiutils
XoRoShiRo128PlusRandom, used by HyperBall init, permutations and SpeedTest).

Implements the public xoroshiro128+ algorithm (Blackman & Vigna) with
SplitMix64 seed scrambling, matching the reference's deterministic behavior
for a given seed.
"""

from __future__ import annotations

_M64 = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _M64


def _splitmix64(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return state, z ^ (z >> 31)


class XoRoShiRo128PlusRandom:
    def __init__(self, seed: int = 0):
        state = seed & _M64
        state, self._s0 = _splitmix64(state)
        state, self._s1 = _splitmix64(state)

    def next_long(self) -> int:
        s0, s1 = self._s0, self._s1
        result = (s0 + s1) & _M64
        s1 ^= s0
        self._s0 = _rotl(s0, 24) ^ s1 ^ ((s1 << 16) & _M64)
        self._s1 = _rotl(s1, 37)
        return result

    def next_long_signed(self) -> int:
        v = self.next_long()
        return v - (1 << 64) if v >= (1 << 63) else v

    def next_int(self, bound: int) -> int:
        """Uniform int in [0, bound) (rejection on the high bits)."""
        if bound <= 0:
            raise ValueError("bound must be positive")
        mask = (1 << (bound - 1).bit_length()) - 1
        while True:
            v = self.next_long() & mask
            if v < bound:
                return v

    def next_double(self) -> float:
        return (self.next_long() >> 11) * (2.0**-53)

    def shuffle(self, arr):
        """Fisher-Yates from the end (reference IntArrays.shuffle order)."""
        for i in range(len(arr) - 1, 0, -1):
            j = self.next_int(i + 1)
            arr[i], arr[j] = arr[j], arr[i]
        return arr
