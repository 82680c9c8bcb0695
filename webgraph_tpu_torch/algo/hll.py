"""HyperLogLog counter arrays (reference analog: dsiutils
HyperLogLogCounterArray, the engine of HyperBall — HyperBall.java:70,222).

TPU-native layout: instead of 5-bit registers packed into 64-bit longs with
broadword max (HyperBall.java:104-107,901-930), registers live in a dense
``uint8 (n, m)`` array — ``jnp.maximum``/``np.maximum`` over whole rows IS
the vector analog of the reference's register-parallel broadword max, and it
maps straight onto the VPU.

Hashing: 64-bit SplitMix64 of ``node ^ f(seed)`` (the reference uses its own
seeded 64-bit hash; any good 64-bit hash gives the same estimator
guarantees).
"""

from __future__ import annotations

import math

import numpy as np

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return x ^ (x >> np.uint64(31))


def register_init(n: int, log2m: int, seed: int = 0) -> np.ndarray:
    """Initial registers: each node inserts itself into its own counter
    (reference HyperBall.init, HyperBall.java:639-648)."""
    m = 1 << log2m
    with np.errstate(over="ignore"):
        h = splitmix64((np.arange(n, dtype=np.uint64) ^ splitmix64(np.array([seed], dtype=np.uint64).astype(np.uint64))[0]))
    idx = (h & np.uint64(m - 1)).astype(np.int64)
    rest = h >> np.uint64(log2m)
    # rho: position of the first 1 bit (from LSB) + 1, over 64-log2m bits
    width = 64 - log2m
    rho = np.zeros(n, dtype=np.uint8)
    v = rest
    found = np.zeros(n, dtype=bool)
    r = np.ones(n, dtype=np.uint8)
    for _ in range(width):
        bit = (v & np.uint64(1)) == 1
        newly = bit & ~found
        rho[newly] = r[newly]
        found |= bit
        v = v >> np.uint64(1)
        r += 1
    rho[~found] = width + 1
    regs = np.zeros((n, m), dtype=np.uint8)
    regs[np.arange(n), idx] = rho
    return regs


class HyperLogLogCounterArray:
    """An array of n HLL counters with m = 2^log2m registers each."""

    def __init__(self, n: int, log2m: int, seed: int = 0):
        if log2m < 4:
            raise ValueError("log2m must be >= 4")
        self.n = n
        self.log2m = log2m
        self.m = 1 << log2m
        self.seed = seed
        self.registers = register_init(n, log2m, seed)
        self.alpha_mm = self._alpha(self.m) * self.m * self.m

    @staticmethod
    def _alpha(m: int) -> float:
        if m == 16:
            return 0.673
        if m == 32:
            return 0.697
        if m == 64:
            return 0.709
        return 0.7213 / (1 + 1.079 / m)

    def max_with(self, other_rows: np.ndarray, target: int | np.ndarray) -> None:
        """registers[target] = max(registers[target], other_rows) — the
        counter-union primitive (reference HyperLogLogCounterArray.max)."""
        np.maximum(self.registers[target], other_rows, out=self.registers[target])

    def count(self, x: int | np.ndarray | None = None) -> np.ndarray | float:
        """Estimated set size(s) with Flajolet small-range correction."""
        regs = self.registers if x is None else np.atleast_2d(self.registers[x])
        return _estimate(regs, self.alpha_mm, self.m) if x is None else float(_estimate(regs, self.alpha_mm, self.m)[0])

    def counts(self) -> np.ndarray:
        return _estimate(self.registers, self.alpha_mm, self.m)


def _estimate(regs: np.ndarray, alpha_mm: float, m: int) -> np.ndarray:
    z = np.sum(np.exp2(-regs.astype(np.float64)), axis=-1)
    e = alpha_mm / z
    v = np.sum(regs == 0, axis=-1)
    small = (e <= 2.5 * m) & (v > 0)
    with np.errstate(divide="ignore"):
        linear = m * np.log(np.where(v > 0, m / np.maximum(v, 1), 1.0))
    return np.where(small, linear, e)


def estimate_rows(regs, alpha_mm: float, m: int):
    """torch estimator on any device, in float64: the math of
    :func:`_estimate` (``z = sum 2^-r``, ``e = alpha m^2 / z``, the
    small-range correction ``m ln(m / v)`` where ``e <= 2.5 m`` and ``v``,
    the zero registers, is positive) over the rows of a uint8 tensor."""
    import torch

    z = torch.exp2(-regs.to(torch.float64)).sum(dim=-1)
    e = alpha_mm / z
    v = (regs == 0).sum(dim=-1)
    small = (e <= 2.5 * m) & (v > 0)
    linear = m * torch.log(m / v.clamp(min=1).to(torch.float64))
    return torch.where(small, linear, e)
