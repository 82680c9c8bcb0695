"""Roofline arithmetic: the least time an operation could take on one
NVIDIA H100, from the work its inputs need.

The peaks are the published ones of the H100 SXM (NVIDIA's data sheet, at
its 700 W power limit): 3.35 TB/s of HBM3 bandwidth, and 67 T 32-bit
operations/s outside the tensor cores (the float32 rate, taken for the
integer rate).  The work is counted from the graph alone, its n nodes, m
arcs and the sizes of its stored files, each input byte read once and
each output byte written once, so it stays the same whatever implements
the operation.  Nothing is taken from the port's scan or plan.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def least_s(nbytes: int, ops: int = 0) -> float:
    """The least seconds for moving ``nbytes`` and doing ``ops`` 32-bit
    operations: the larger of the two bounds."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S)


def decode_work(n: int, m: int, graph_bytes: int) -> tuple[int, int]:
    """``(bytes, operations)`` of a bulk decode into CSR: read the
    ``.graph`` bytes and the (n+1) 8-byte bit offsets once, write m 4-byte
    successors and (n+1) 8-byte CSR offsets once; one operation an arc."""
    return graph_bytes + 8 * (n + 1) + 4 * m + 8 * (n + 1), m


def encode_work(n: int, m: int, graph_bytes: int,
                offsets_bytes: int) -> tuple[int, int]:
    """``(bytes, operations)`` of an encode of a CSR: read the m 4-byte
    successors and (n+1) 8-byte offsets once, write the ``.graph`` and
    ``.offsets`` bytes once; one operation an arc."""
    return 4 * m + 8 * (n + 1) + graph_bytes + offsets_bytes, m
