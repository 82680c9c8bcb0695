"""The comparisons that decide ``correct``: what the timed calls produced
against the plain reference, counted exactly.  Each returns the number of
entries that differ (a length difference counts each missing entry), so a
sound run reads 0.

Plain NumPy; imports nothing of the port.
"""

from __future__ import annotations

import numpy as np


def _diff(a, b) -> int:
    """Entries of the 1-d arrays ``a`` and ``b`` that differ, the longer
    one's surplus included."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    k = min(a.size, b.size)
    return int(np.count_nonzero(a[:k] != b[:k])) + abs(a.size - b.size)


def csr_mismatch(offsets, succ, ref_offsets, ref_succ) -> int:
    """Offsets and successors of a decoded CSR that differ from the
    reference CSR."""
    return _diff(offsets, ref_offsets) + _diff(succ, ref_succ)


def rows(ref_offsets, ref_succ, nodes):
    """The reference answer of a batch of queries: ``(out int32[q, maxd],
    counts int64[q])``, ``out[i, :counts[i]]`` the sorted successors of
    ``nodes[i]``, zero past them, ``maxd`` the largest count and at least
    1."""
    nodes = np.asarray(nodes, dtype=np.int64)
    counts = ref_offsets[nodes + 1] - ref_offsets[nodes]
    maxd = max(int(counts.max(initial=0)), 1)
    out = np.zeros((nodes.size, maxd), dtype=np.int32)
    seg = np.repeat(np.arange(nodes.size), counts)
    j = np.arange(seg.size) - np.repeat(np.cumsum(counts) - counts, counts)
    out[seg, j] = ref_succ[ref_offsets[nodes][seg] + j]
    return out, counts


def rows_mismatch(out, counts, ref_out, ref_counts) -> int:
    """Queries of a batch whose row or count differs from the reference's
    (a batch of another shape: every query)."""
    out, counts = np.asarray(out), np.asarray(counts)
    if out.shape != ref_out.shape or counts.shape != ref_counts.shape:
        return int(ref_counts.size)
    bad = (out != ref_out).any(axis=1) | (counts != ref_counts)
    return int(np.count_nonzero(bad))


def bytes_mismatch(got, ref) -> int:
    """Bytes of an encoder's output that differ from the reference's, and
    each bit of a different bit count: ``got`` and ``ref`` are
    ``(graph_bytes, graph_bits, offsets_bytes, offsets_bits)``."""
    bad = 0
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        bad += _diff(np.frombuffer(g, dtype=np.uint8),
                     np.frombuffer(r, dtype=np.uint8))
    return bad + abs(int(got[1]) - int(ref[1])) + abs(int(got[3]) - int(ref[3]))
