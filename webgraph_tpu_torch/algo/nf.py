"""Exact neighbourhood function (reference analog: NeighbourhoodFunction.java:58).

The reference runs one BFS per node on a thread pool (:100-118).  The
array-native formulation is *bit-parallel multi-source BFS*: 64 sources per
uint64 column, one frontier propagation for all of them at once via a
segmented OR over predecessor bitsets — the same transform HyperBall applies
to counters, specialized to exact bitsets. This is exactly the kind of
word-level parallelism a vector unit executes at full width.

Also provides the static helpers the reference exposes: distance CDF,
average distance, median distance, spid, effective diameter.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph


class NeighbourhoodFunction:
    @staticmethod
    def compute(graph: ImmutableGraph, max_distance: int | None = None) -> np.ndarray:
        """NF(t) = number of pairs (x,y) with d(x,y) <= t, t = 0, 1, ...
        (reference: compute/computeExact, NeighbourhoodFunction.java:100-134)."""
        g = CSRGraph.from_graph(graph)
        offsets, succ = g.to_csr()
        n = g.num_nodes()
        # transpose CSR for predecessor OR-reduction
        t = CSRGraph.from_arcs(succ.astype(np.int64), np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets)), n)
        toff, tsucc = t.to_csr()
        nf = [float(n)]
        limit = max_distance if max_distance is not None else n
        # batches of 64 sources
        totals: list[float] = []
        counts_per_level: dict[int, int] = {}
        for batch_start in range(0, n, 64):
            batch = np.arange(batch_start, min(batch_start + 64, n))
            bits = np.zeros(n, dtype=np.uint64)
            bits[batch] = np.uint64(1) << np.arange(len(batch), dtype=np.uint64)
            level = 0
            prev_pop = len(batch)
            while level < limit:
                # new[x] = bits[x] | OR_{p in pred(x)} bits[p]
                gathered = bits[tsucc]
                if len(gathered):
                    red = np.bitwise_or.reduceat(gathered, np.minimum(toff[:-1], len(gathered) - 1))
                    red[np.diff(toff) == 0] = 0
                else:
                    red = np.zeros(n, dtype=np.uint64)
                new_bits = bits | red
                if np.array_equal(new_bits, bits):
                    break
                bits = new_bits
                level += 1
                pop = int(np.unpackbits(bits.view(np.uint8)).sum())
                counts_per_level[level] = counts_per_level.get(level, 0) + pop - prev_pop
                prev_pop = pop
        max_level = max(counts_per_level.keys(), default=0)
        nf = np.zeros(max_level + 1)
        nf[0] = n
        for lvl, cnt in counts_per_level.items():
            nf[lvl] = cnt
        return np.cumsum(nf)

    # -- static helpers (reference NeighbourhoodFunction statics) -------

    @staticmethod
    def distance_cdf(nf: np.ndarray) -> np.ndarray:
        return np.asarray(nf, dtype=np.float64) / nf[-1]

    @staticmethod
    def average_distance(nf: np.ndarray) -> float:
        cdf = NeighbourhoodFunction.distance_cdf(nf)
        pmf = np.diff(np.concatenate([[0.0], cdf]))
        return float((np.arange(len(pmf)) * pmf).sum())

    @staticmethod
    def median_distance(nf: np.ndarray) -> int:
        cdf = NeighbourhoodFunction.distance_cdf(nf)
        return int(np.searchsorted(cdf, 0.5, side="left"))

    @staticmethod
    def spid(nf: np.ndarray) -> float:
        """Spid (dispersion of the distance distribution): var/mean."""
        cdf = NeighbourhoodFunction.distance_cdf(nf)
        pmf = np.diff(np.concatenate([[0.0], cdf]))
        d = np.arange(len(pmf))
        mean = float((d * pmf).sum())
        var = float(((d - mean) ** 2 * pmf).sum())
        return var / mean if mean else 0.0

    @staticmethod
    def effective_diameter(nf: np.ndarray, alpha: float = 0.9) -> float:
        """Interpolated alpha-effective diameter (reference
        effectiveDiameter)."""
        nf = np.asarray(nf, dtype=np.float64)
        threshold = alpha * nf[-1]
        d = int(np.searchsorted(nf, threshold, side="left"))
        if d == 0:
            return 0.0
        lo, hi = nf[d - 1], nf[d]
        return d - 1 + (threshold - lo) / (hi - lo) if hi > lo else float(d)
