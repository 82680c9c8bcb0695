"""CSRGraph — the canonical in-memory immutable graph.

Flat compressed-sparse-row arrays: ``offsets`` (int64, n+1) and
``successors`` (int32, m, sorted within each node).  This is the decoded form
every TPU kernel consumes and the interchange format between layers; it plays
the role the reference's decoded ``int[][]`` successor lists play in
ArrayListMutableGraph.immutableView() (ArrayListMutableGraph.java:49) while
being directly shardable/deviceable.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph, NodeIterator


class CSRGraph(ImmutableGraph):
    def __init__(self, offsets: np.ndarray, successors: np.ndarray, n: int | None = None):
        offsets = np.asarray(offsets, dtype=np.int64)
        successors = np.asarray(successors, dtype=np.int32)
        if n is None:
            n = len(offsets) - 1
        if len(offsets) != n + 1:
            raise ValueError(f"offsets must have n+1={n + 1} entries, got {len(offsets)}")
        if offsets[0] != 0 or offsets[-1] != len(successors):
            raise ValueError("offsets must start at 0 and end at len(successors)")
        self.offsets = offsets
        self.succ = successors
        self._n = n

    # -- constructors ---------------------------------------------------

    @classmethod
    def from_lists(cls, lists) -> "CSRGraph":
        n = len(lists)
        offsets = np.zeros(n + 1, dtype=np.int64)
        for i, l in enumerate(lists):
            offsets[i + 1] = len(l)
        np.cumsum(offsets, out=offsets)
        succ = (
            np.concatenate([np.asarray(l, dtype=np.int32) for l in lists])
            if offsets[-1]
            else np.zeros(0, dtype=np.int32)
        )
        return cls(offsets, succ, n)

    @classmethod
    def from_arcs(cls, sources, targets, n: int | None = None, sort: bool = True, dedup: bool = False) -> "CSRGraph":
        """Build from arc arrays (any order); sorts per-source."""
        src = np.asarray(sources, dtype=np.int64)
        dst = np.asarray(targets, dtype=np.int64)
        if n is None:
            n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        if sort:
            order = np.lexsort((dst, src))
            src, dst = src[order], dst[order]
        if dedup and len(src):
            keep = np.empty(len(src), dtype=bool)
            keep[0] = True
            np.not_equal(src[1:], src[:-1], out=keep[1:])
            keep[1:] |= dst[1:] != dst[:-1]
            src, dst = src[keep], dst[keep]
        offsets = np.zeros(n + 1, dtype=np.int64)
        counts = np.bincount(src, minlength=n)
        offsets[1:] = np.cumsum(counts)
        return cls(offsets, dst.astype(np.int32), n)

    @classmethod
    def from_graph(cls, g: ImmutableGraph) -> "CSRGraph":
        if isinstance(g, CSRGraph):
            return g
        offsets, succ = g.to_csr()
        return cls(offsets, succ, g.num_nodes())

    # -- ImmutableGraph API ---------------------------------------------

    def num_nodes(self) -> int:
        return self._n

    def num_arcs(self) -> int:
        return int(self.offsets[-1])

    def outdegree(self, x: int) -> int:
        return int(self.offsets[x + 1] - self.offsets[x])

    def outdegrees(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    def successors(self, x: int) -> np.ndarray:
        return self.succ[self.offsets[x] : self.offsets[x + 1]]

    successor_array = successors

    def to_csr(self) -> tuple[np.ndarray, np.ndarray]:
        return self.offsets, self.succ

    def node_iterator(self, start: int = 0) -> NodeIterator:
        g = self

        class _Iter(NodeIterator):
            def __init__(self, frm: int, bound: int):
                self._next = frm
                self._curr = frm - 1
                self._bound = bound

            def has_next(self) -> bool:
                return self._next < self._bound

            def next_int(self) -> int:
                if not self.has_next():
                    raise StopIteration
                self._curr = self._next
                self._next += 1
                return self._curr

            def outdegree(self) -> int:
                return g.outdegree(self._curr)

            def successor_array(self) -> np.ndarray:
                return g.successors(self._curr)

            def copy(self, upper_bound: int) -> "NodeIterator":
                return _Iter(self._next, min(upper_bound, g._n))

        return _Iter(start, self._n)

    def has_arc(self, x: int, y: int) -> bool:
        s = self.successors(x)
        i = np.searchsorted(s, y)
        return bool(i < len(s) and s[i] == y)
