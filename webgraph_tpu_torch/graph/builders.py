"""Mutable graph builder and synthetic generators (test workhorses).

Reference analogs: ArrayListMutableGraph (ArrayListMutableGraph.java:49) with
its generators newDirectedCycle/newBidirectionalCycle/newCompleteGraph/
newCompleteBinaryIntree/newCompleteBinaryOuttree (:140-187), and the
Erdős-Rényi G(n,p) sequential graph (examples/ErdosRenyiGraph.java:59).
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.graph.csr import CSRGraph


class MutableGraph:
    """In-memory mutable graph with an immutable CSR view."""

    def __init__(self, n: int = 0, arcs=None):
        self.n = n
        self._succ: list[set[int]] = [set() for _ in range(n)]
        if arcs is not None:
            for x, y in arcs:
                self.add_arc(int(x), int(y))

    def ensure_node(self, x: int) -> None:
        while self.n <= x:
            self._succ.append(set())
            self.n += 1

    def add_node(self) -> int:
        self.ensure_node(self.n)
        return self.n - 1

    def add_arc(self, x: int, y: int) -> None:
        self.ensure_node(max(x, y))
        self._succ[x].add(y)

    def remove_arc(self, x: int, y: int) -> None:
        self._succ[x].discard(y)

    def has_arc(self, x: int, y: int) -> bool:
        return x < self.n and y in self._succ[x]

    def num_nodes(self) -> int:
        return self.n

    def num_arcs(self) -> int:
        return sum(len(s) for s in self._succ)

    def immutable_view(self) -> CSRGraph:
        return CSRGraph.from_lists([sorted(s) for s in self._succ])

    # -- generators -----------------------------------------------------

    @staticmethod
    def directed_cycle(n: int) -> CSRGraph:
        if n == 0:
            return CSRGraph.from_lists([])
        src = np.arange(n)
        return CSRGraph.from_arcs(src, (src + 1) % n, n)

    @staticmethod
    def bidirectional_cycle(n: int) -> CSRGraph:
        if n == 0:
            return CSRGraph.from_lists([])
        src = np.arange(n)
        return CSRGraph.from_arcs(
            np.concatenate([src, src]), np.concatenate([(src + 1) % n, (src - 1) % n]), n
        )

    @staticmethod
    def complete_graph(n: int, loops: bool = True) -> CSRGraph:
        src = np.repeat(np.arange(n), n)
        dst = np.tile(np.arange(n), n)
        if not loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        return CSRGraph.from_arcs(src, dst, n)

    @staticmethod
    def complete_binary_intree(height: int) -> CSRGraph:
        """Complete binary tree of given height with arcs child -> parent."""
        n = (1 << (height + 1)) - 1
        child = np.arange(1, n)
        return CSRGraph.from_arcs(child, (child - 1) // 2, n)

    @staticmethod
    def complete_binary_outtree(height: int) -> CSRGraph:
        """Complete binary tree of given height with arcs parent -> child."""
        n = (1 << (height + 1)) - 1
        child = np.arange(1, n)
        return CSRGraph.from_arcs((child - 1) // 2, child, n)

    @staticmethod
    def erdos_renyi(n: int, p: float = 0.0, m: int | None = None, loops: bool = False, seed: int = 0) -> CSRGraph:
        """G(n,p) (or fixed-arc-count G(n,m)) random directed graph."""
        rng = np.random.default_rng(seed)
        if m is not None:
            universe = n * n if loops else n * (n - 1)
            picks = rng.choice(universe, size=min(m, universe), replace=False)
            src, dst = np.divmod(picks, n if loops else (n - 1))
            if not loops:
                dst = dst + (dst >= src)
            return CSRGraph.from_arcs(src, dst, n, dedup=True)
        mask = rng.random((n, n)) < p
        if not loops:
            np.fill_diagonal(mask, False)
        src, dst = np.nonzero(mask)
        return CSRGraph.from_arcs(src, dst, n)
