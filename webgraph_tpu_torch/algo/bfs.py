"""Level-synchronous breadth-first visits (reference analog:
ParallelBreadthFirstVisit.java:79).

The reference parallelizes each frontier over threads claiming 1000-node
chunks with CAS markers (:139-181); the array-native formulation here expands
the whole frontier at once with ragged gathers — exactly what a TPU
vectorizes — and keeps the reference's outputs: the visit queue (nodes in
visit order), per-level cut points, and the marker array.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph


def _frontier_targets(offsets, succ, frontier: np.ndarray) -> np.ndarray:
    counts = (offsets[frontier + 1] - offsets[frontier]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    seg = np.repeat(np.arange(len(frontier)), counts)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - base[seg]
    return succ[offsets[frontier][seg] + within].astype(np.int64)


def bfs_distances(g: ImmutableGraph, start: int | np.ndarray) -> np.ndarray:
    """Distances from ``start`` (or min-distance from a set of starts);
    -1 for unreachable nodes."""
    offsets, succ = g.to_csr()
    n = g.num_nodes()
    dist = np.full(n, -1, dtype=np.int64)
    frontier = np.atleast_1d(np.asarray(start, dtype=np.int64))
    dist[frontier] = 0
    level = 0
    while len(frontier):
        targets = _frontier_targets(offsets, succ, frontier)
        targets = targets[dist[targets] < 0]
        if len(targets) == 0:
            break
        frontier = np.unique(targets)
        level += 1
        dist[frontier] = level
    return dist


class ParallelBreadthFirstVisit:
    """Reference-compatible API: visit / visit_all / node_at_max_distance,
    with ``queue`` (visit order), ``cut_points`` (level starts) and
    ``marker`` (round or component id per node)."""

    def __init__(self, graph: ImmutableGraph, parent: bool = False):
        self.graph = graph
        self._csr = CSRGraph.from_graph(graph)
        n = graph.num_nodes()
        self.marker = np.full(n, -1, dtype=np.int64)
        self.parent_array = np.full(n, -1, dtype=np.int64) if parent else None
        self.queue: list[int] = []
        self.cut_points: list[int] = []
        self.round = -1

    def clear(self) -> None:
        self.marker.fill(-1)
        self.queue = []
        self.cut_points = []
        self.round = -1

    def visit(self, start: int, expected_size: int | None = None) -> int:
        """BFS from ``start``, appending to the queue; returns the number of
        visited nodes (reference: visit, ParallelBreadthFirstVisit.java:211)."""
        self.round += 1
        offsets, succ = self._csr.to_csr()
        frontier = np.array([start], dtype=np.int64)
        if self.marker[start] >= 0:
            return 0
        self.marker[start] = self.round
        if self.parent_array is not None:
            self.parent_array[start] = start
        visited = 0
        self.cut_points.append(len(self.queue))
        while len(frontier):
            self.queue.extend(frontier.tolist())
            visited += len(frontier)
            self.cut_points.append(len(self.queue))
            counts = (offsets[frontier + 1] - offsets[frontier]).astype(np.int64)
            total = int(counts.sum())
            if total == 0:
                break
            seg = np.repeat(np.arange(len(frontier)), counts)
            base = np.concatenate([[0], np.cumsum(counts)[:-1]])
            within = np.arange(total) - base[seg]
            targets = succ[offsets[frontier][seg] + within].astype(np.int64)
            srcs = frontier[seg]
            new_mask = self.marker[targets] < 0
            targets, srcs = targets[new_mask], srcs[new_mask]
            # first claim wins (reference CAS): keep first occurrence
            uniq, first_idx = np.unique(targets, return_index=True)
            self.marker[uniq] = self.round
            if self.parent_array is not None:
                self.parent_array[uniq] = srcs[first_idx]
            frontier = uniq
        # drop the trailing empty cut point
        if self.cut_points and self.cut_points[-1] == len(self.queue) and visited:
            pass
        return visited

    def visit_all(self) -> None:
        """Restart from every unvisited node -> marker holds component-ish
        ids (reference: visitAll, :261)."""
        self.clear()
        self.round = -1
        for x in range(self.graph.num_nodes()):
            if self.marker[x] < 0:
                self.visit(x)

    def node_at_max_distance(self) -> int:
        """A node in the last level of the last visit (reference: :335)."""
        if not self.queue:
            return -1
        return self.queue[-1]

    def max_distance(self) -> int:
        """Number of levels of the last visit minus one."""
        # cut_points holds [start0, end0/start1, ...] per visit segment
        return max(0, len(self.cut_points) - 2)
