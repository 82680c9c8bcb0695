"""Connected and strongly connected components.

Reference analogs: ConnectedComponents.java:69 (symmetric graphs, one
parallel-BFS sweep) and StronglyConnectedComponents.java:70 (iterative
Tarjan with an explicit stack, :88-193, plus component sizes and
largest-first renumbering).

Two SCC engines: the data-parallel default ``_scc_coloring`` (trim +
Orzan-style forward max-coloring + backward in-color reachability, all
full-arc-array passes — the TPU-shaped algorithm) and the scalar
``_tarjan_iterative`` oracle it is tested against (the Tarjan recursion
does not vectorize; the reference's own tests accept any component labeling
up to renumbering, which is what ``sort_by_size`` canonicalizes)."""

from __future__ import annotations

import sys

import numpy as np

from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph


class ConnectedComponents:
    """Components of a SYMMETRIC graph (reference ConnectedComponents.compute,
    :91): one BFS sweep; ``component`` maps node -> component id."""

    def __init__(self, component: np.ndarray):
        self.component = component
        self.number_of_components = int(component.max() + 1) if len(component) else 0

    @classmethod
    def compute(cls, graph: ImmutableGraph) -> "ConnectedComponents":
        """Min-label propagation with pointer jumping: full-arc-array passes
        (no per-component Python loop), the TPU-shaped replacement for the
        reference's single visitAll BFS round."""
        offsets, succ = graph.to_csr()
        n = graph.num_nodes()
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
        dst = succ.astype(np.int64)
        label = np.arange(n, dtype=np.int64)
        while True:
            prev = label
            label = label.copy()
            # hook: pull the smaller label across each (undirected) arc
            np.minimum.at(label, dst, prev[src])
            np.minimum.at(label, src, prev[dst])
            # pointer jumping: labels are node ids, so chase them
            label = np.minimum(label, label[label])
            label = label[label]
            if np.array_equal(label, prev):
                break
        # renumber to dense component ids
        _, comp = np.unique(label, return_inverse=True)
        return cls(comp.astype(np.int64))

    def compute_sizes(self) -> np.ndarray:
        return np.bincount(self.component, minlength=self.number_of_components)

    def sort_by_size(self) -> None:
        """Renumber components by decreasing size (largest = 0)."""
        sizes = self.compute_sizes()
        order = np.argsort(-sizes, kind="stable")
        rank = np.zeros_like(order)
        rank[order] = np.arange(len(order))
        self.component = rank[self.component]


class StronglyConnectedComponents:
    """SCC of a directed graph. ``component`` maps node -> component id;
    optional ``buckets``: components that are terminal (no arcs leaving the
    component) — reference's bucket computation."""

    def __init__(self, component: np.ndarray, buckets: np.ndarray | None = None):
        self.component = component
        self.number_of_components = int(component.max() + 1) if len(component) else 0
        self.buckets = buckets

    @classmethod
    def compute(
        cls,
        graph: ImmutableGraph,
        compute_buckets: bool = False,
        method: str = "coloring",
    ) -> "StronglyConnectedComponents":
        offsets, succ = graph.to_csr()
        n = graph.num_nodes()
        if method == "coloring":
            comp = _scc_coloring(offsets, succ, n)
        elif method == "tarjan":
            comp = _tarjan_iterative(offsets, succ, n)
        else:
            raise ValueError(f"unknown SCC method {method!r}")
        buckets = None
        if compute_buckets:
            ncomp = int(comp.max() + 1) if n else 0
            terminal = np.ones(ncomp, dtype=bool)
            src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
            cross = comp[src] != comp[succ]
            terminal[np.unique(comp[src[cross]])] = False
            buckets = terminal
        return cls(comp, buckets)

    def compute_sizes(self) -> np.ndarray:
        return np.bincount(self.component, minlength=self.number_of_components)

    def sort_by_size(self) -> None:
        sizes = self.compute_sizes()
        order = np.argsort(-sizes, kind="stable")
        rank = np.zeros_like(order)
        rank[order] = np.arange(len(order))
        self.component = rank[self.component]
        if self.buckets is not None:
            self.buckets = self.buckets[order]


def _scc_coloring(offsets: np.ndarray, succ: np.ndarray, n: int) -> np.ndarray:
    """Data-parallel SCC: iterative trim + forward max-coloring + backward
    in-color reachability (Orzan's coloring / FW-BW family).  Every step is a
    full-arc-array scatter pass — no recursion, no per-node Python loop —
    which is the shape that vectorizes on TPU.  Exact: tested against the
    Tarjan oracle (tests/test_algo.py).

    Reference behavior anchor: StronglyConnectedComponents.java:88-193
    (component ids differ by renumbering; sort_by_size canonicalizes).
    """
    comp = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return comp
    src_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    dst_all = succ.astype(np.int64)
    keep = src_all != dst_all  # self-loops never affect SCC structure
    src_all, dst_all = src_all[keep], dst_all[keep]
    alive = np.ones(n, dtype=bool)
    ncomp = 0
    ids = np.arange(n, dtype=np.int64)
    while True:
        # --- trim: repeatedly strip nodes with in- or out-degree 0 -------
        while True:
            a = alive[src_all] & alive[dst_all]
            s, t = src_all[a], dst_all[a]
            outd = np.zeros(n, dtype=np.int64)
            ind = np.zeros(n, dtype=np.int64)
            np.add.at(outd, s, 1)
            np.add.at(ind, t, 1)
            trivial = alive & ((outd == 0) | (ind == 0))
            if not trivial.any():
                break
            order = ids[trivial]
            comp[order] = ncomp + np.arange(len(order))
            ncomp += len(order)
            alive[trivial] = False
        if not alive.any():
            break
        a = alive[src_all] & alive[dst_all]
        s, t = src_all[a], dst_all[a]
        # --- forward max-coloring to fixpoint ----------------------------
        color = np.where(alive, ids, np.int64(-1))
        while True:
            prev = color.copy()
            np.maximum.at(color, t, color[s])
            if np.array_equal(color, prev):
                break
        # --- backward reachability of each color root within its color ---
        in_scc = alive & (color == ids)
        same = color[s] == color[t]
        ss, tt = s[same], t[same]
        while True:
            grow = in_scc[tt] & ~in_scc[ss]
            if not grow.any():
                break
            in_scc[ss[grow]] = True
        roots = color[in_scc]
        uniq, inv = np.unique(roots, return_inverse=True)
        comp[in_scc] = ncomp + inv
        ncomp += len(uniq)
        alive[in_scc] = False
    return comp


def _tarjan_iterative(offsets: np.ndarray, succ: np.ndarray, n: int) -> np.ndarray:
    """Iterative Tarjan with an explicit work stack (reference
    StronglyConnectedComponents.Visit, :122-193)."""
    index = np.full(n, -1, dtype=np.int64)
    lowlink = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    stack: list[int] = []
    next_index = 0
    ncomp = 0
    # work stack entries: (node, next-successor position)
    for root in range(n):
        if index[root] >= 0:
            continue
        work = [(root, int(offsets[root]))]
        index[root] = lowlink[root] = next_index
        next_index += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            x, ptr = work[-1]
            if ptr < offsets[x + 1]:
                work[-1] = (x, ptr + 1)
                y = int(succ[ptr])
                if index[y] < 0:
                    index[y] = lowlink[y] = next_index
                    next_index += 1
                    stack.append(y)
                    on_stack[y] = True
                    work.append((y, int(offsets[y])))
                elif on_stack[y]:
                    if index[y] < lowlink[x]:
                        lowlink[x] = index[y]
            else:
                work.pop()
                if work:
                    px = work[-1][0]
                    if lowlink[x] < lowlink[px]:
                        lowlink[px] = lowlink[x]
                if lowlink[x] == index[x]:
                    while True:
                        y = stack.pop()
                        on_stack[y] = False
                        comp[y] = ncomp
                        if y == x:
                            break
                    ncomp += 1
    return comp
