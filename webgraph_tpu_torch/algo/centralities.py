"""Exact centralities (reference analogs: GeometricCentralities.java:70,
LinearGeometricCentrality.java:76, TopKGeometricCentrality.java:80,
BetweennessCentrality.java:79,
SampleDistanceCumulativeDistributionFunction).

The reference farms one BFS per source to a thread pool (nextNode atomics,
GeometricCentralities.java:94-96); here sources run through vectorized BFS
sweeps (batched bit-parallel where the accumulation allows it).
Closeness/harmonic/Lin/exponential follow the reference's exact definitions
(GeometricCentralities javadoc), Brandes' dependency accumulation for
betweenness (BetweennessCentrality.java:256).
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.algo.bfs import bfs_distances
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph
from webgraph_tpu_torch.transform.transform import transpose as transpose_graph


class GeometricCentralities:
    """Closeness, harmonic, Lin and exponential centralities + reachable
    counts. NOTE (matching the reference): centralities of x use distances
    d(x, y) computed on the graph itself; pass the transpose to obtain the
    usual "incoming-distance" variants."""

    def __init__(self, graph: ImmutableGraph, alpha: float = 0.5,
                 use_device: bool = False, device="cuda"):
        self.graph = CSRGraph.from_graph(graph)
        self.alpha = alpha
        self.use_device = use_device
        self.device = device
        n = graph.num_nodes()
        self.closeness = np.zeros(n)
        self.harmonic = np.zeros(n)
        self.lin = np.zeros(n)
        self.exponential = np.zeros(n)
        self.reachable = np.zeros(n, dtype=np.int64)

    def compute(self) -> "GeometricCentralities":
        if self.use_device:
            # bit-parallel 64-source batches on the torch device
            # (algo/device.py), the counterpart of the reference's
            # per-source thread pool (GeometricCentralities.java:94-96)
            from webgraph_tpu_torch.algo.device import (
                DeviceCSR, geometric_centralities_device)

            clo, har, lin, exp_, reach = geometric_centralities_device(
                DeviceCSR.from_graph(self.graph, self.device),
                alpha=self.alpha)
            self.closeness, self.harmonic, self.lin = clo, har, lin
            self.exponential, self.reachable = exp_, reach
            return self
        g = self.graph
        n = g.num_nodes()
        for x in range(n):
            d = bfs_distances(g, x)
            reach = d >= 0
            dr = d[reach & (d > 0)].astype(np.float64)
            self.reachable[x] = int(reach.sum())
            s = float(dr.sum())
            self.closeness[x] = 0.0 if s == 0 else 1.0 / s
            self.harmonic[x] = float((1.0 / dr).sum()) if len(dr) else 0.0
            self.exponential[x] = float((self.alpha**dr).sum()) if len(dr) else 0.0
            # Lin: square of reachable count over sum of distances; 1 for
            # nodes with no outgoing paths (reference convention)
            self.lin[x] = 1.0 if s == 0 else self.reachable[x] ** 2 / s
        return self


class LinearGeometricCentrality:
    """Generalized geometric centrality with a coefficient vector c:
    centrality(x) = sum_t c[t] * |{y : d(x,y) = t}| (reference
    LinearGeometricCentrality.compute, :252)."""

    def __init__(self, graph: ImmutableGraph, coefficients: np.ndarray):
        self.graph = CSRGraph.from_graph(graph)
        self.coefficients = np.asarray(coefficients, dtype=np.float64)
        self.centrality = np.zeros(graph.num_nodes())

    def compute(self) -> "LinearGeometricCentrality":
        g = self.graph
        c = self.coefficients
        for x in range(g.num_nodes()):
            d = bfs_distances(g, x)
            d = d[(d > 0) & (d < len(c))]
            if len(d):
                self.centrality[x] = float(c[d].sum())
        return self


def reachability_bounds(graph: ImmutableGraph) -> tuple[np.ndarray, np.ndarray]:
    """Per-node lower/upper bounds on |reachable set|, via dynamic
    programming over the SCC condensation (reference
    TopKGeometricCentrality.computeReach, :423-509): the largest SCC's
    reach is computed exactly by a BFS on the condensation; every other
    component takes lower bound = max over successor components (+ own
    size) and upper bound = sum over successor components, with components
    that reach the largest SCC counting its exact reach once plus only
    subtrees the largest SCC cannot reach."""
    from webgraph_tpu_torch.algo.components import StronglyConnectedComponents

    g = CSRGraph.from_graph(graph)
    n = g.num_nodes()
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    offsets, succ = g.to_csr()
    comp = StronglyConnectedComponents.compute(g).component
    nscc = int(comp.max()) + 1
    sizes = np.bincount(comp, minlength=nscc).astype(np.int64)

    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    cs, cd = comp[src], comp[succ]
    cross = cs != cd
    if cross.any():
        pairs = np.unique(np.stack([cs[cross], cd[cross]], axis=1), axis=0)
    else:
        pairs = np.zeros((0, 2), dtype=np.int64)
    adj: list[list[int]] = [[] for _ in range(nscc)]
    for a, b in pairs:
        adj[int(a)].append(int(b))

    # Topological order of the condensation, sinks first, so every
    # component's successors are processed before it.
    indeg = np.zeros(nscc, dtype=np.int64)
    for a, b in pairs:
        indeg[int(a)] += 1  # indegree in the REVERSED dag
    from collections import deque

    radj: list[list[int]] = [[] for _ in range(nscc)]
    for a, b in pairs:
        radj[int(b)].append(int(a))
    q = deque(int(c) for c in range(nscc) if indeg[c] == 0)  # sinks of the dag
    order = []
    while q:
        c = q.popleft()
        order.append(c)
        for p in radj[c]:
            indeg[p] -= 1
            if indeg[p] == 0:
                q.append(p)

    max_scc = int(np.argmax(sizes))
    # exact reach of the largest SCC: BFS over the condensation
    from_max = np.zeros(nscc, dtype=bool)
    from_max[max_scc] = True
    stack = [max_scc]
    exact = 0
    while stack:
        c = stack.pop()
        exact += int(sizes[c])
        for x in adj[c]:
            if not from_max[x]:
                from_max[x] = True
                stack.append(x)

    l_reach = np.zeros(nscc, dtype=np.int64)
    u_reach = np.zeros(nscc, dtype=np.int64)
    u_no_max = np.zeros(nscc, dtype=np.int64)
    reach_max = np.zeros(nscc, dtype=bool)
    l_reach[max_scc] = u_reach[max_scc] = exact
    reach_max[max_scc] = True
    for c in order:
        if c == max_scc:
            continue
        for x in adj[c]:
            l_reach[c] = max(l_reach[c], l_reach[x])
            if not from_max[x]:
                u_no_max[c] += u_no_max[x]
            u_reach[c] = min(u_reach[c] + u_reach[x], n)
            reach_max[c] = reach_max[c] or reach_max[x]
        l_reach[c] += sizes[c]
        u_reach[c] += sizes[c]
        if not from_max[c]:
            u_no_max[c] += sizes[c]
        if reach_max[c]:
            u_reach[c] = exact + u_no_max[c]
        u_reach[c] = min(u_reach[c], n)
    return np.minimum(l_reach, n)[comp], np.minimum(u_reach, n)[comp]


class TopKGeometricCentrality:
    """The k most central nodes under a geometric centrality: the CutClos
    pruned-BFS algorithm of Bergamini–Borassi–Crescenzi–Marino–Vigna
    (reference TopKGeometricCentrality.java:80).  Vertices are visited in
    decreasing outdegree order (:543-548); each BFS keeps a running upper
    bound on the source's centrality from reachability bounds and the level
    structure, and is cut as soon as the bound cannot beat the current k-th
    best (BFSCut, :116-204).  Bounds are evaluated at level boundaries
    (the reference additionally tightens mid-level on already-seen arcs,
    :181-198 — strictly more pruning, same results).  CLOSENESS is served
    by exact computation (the reference supports LIN/HARMONIC/EXPONENTIAL
    only; Lin subsumes closeness on strongly connected graphs)."""

    LIN = "LIN"
    HARMONIC = "HARMONIC"
    CLOSENESS = "CLOSENESS"
    EXPONENTIAL = "EXPONENTIAL"

    @classmethod
    def compute_exact(cls, graph: ImmutableGraph, k: int, centrality: str = "HARMONIC", alpha: float = 0.5):
        gc = GeometricCentralities(graph, alpha).compute()
        values = {
            cls.LIN: gc.lin,
            cls.HARMONIC: gc.harmonic,
            cls.CLOSENESS: gc.closeness,
            cls.EXPONENTIAL: gc.exponential,
        }[centrality]
        order = np.argsort(-values, kind="stable")[:k]
        obj = cls()
        obj.top_k = order
        obj.centrality = values[order]
        obj.pruned = 0
        return obj

    @classmethod
    def compute(cls, graph: ImmutableGraph, k: int, centrality: str = "HARMONIC", alpha: float = 0.5):
        if centrality == cls.CLOSENESS:
            return cls.compute_exact(graph, k, centrality, alpha)
        import heapq

        g = CSRGraph.from_graph(graph)
        n = g.num_nodes()
        offsets, succ = g.to_csr()
        degs = np.diff(offsets).astype(np.int64)
        reach_l, reach_u = reachability_bounds(g)

        values = np.zeros(n, dtype=np.float64)
        mark = np.full(n, -1, dtype=np.int64)  # BFS visit stamps, reused
        heap: list[tuple[float, int]] = []  # min-heap of (centrality, node)
        kth = 0.0
        pruned = 0

        for v in np.argsort(-degs, kind="stable"):
            v = int(v)
            if degs[v] == 0:
                c = 1.0 if centrality == cls.LIN else 0.0
            else:
                c = cls._bfs_cut(
                    v, offsets, succ, degs, mark, centrality, alpha,
                    float(reach_l[v]), float(reach_u[v]), kth,
                )
            if c < 0:
                pruned += 1
                values[v] = 0.0
                continue
            values[v] = c
            heapq.heappush(heap, (c, v))
            if len(heap) > k:
                heapq.heappop(heap)
            if len(heap) == k:
                kth = heap[0][0]

        order = np.argsort(-values, kind="stable")[:k]
        obj = cls()
        obj.top_k = order
        obj.centrality = values[order]
        obj.pruned = pruned
        return obj

    @staticmethod
    def _bfs_cut(v, offsets, succ, degs, mark, centrality, alpha, reach_l, reach_u, kth):
        """Level-synchronous BFSCut (reference :116-204). Returns the exact
        centrality of v, or -1 if the visit was cut."""
        lin = centrality == TopKGeometricCentrality.LIN
        harm = centrality == TopKGeometricCentrality.HARMONIC
        mark[v] = v
        frontier = np.array([v], dtype=np.int64)
        nn_vis = 1
        sum_dist = 0.0
        d = 0
        while len(frontier):
            gamma = float(degs[frontier].sum())
            if lin:
                if kth > 0:
                    f_l = (sum_dist - gamma + (d + 2) * (reach_l - nn_vis)) / (reach_l * reach_l)
                    f_u = (sum_dist - gamma + (d + 2) * (reach_u - nn_vis)) / (reach_u * reach_u)
                    if f_l >= 1.0 / kth and f_u >= 1.0 / kth:
                        return -1.0
            elif harm:
                ub = sum_dist + gamma / (d + 1) + (reach_u - gamma - nn_vis) / (d + 2)
                if ub <= kth:
                    return -1.0
            else:
                ub = sum_dist + gamma * alpha ** (d + 1) + (reach_u - gamma - nn_vis) * alpha ** (d + 2)
                if ub <= kth:
                    return -1.0
            counts = degs[frontier]
            total = int(counts.sum())
            if total == 0:
                break
            seg = np.repeat(np.arange(len(frontier)), counts)
            within = np.arange(total) - np.concatenate([[0], np.cumsum(counts)[:-1]])[seg]
            targets = succ[offsets[frontier][seg] + within].astype(np.int64)
            targets = np.unique(targets[mark[targets] != v])
            if len(targets) == 0:
                break
            mark[targets] = v
            d += 1
            nn_vis += len(targets)
            if lin:
                sum_dist += float(d) * len(targets)
            elif harm:
                sum_dist += len(targets) / float(d)
            else:
                sum_dist += len(targets) * alpha**d
            frontier = targets
        if lin:
            return 1.0 if sum_dist == 0 else nn_vis * nn_vis / sum_dist
        return sum_dist


class BetweennessCentrality:
    """Brandes' algorithm with per-source BFS + dependency accumulation
    (reference BetweennessCentrality.java:256); 64-bit-safe path counts with
    overflow detection (reference PathCountOverflowException, :83)."""

    class PathCountOverflowException(ArithmeticError):
        pass

    def __init__(self, graph: ImmutableGraph, use_device: bool = False,
                 device="cuda"):
        self.graph = CSRGraph.from_graph(graph)
        self.use_device = use_device
        self.device = device
        self.betweenness = np.zeros(graph.num_nodes())

    def compute(self) -> "BetweennessCentrality":
        if self.use_device:
            # batched Brandes on the torch device: exact int64 path
            # counts with the host path's overflow check
            # (BetweennessCentrality.java:83), float64 dependencies
            from webgraph_tpu_torch.algo.device import (
                DeviceCSR, betweenness_device)

            self.betweenness = betweenness_device(
                DeviceCSR.from_graph(self.graph, self.device))
            return self
        g = self.graph
        offsets, succ = g.to_csr()
        n = g.num_nodes()
        for s in range(n):
            # BFS with path counting
            dist = np.full(n, -1, dtype=np.int64)
            sigma = np.zeros(n, dtype=np.float64)
            sigma_i = np.zeros(n, dtype=np.uint64)
            dist[s] = 0
            sigma_i[s] = 1
            levels = [np.array([s], dtype=np.int64)]
            frontier = levels[0]
            while len(frontier):
                counts = (offsets[frontier + 1] - offsets[frontier]).astype(np.int64)
                total = int(counts.sum())
                if total == 0:
                    break
                seg = np.repeat(np.arange(len(frontier)), counts)
                base = np.concatenate([[0], np.cumsum(counts)[:-1]])
                within = np.arange(total) - base[seg]
                targets = succ[offsets[frontier][seg] + within].astype(np.int64)
                srcs = frontier[seg]
                newly = dist[targets] < 0
                new_nodes = np.unique(targets[newly])
                dist[new_nodes] = dist[frontier[0]] + 1
                # path counts: sigma[t] += sigma[src] for arcs into the next level
                nxt = dist[targets] == dist[frontier[0]] + 1
                np.add.at(sigma_i, targets[nxt], sigma_i[srcs[nxt]])
                if np.any(sigma_i[new_nodes] > np.uint64(2**62)):
                    raise self.PathCountOverflowException(f"path count overflow at source {s}")
                if len(new_nodes) == 0:
                    break
                levels.append(new_nodes)
                frontier = new_nodes
            sigma = sigma_i.astype(np.float64)
            # dependency accumulation, deepest level first
            delta = np.zeros(n)
            for lvl in range(len(levels) - 1, 0, -1):
                frontier = levels[lvl - 1]
                counts = (offsets[frontier + 1] - offsets[frontier]).astype(np.int64)
                total = int(counts.sum())
                if total == 0:
                    continue
                seg = np.repeat(np.arange(len(frontier)), counts)
                base = np.concatenate([[0], np.cumsum(counts)[:-1]])
                within = np.arange(total) - base[seg]
                targets = succ[offsets[frontier][seg] + within].astype(np.int64)
                srcs = frontier[seg]
                ok = dist[targets] == dist[srcs] + 1
                contrib = np.zeros(n)
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratio = sigma[srcs[ok]] / sigma[targets[ok]]
                np.add.at(contrib, srcs[ok], ratio * (1.0 + delta[targets[ok]]))
                delta[frontier] += contrib[frontier]
            delta[s] = 0.0
            self.betweenness += delta
        return self


class SampleDistanceCumulativeDistributionFunction:
    """Distance CDF estimated from BFS out of sampled sources (reference
    SampleDistanceCumulativeDistributionFunction)."""

    @staticmethod
    def compute(graph: ImmutableGraph, samples: int, seed: int = 0) -> np.ndarray:
        g = CSRGraph.from_graph(graph)
        n = g.num_nodes()
        rng = np.random.default_rng(seed)
        sources = rng.choice(n, size=min(samples, n), replace=False)
        hist: dict[int, int] = {}
        for s in sources:
            d = bfs_distances(g, int(s))
            for t in d[d > 0]:
                hist[int(t)] = hist.get(int(t), 0) + 1
        if not hist:
            return np.ones(1)
        maxd = max(hist)
        pmf = np.zeros(maxd + 1)
        for t, c in hist.items():
            pmf[t] = c
        cdf = np.cumsum(pmf)
        return cdf / cdf[-1]
