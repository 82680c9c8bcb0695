"""Graph views & transforms (reference analog: Transform.java:85, 2978 LoC).

All transforms operate on/return :class:`ImmutableGraph`s, with CSR arrays as
the working representation — the sort-based array pipelines here are exactly
the shape a TPU executes well (the reference's external-memory batch
sort-merge, Transform.java:1284-1320, becomes a device sort at pod-memory
scales; the ``*_offline`` variants keep the bounded-memory batch semantics
for host-side processing of oversized graphs).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph
from webgraph_tpu_torch.utils.rng import XoRoShiRo128PlusRandom


def _arcs_of(g: ImmutableGraph) -> tuple[np.ndarray, np.ndarray]:
    offsets, succ = g.to_csr()
    n = g.num_nodes()
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    return src, succ.astype(np.int64)


# ----------------------------------------------------------------------
# Arc filters (reference ArcFilter / NodeClassFilter, Transform.java:99-150)
# ----------------------------------------------------------------------


class ArcFilter:
    """Predicate over arcs; subclass or wrap a callable(src, dst) -> bool
    (vectorized over numpy arrays)."""

    def __init__(self, fn=None):
        self._fn = fn

    def accept(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        if self._fn is None:
            raise NotImplementedError
        return self._fn(src, dst)


class NodeClassFilter(ArcFilter):
    """Accepts arcs whose endpoints belong to the same class
    (reference NodeClassFilter, Transform.java:150)."""

    def __init__(self, node_classes: np.ndarray):
        super().__init__()
        self.classes = np.asarray(node_classes)

    def accept(self, src, dst):
        return self.classes[src] == self.classes[dst]


NO_LOOPS = ArcFilter(lambda s, t: s != t)


def filter_arcs(g: ImmutableGraph, arc_filter: ArcFilter) -> CSRGraph:
    """Keep only arcs accepted by the filter (reference filterArcs,
    Transform.java:500-532)."""
    src, dst = _arcs_of(g)
    keep = arc_filter.accept(src, dst)
    return CSRGraph.from_arcs(src[keep], dst[keep], n=g.num_nodes(), sort=False)


# ----------------------------------------------------------------------
# Transpose / symmetrize / simplify
# ----------------------------------------------------------------------


def transpose(g: ImmutableGraph) -> CSRGraph:
    """Reverse every arc (reference transpose, Transform.java:964-1052)."""
    src, dst = _arcs_of(g)
    return CSRGraph.from_arcs(dst, src, n=g.num_nodes())


class _BatchSpiller:
    """Bounded arc buffer spilled as sorted-deduped batch files (reference
    processBatch, Transform.java:1284-1320)."""

    def __init__(self, batch_size: int, temp_dir, prefix: str):
        self.batch_size = batch_size
        self.tmp = temp_dir or tempfile.mkdtemp(prefix=prefix)
        self.files: list[str] = []
        self._src = np.empty(batch_size, dtype=np.int64)
        self._dst = np.empty(batch_size, dtype=np.int64)
        self._fill = 0

    def add(self, src: np.ndarray, dst: np.ndarray) -> None:
        k0 = 0
        while k0 < len(src):
            take = min(self.batch_size - self._fill, len(src) - k0)
            self._src[self._fill : self._fill + take] = src[k0 : k0 + take]
            self._dst[self._fill : self._fill + take] = dst[k0 : k0 + take]
            self._fill += take
            k0 += take
            if self._fill >= self.batch_size:
                self.spill()

    def spill(self) -> None:
        if self._fill == 0:
            return
        s, d = self._src[: self._fill], self._dst[: self._fill]
        order = np.lexsort((d, s))
        s, d = s[order], d[order]
        uniq = np.ones(len(s), dtype=bool)
        uniq[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
        path = os.path.join(self.tmp, f"batch{len(self.files)}.npz")
        np.savez(path, src=s[uniq], dst=d[uniq])
        self.files.append(path)
        self._fill = 0


class BatchGraph(ImmutableGraph):
    """Sequential graph view over sorted spilled arc batches, enumerated by
    a lazy k-way merge — the reference's BatchGraph
    (Transform.java:1057-1283).  Only one merge block per batch is resident
    at a time; ``to_csr()`` (or feeding ``BVGraph.store``) drives the merge.
    """

    def __init__(self, n: int, batch_files: list[str], block: int = 1 << 16):
        self._n = n
        self._files = batch_files
        self._block = block

    def num_nodes(self) -> int:
        return self._n

    def random_access(self) -> bool:
        return False

    def _merged_arcs(self):
        """Yield (src_chunk, dst_chunk) in globally sorted, deduped order via
        a k-way merge over the sorted batch files (blockwise loads)."""
        import heapq

        readers = []
        for path in self._files:
            d = np.load(path, mmap_mode="r")
            if len(d["src"]):
                readers.append((d["src"], d["dst"]))
        # heap of (src, dst, reader_idx, pos)
        heap = [(int(s[0]), int(t[0]), i, 0) for i, (s, t) in enumerate(readers)]
        heapq.heapify(heap)
        out_s: list[int] = []
        out_t: list[int] = []
        last = (-1, -1)
        while heap:
            s0, t0, i, pos = heapq.heappop(heap)
            if (s0, t0) != last:
                out_s.append(s0)
                out_t.append(t0)
                last = (s0, t0)
            pos += 1
            s, t = readers[i]
            if pos < len(s):
                heapq.heappush(heap, (int(s[pos]), int(t[pos]), i, pos))
            if len(out_s) >= self._block:
                yield np.asarray(out_s, dtype=np.int64), np.asarray(out_t, dtype=np.int64)
                out_s, out_t = [], []
        if out_s:
            yield np.asarray(out_s, dtype=np.int64), np.asarray(out_t, dtype=np.int64)

    def node_iterator(self, start: int = 0):
        csr = self.to_csr()
        return CSRGraph(*csr).node_iterator(start)

    def to_csr(self):
        chunks = list(self._merged_arcs())
        if not chunks:
            return CSRGraph.from_lists([[] for _ in range(self._n)]).to_csr()
        src = np.concatenate([c[0] for c in chunks])
        dst = np.concatenate([c[1] for c in chunks])
        return CSRGraph.from_arcs(src, dst, n=self._n, sort=False).to_csr()


def transpose_offline(g: ImmutableGraph, batch_size: int = 1 << 20, temp_dir=None) -> CSRGraph:
    """External-memory transpose: scan arcs into bounded batches, sort and
    spill each, k-way merge (reference transposeOffline + BatchGraph,
    Transform.java:1405-1446,1057-1283)."""
    n = g.num_nodes()
    spiller = _BatchSpiller(batch_size, temp_dir, "wgt_transpose_")
    it = g.node_iterator()
    while it.has_next():
        x = it.next_int()
        succ = np.asarray(it.successor_array()[: it.outdegree()], dtype=np.int64)
        spiller.add(succ, np.full(len(succ), x, dtype=np.int64))  # swapped
    spiller.spill()
    if not spiller.files:
        return CSRGraph.from_lists([[] for _ in range(n)])
    return CSRGraph(*BatchGraph(n, spiller.files).to_csr())


def symmetrize(g: ImmutableGraph) -> CSRGraph:
    """Union with the transpose (reference symmetrize, Transform.java:913-951)."""
    src, dst = _arcs_of(g)
    return CSRGraph.from_arcs(
        np.concatenate([src, dst]), np.concatenate([dst, src]), n=g.num_nodes(), dedup=True
    )


def symmetrize_offline(g: ImmutableGraph, batch_size: int = 1 << 20, temp_dir=None) -> CSRGraph:
    t = transpose_offline(g, batch_size, temp_dir)
    return union(g, t)


def simplify(g: ImmutableGraph) -> CSRGraph:
    """Symmetrize and strip loops (reference simplify, Transform.java:840-899)."""
    src, dst = _arcs_of(g)
    s = np.concatenate([src, dst])
    t = np.concatenate([dst, src])
    keep = s != t
    return CSRGraph.from_arcs(s[keep], t[keep], n=g.num_nodes(), dedup=True)


def simplify_offline(g: ImmutableGraph, batch_size: int = 1 << 20, temp_dir=None) -> CSRGraph:
    t = transpose_offline(g, batch_size, temp_dir)
    u = union(g, t)
    return filter_arcs(u, NO_LOOPS)


def remove_dangling(g: ImmutableGraph) -> CSRGraph:
    """Remove nodes with zero outdegree, remapping ids (reference
    Transform.main removeDangling)."""
    offsets, _ = g.to_csr()
    keep = np.diff(offsets) > 0
    perm = np.full(g.num_nodes(), -1, dtype=np.int64)
    perm[keep] = np.arange(int(keep.sum()))
    return map_graph(g, perm)


# ----------------------------------------------------------------------
# Node mapping / permutation
# ----------------------------------------------------------------------


def map_graph(g: ImmutableGraph, perm: np.ndarray) -> CSRGraph:
    """Renumber/contract/delete nodes: node x becomes perm[x]; -1 deletes
    (reference map, Transform.java:654-723)."""
    perm = np.asarray(perm, dtype=np.int64)
    src, dst = _arcs_of(g)
    ps, pd = perm[src], perm[dst]
    keep = (ps >= 0) & (pd >= 0)
    new_n = int(perm.max() + 1) if len(perm) and perm.max() >= 0 else 0
    return CSRGraph.from_arcs(ps[keep], pd[keep], n=new_n, dedup=True)


def map_offline(g: ImmutableGraph, perm: np.ndarray, batch_size: int = 1 << 20, temp_dir=None) -> CSRGraph:
    """Batch variant of map: mapped arcs are spilled as sorted batches and
    k-way merged, so peak memory is bounded by ``batch_size`` + the result
    (reference mapOffline, Transform.java:1510-1539)."""
    perm = np.asarray(perm, dtype=np.int64)
    new_n = int(perm.max() + 1) if len(perm) and perm.max() >= 0 else 0
    spiller = _BatchSpiller(batch_size, temp_dir, "wgt_map_")
    it = g.node_iterator()
    while it.has_next():
        x = it.next_int()
        px = perm[x]
        if px < 0:
            continue
        succ = np.asarray(it.successor_array()[: it.outdegree()], dtype=np.int64)
        ps = perm[succ]
        ps = ps[ps >= 0]
        spiller.add(np.full(len(ps), px, dtype=np.int64), ps)
    spiller.spill()
    if not spiller.files:
        return CSRGraph.from_lists([[] for _ in range(new_n)])
    return CSRGraph(*BatchGraph(new_n, spiller.files).to_csr())


def union(g1: ImmutableGraph, g2: ImmutableGraph) -> CSRGraph:
    """Arc-set union (reference union / UnionImmutableGraph,
    Transform.java:1986-1999)."""
    s1, d1 = _arcs_of(g1)
    s2, d2 = _arcs_of(g2)
    n = max(g1.num_nodes(), g2.num_nodes())
    return CSRGraph.from_arcs(np.concatenate([s1, s2]), np.concatenate([d1, d2]), n=n, dedup=True)


def compose(g1: ImmutableGraph, g2: ImmutableGraph) -> CSRGraph:
    """Graph composition: arc x->z iff exists y with x->y in g1 and y->z in
    g2 (reference compose / ComposedGraph, Transform.java:2006-2125)."""
    o1, s1 = g1.to_csr()
    o2, s2 = g2.to_csr()
    n = max(g1.num_nodes(), g2.num_nodes())
    d2 = np.diff(o2)
    src1 = np.repeat(np.arange(g1.num_nodes(), dtype=np.int64), np.diff(o1))
    mid = s1.astype(np.int64)
    in_range = mid < g2.num_nodes()
    src1, mid = src1[in_range], mid[in_range]
    counts = d2[mid]
    total = int(counts.sum())
    if total == 0:
        return CSRGraph.from_lists([[] for _ in range(n)])
    xs = np.repeat(src1, counts)
    seg = np.repeat(np.arange(len(mid)), counts)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - base[seg]
    zs = s2[o2[mid][seg] + within]
    return CSRGraph.from_arcs(xs, zs, n=n, dedup=True)


def line_graph(g: ImmutableGraph) -> tuple[CSRGraph, np.ndarray]:
    """The line graph: one node per arc (x,y); arc (x,y)->(y,z) for every
    arc y->z (reference line, Transform.java:2285). Returns the line graph
    and the arc list mapping line-nodes to original arcs."""
    offsets, succ = g.to_csr()
    n = g.num_nodes()
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    arcs = np.stack([src, succ.astype(np.int64)], axis=1)
    m = len(src)
    d = np.diff(offsets)
    # line-node i = arc (src[i], succ[i]); successors = arcs leaving succ[i]
    counts = d[succ]
    total = int(counts.sum())
    if total == 0:
        return CSRGraph.from_lists([[] for _ in range(m)]), arcs
    seg = np.repeat(np.arange(m), counts)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - base[seg]
    targets = offsets[succ.astype(np.int64)][seg] + within  # index of target arc
    return CSRGraph.from_arcs(seg, targets, n=m, sort=False), arcs


# ----------------------------------------------------------------------
# Compression-friendly permutations (reference Transform.java:2383-2547)
# ----------------------------------------------------------------------


def _colwise_permutation(offsets, succ, n, *, gray: bool, primary=None) -> np.ndarray:
    """Key-based adjacency-row ordering shared by the Gray/lex permutations.

    Column-by-column group refinement (each pass one vectorized lexsort):
    within a group of rows with identical prefixes, position k compares with
    a fixed direction — Gray order flips direction with the prefix parity,
    which inside such a group is simply k's parity; lexicographic order is
    always larger-first with exhausted rows first.  This replaces the
    per-pair comparator sorts (which could not scale past toy graphs) with
    O(max-tied-prefix) vector passes — the TPU-era analog of the
    reference's key-sort permutations (Transform.java:2383-2547)."""
    lengths = np.diff(offsets).astype(np.int64)
    INF = np.int64(1) << 62
    if primary is None:
        order = np.arange(n, dtype=np.int64)
        groups = np.zeros(n, dtype=np.int64)
    else:
        primary = np.asarray(primary, dtype=np.int64)
        order = np.argsort(primary, kind="stable")
        p = primary[order]
        groups = np.cumsum(np.concatenate([[False], p[1:] != p[:-1]]))
    max_d = int(lengths.max()) if n else 0
    for k in range(max_d):
        has = lengths[order] > k
        a = np.full(n, -1, dtype=np.int64)
        a[has] = succ[offsets[order[has]] + k]
        if gray and (k & 1):
            key = np.where(a >= 0, a, INF)       # ascending, exhausted last
        else:
            key = np.where(a >= 0, -a, -INF)     # descending, exhausted first
        idx = np.lexsort((key, groups))
        order = order[idx]
        gk = groups[idx]
        kk = key[idx]
        groups = np.cumsum(
            np.concatenate([[False], (gk[1:] != gk[:-1]) | (kk[1:] != kk[:-1])]))
        counts = np.bincount(groups, minlength=int(groups[-1]) + 1 if n else 0)
        multi = counts[groups] > 1
        if not multi.any() or not (lengths[order][multi] > k + 1).any():
            break
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n, dtype=np.int64)
    return perm


def gray_code_permutation(g: ImmutableGraph) -> np.ndarray:
    """Permutation ordering adjacency rows by Gray-code order
    (reference grayCodePermutation, Transform.java:2383-2428)."""
    offsets, succ = g.to_csr()
    return _colwise_permutation(offsets, succ, g.num_nodes(), gray=True)


def host_by_host_gray_code_permutation(g: ImmutableGraph, host_map: np.ndarray, strict: bool) -> np.ndarray:
    """Gray-code permutation computed host by host (reference
    hostByHostGrayCodePermutation, Transform.java:2455-2495); ``strict``
    compares only same-host successors."""
    offsets, succ = g.to_csr()
    host_map = np.asarray(host_map)
    n = g.num_nodes()
    if strict and n:
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
        keep = host_map[succ] == host_map[src]
        fsucc = succ[keep]
        flens = np.bincount(src[keep], minlength=n)
        offsets = np.concatenate([[0], np.cumsum(flens)]).astype(np.int64)
        succ = fsucc
    return _colwise_permutation(offsets, succ, n, gray=True, primary=host_map)


def lexicographical_permutation(g: ImmutableGraph) -> np.ndarray:
    """Permutation ordering adjacency rows lexicographically, columns
    numbered from zero FROM THE LEFT (reference lexicographicalPermutation,
    Transform.java:2518-2547)."""
    offsets, succ = g.to_csr()
    return _colwise_permutation(offsets, succ, g.num_nodes(), gray=False)


def random_permutation(g: ImmutableGraph, seed: int = 0) -> np.ndarray:
    """Random node permutation with the framework's seeded RNG
    (reference randomPermutation, Transform.java:2436)."""
    rng = XoRoShiRo128PlusRandom(seed)
    arr = list(range(g.num_nodes()))
    rng.shuffle(arr)
    return np.asarray(arr, dtype=np.int64)
