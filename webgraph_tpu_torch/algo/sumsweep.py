"""SumSweep exact diameter/radius/eccentricities (reference analogs:
SumSweepDirectedDiameterRadius.java:137 and
SumSweepUndirectedDiameterRadius.java:115; Borassi, Crescenzi, Habib,
Kosters, Marino, Takes: "Fast diameter and radius BFS-based computation").

Bound-refinement over forward/backward BFS sweeps: each pivot s yields the
exact eccF(s)/eccB(s), raises the lower bounds L_F(x) >= d(x,s),
L_B(x) >= d(s,x) for every x, and caps U_F(x) <= d(x,s) + eccF(s),
U_B(x) <= d(s,x) + eccB(s); pivots are chosen to close the diameter/radius
gaps fastest, and the result is exact on termination (worst case every node
is swept).

Eccentricities are over *reachable* nodes; on strongly connected (or
connected undirected) graphs this is the classical definition.
"""

from __future__ import annotations

import enum

import numpy as np

from webgraph_tpu_torch.algo.bfs import bfs_distances
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph
from webgraph_tpu_torch.transform.transform import transpose as transpose_graph


class OutputLevel(enum.Enum):
    """Reference analog: SumSweepDirectedDiameterRadius.OutputLevel (:245)."""

    RADIUS = 0
    DIAMETER = 1
    RADIUS_DIAMETER = 2
    ALL_FORWARD = 3
    ALL = 4


class SumSweepDirectedDiameterRadius:
    def __init__(
        self,
        graph: ImmutableGraph,
        output: OutputLevel = OutputLevel.RADIUS_DIAMETER,
        transpose: ImmutableGraph | None = None,
        use_device: bool = False,
        device="cuda",
    ):
        self.graph = CSRGraph.from_graph(graph)
        self.transpose = CSRGraph.from_graph(transpose) if transpose is not None else transpose_graph(graph)
        self.output = output
        self.n = graph.num_nodes()
        self.iterations = 0
        self._done = False
        # device sweeps: every forward/backward BFS runs on the torch
        # ``device`` (level-synchronous pull, algo/device.py), the
        # counterpart of the reference's threaded sweeps
        # (SumSweepDirectedDiameterRadius.java:1037)
        self._dev = None
        if use_device:
            from webgraph_tpu_torch.algo.device import DeviceCSR

            fwd = DeviceCSR.from_graph(self.graph, device)
            self._dev = (fwd, fwd.reversed())

    def _bfs(self, g, v):
        if self._dev is not None:
            import numpy as _np

            from webgraph_tpu_torch.algo.device import bfs_distances as _dbfs

            csr = self._dev[0] if g is self.graph else self._dev[1]
            return _dbfs(csr, int(v)).cpu().numpy().astype(_np.int64)
        return bfs_distances(g, v)

    # -- SCC-DAG upper-bound machinery (the reference's core technique:
    # SumSweepDirectedDiameterRadius.java computeUB / allCCUpperBound;
    # Borassi et al. Algorithm 3) -------------------------------------

    def _scc_prepare(self) -> None:
        """Condensation + per-SCC pivots + SCC-restricted pivot distances +
        DAG DP bounds.  One-time cost O(n + m): every intra-SCC arc is
        relaxed once per restricted-BFS level, every boundary arc enters the
        DP once per direction."""
        from webgraph_tpu_torch.algo.components import StronglyConnectedComponents

        n = self.n
        offsets, succ = self.graph.to_csr()
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
        dst = succ.astype(np.int64)
        comp = StronglyConnectedComponents.compute(self.graph).component.astype(np.int64)
        nc = int(comp.max()) + 1 if n else 0
        self._comp = comp
        intra = comp[src] == comp[dst]
        isrc, idst = src[intra], dst[intra]
        bsrc, bdst = src[~intra], dst[~intra]

        # pivot of each SCC: its lowest-numbered node
        pivot_of = np.full(nc, n, dtype=np.int64)
        np.minimum.at(pivot_of, comp, np.arange(n, dtype=np.int64))
        self._pivot_of = pivot_of

        def restricted(es, ed):
            """Multi-source BFS from every SCC's pivot, restricted to
            intra-SCC arcs: d(p_C, x) for all x (or x -> p_C on reversed)."""
            dist = np.full(n, -1, dtype=np.int64)
            dist[pivot_of] = 0
            r = 0
            while True:
                active = (dist[es] == r) & (dist[ed] < 0)
                if not active.any():
                    break
                dist[ed[active]] = r + 1
                r += 1
            return dist

        dF_in = restricted(isrc, idst)        # d_C(p_C, x)
        dB_in = restricted(idst, isrc)        # d_C(x, p_C)
        self._dF_in, self._dB_in = dF_in, dB_in

        # topological levels of the condensation (longest path from sources);
        # fixpoint over DEDUPED dag edges converges in DAG-depth rounds
        lvl = np.zeros(nc, dtype=np.int64)
        cs, cd = comp[bsrc], comp[bdst]
        if len(cs):
            uniq = np.unique(cs * nc + cd)
            ucs, ucd = uniq // nc, uniq % nc
            for _ in range(nc):
                before = lvl.copy()
                np.maximum.at(lvl, ucd, lvl[ucs] + 1)
                if np.array_equal(before, lvl):
                    break
        self._lvl = lvl

        # pivot ecc inside its SCC
        eF_in = np.zeros(nc, dtype=np.int64)
        np.maximum.at(eF_in, comp, dF_in)
        eB_in = np.zeros(nc, dtype=np.int64)
        np.maximum.at(eB_in, comp, dB_in)

        # DP over the DAG, level-vectorized: every DAG arc c->d has
        # lvl[d] > lvl[c], so processing source levels in descending order
        # (forward bounds) / target levels ascending (backward bounds)
        # finalizes each pivot bound exactly once
        UFp = eF_in.copy()
        UBp = eB_in.copy()
        if len(bsrc):
            base = dF_in[bsrc] + 1 + dB_in[bdst]
            src_lvl = lvl[cs]
            for lev in np.unique(src_lvl)[::-1]:
                sel = src_lvl == lev
                np.maximum.at(UFp, cs[sel], base[sel] + UFp[cd[sel]])
            dst_lvl = lvl[cd]
            for lev in np.unique(dst_lvl):
                sel = dst_lvl == lev
                np.maximum.at(UBp, cd[sel], base[sel] + UBp[cs[sel]])
        # per-node bounds: go through the own pivot
        self._uF_scc = dB_in + UFp[comp] if n else np.zeros(0, dtype=np.int64)
        self._uB_scc = dF_in + UBp[comp] if n else np.zeros(0, dtype=np.int64)

        # radial vertices (reference computeAccRadial,
        # SumSweepDirectedDiameterRadius.java:597-600): in the biggest SCC
        # or able to reach it — the radius is taken over these only
        sizes = np.bincount(comp, minlength=nc)
        big = int(np.argmax(sizes)) if nc else 0
        if n:
            bs = bfs_distances(self.transpose, int(pivot_of[big]))
            self._acc_radial = bs >= 0
        else:
            self._acc_radial = np.zeros(0, dtype=bool)

    def compute(self) -> None:
        n = self.n
        INF = np.int64(2**31)
        lF = np.zeros(n, dtype=np.int64)
        uF = np.full(n, INF, dtype=np.int64)
        lB = np.zeros(n, dtype=np.int64)
        uB = np.full(n, INF, dtype=np.int64)
        eccF = np.full(n, -1, dtype=np.int64)
        eccB = np.full(n, -1, dtype=np.int64)
        swept = np.zeros(n, dtype=bool)
        if n == 0:
            self._eccF = lF
            self._eccB = lB
            self._diameter = 0
            self._radius = 0
            self._done = True
            return

        self._scc_prepare()
        np.minimum(uF, self._uF_scc, out=uF)
        np.minimum(uB, self._uB_scc, out=uB)
        comp = self._comp
        dF_in, dB_in = self._dF_in, self._dB_in

        offsets, _ = self.graph.to_csr()
        pivot = int(np.argmax(np.diff(offsets)))
        want_all = self.output in (OutputLevel.ALL, OutputLevel.ALL_FORWARD)

        def sweep(v: int) -> None:
            """Forward+backward BFS from v: exact eccs of v, lower bounds
            everywhere, upper bounds for v's SCC (d(x,v) <= d_C(x,p)+d_C(p,v),
            Reach(x) = Reach(v) within an SCC) and globally when v reaches
            (or is reached by) everything."""
            fs = self._bfs(self.graph, v)
            bs = self._bfs(self.transpose, v)
            self.iterations += 2
            swept[v] = True
            reachF = fs >= 0
            reachB = bs >= 0
            eF = int(fs.max())
            eB = int(bs.max())
            eccF[v] = eF
            uF[v] = lF[v] = eF
            eccB[v] = eB
            uB[v] = lB[v] = eB
            np.maximum(lF, np.where(reachB, bs, 0), out=lF)
            np.maximum(lB, np.where(reachF, fs, 0), out=lB)
            same = comp == comp[v]
            dxv = dB_in + dF_in[v]   # d(x, v) bound inside the SCC
            np.minimum(uF, np.where(same, dxv + eF, INF), out=uF)
            dvx = dF_in + dB_in[v]
            np.minimum(uB, np.where(same, dvx + eB, INF), out=uB)
            if bool(reachF.all()):
                np.minimum(uF, np.where(reachB, bs + eF, uF), out=uF)
            if bool(reachB.all()):
                np.minimum(uB, np.where(reachF, fs + eB, uB), out=uB)

        for it in range(2 * n + 2):
            if swept[pivot]:
                remaining = np.flatnonzero(~swept)
                if len(remaining) == 0:
                    break
                pivot = int(remaining[0])
            sweep(pivot)
            exactF = lF >= uF
            exactB = lB >= uB
            eccF[exactF] = np.maximum(eccF[exactF], lF[exactF])
            eccB[exactB] = np.maximum(eccB[exactB], lB[exactB])

            dl = int(max(lF.max(initial=0), lB.max(initial=0)))
            du = int(uF.max(initial=0))
            radial = self._acc_radial
            rad_exact = exactF & radial
            ru = int(np.where(radial, lF, INF).min()) if radial.any() else 0
            diam_done = dl >= du
            rad_done = (bool(lF[rad_exact].min(initial=INF) <= ru)
                        if rad_exact.any() else not radial.any())
            if want_all:
                if np.all(exactF) and (self.output != OutputLevel.ALL or np.all(exactB)):
                    break
            elif self.output == OutputLevel.DIAMETER and diam_done:
                break
            elif self.output == OutputLevel.RADIUS and rad_done:
                break
            elif self.output == OutputLevel.RADIUS_DIAMETER and diam_done and rad_done:
                break
            # next pivot (reference StepSweep policy): work only on the
            # still-open certification goal — largest upper bound / largest
            # gap for the diameter, smallest radial lower bound for the
            # radius (certifying that candidate exactly and raising lF
            # everywhere through the backward half of the sweep)
            need_diam = (not diam_done) and self.output in (
                OutputLevel.DIAMETER, OutputLevel.RADIUS_DIAMETER)
            need_rad = (not rad_done) and self.output in (
                OutputLevel.RADIUS, OutputLevel.RADIUS_DIAMETER)
            if want_all:
                need_diam = need_rad = True
            rad_turn = need_rad and (not need_diam or it % 2 == 1)
            if rad_turn:
                if it % 4 == 3:
                    # witness sweep: a hard-to-reach peripheral node whose
                    # backward BFS raises lF for the central candidates
                    w = np.where(swept, -1, lB)
                    if (w >= 0).any():
                        pivot = int(np.argmax(w))
                        continue
                cand = np.where(swept | exactF | ~radial, INF, lF)
                if (cand < INF).any():
                    pivot = int(np.argmin(cand))
                    continue
            if it % 2 == 0:
                pivot = int(np.argmax(np.where(swept | exactF, -1, uF)))
            else:
                pivot = int(np.argmax(np.where(swept | exactF, -1, uF - lF)))

        # finalize remaining exact eccentricities if ALL requested
        if want_all:
            for x in np.flatnonzero(~(lF >= uF)):
                fs = self._bfs(self.graph, int(x))
                e = int(fs.max())
                eccF[x] = e
                uF[x] = lF[x] = e
                self.iterations += 1
            if self.output == OutputLevel.ALL:
                for x in np.flatnonzero(~(lB >= uB)):
                    bs = self._bfs(self.transpose, int(x))
                    e = int(bs.max())
                    eccB[x] = e
                    uB[x] = lB[x] = e
                    self.iterations += 1

        exactF = lF >= uF
        exactB = lB >= uB
        eccF[exactF] = np.maximum(eccF[exactF], lF[exactF])
        eccB[exactB] = np.maximum(eccB[exactB], lB[exactB])
        self._eccF = np.where(eccF >= 0, eccF, lF)
        self._eccB = np.where(eccB >= 0, eccB, lB)
        self._diameter = int(max(lF.max(initial=0), lB.max(initial=0)))
        rad_exact = exactF & self._acc_radial
        self._radius = (int(lF[rad_exact].min()) if rad_exact.any()
                        else (int(np.where(exactF, lF, INF).min()) if exactF.any() else 0))
        self._done = True

    def get_diameter(self) -> int:
        if not self._done:
            self.compute()
        return self._diameter

    def get_radius(self) -> int:
        if not self._done:
            self.compute()
        return self._radius

    def get_eccentricity(self, x: int, forward: bool = True) -> int:
        if not self._done:
            self.compute()
        return int(self._eccF[x] if forward else self._eccB[x])

    @property
    def eccentricities_forward(self) -> np.ndarray:
        if not self._done:
            self.compute()
        return self._eccF

    @property
    def eccentricities_backward(self) -> np.ndarray:
        if not self._done:
            self.compute()
        return self._eccB


class SumSweepUndirectedDiameterRadius(SumSweepDirectedDiameterRadius):
    """Undirected (symmetric) variant (reference
    SumSweepUndirectedDiameterRadius.java:115): the transpose is the graph
    itself."""

    def __init__(self, graph: ImmutableGraph, output: OutputLevel = OutputLevel.RADIUS_DIAMETER):
        super().__init__(graph, output, transpose=graph)
