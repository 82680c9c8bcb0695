"""HyperBall — approximate neighbourhood function, reachable-set sizes and
geometric/discounted centralities (reference analog: HyperBall.java:222,
1493 LoC).

Algorithm: per-node HyperLogLog counters; at iteration t every node takes
the register-wise max of its counter with its successors' counters, so the
counter of x estimates |B(x, t)|.  Per-iteration increments of the ball
sizes accumulate the neighbourhood function, the sum of distances
(closeness), the sum of inverse distances (harmonic) and arbitrary
discounted centralities (reference doc: HyperBall.java:80-216).

Decomposition mapping (reference -> here):
* arc-balanced thread chunks (EliasFanoCumulativeOutdegreeList.skipTo,
  :849-873)        -> whole-graph segmented ``maximum.reduceat`` (host) /
                      segment-max gathers (device);
* broadword register max (:901-930)  -> row-wise vector max;
* systolic mode (:981-991): when few counters changed, only nodes with a
  modified successor are recomputed, found through the transpose — here a
  boolean frontier mask + transpose gather;
* double-buffered register arrays (:1239-1255) -> functional old/new arrays.

A scalar ``SequentialHyperBall`` twin (tests/) asserts exact register
equality with this implementation after every iteration, mirroring
HyperBallTest.java:47-54.
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.algo.hll import HyperLogLogCounterArray, _estimate
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph


class HyperBall:
    def __init__(
        self,
        graph: ImmutableGraph,
        transpose: ImmutableGraph | None = None,
        log2m: int = 6,
        seed: int = 0,
        weights: np.ndarray | None = None,
        do_sum_of_distances: bool = False,
        do_sum_of_inverse_distances: bool = False,
        discount_functions: list | None = None,
        systolic_threshold: float = 0.25,
        external_dir=None,
        chunk_nodes: int = 1 << 16,
    ):
        """``external_dir`` enables EXTERNAL mode (reference external update
        lists, HyperBall.java:192-195, 996-1012): the double-buffered
        register arrays live in memory-mapped files under that directory and
        each iteration streams candidate nodes in ``chunk_nodes`` chunks, so
        resident memory is bounded by one chunk's gather instead of 2·n·m
        registers."""
        self.graph = CSRGraph.from_graph(graph)
        self.transpose = CSRGraph.from_graph(transpose) if transpose is not None else None
        self.n = graph.num_nodes()
        self.external_dir = external_dir
        self.chunk_nodes = int(chunk_nodes)
        self.log2m = log2m
        self.seed = seed
        self.weights = weights
        self.do_sum_of_distances = do_sum_of_distances
        self.do_sum_of_inverse_distances = do_sum_of_inverse_distances
        self.discount_functions = discount_functions or []
        self.systolic_threshold = systolic_threshold
        self.counters = HyperLogLogCounterArray(self.n, log2m, seed)
        if external_dir is not None:
            self._externalize()
        self.iteration = 0
        self.modified = np.ones(self.n, dtype=bool)
        self.neighbourhood_function: list[float] = []
        self.sum_of_distances = np.zeros(self.n) if do_sum_of_distances else None
        self.sum_of_inverse_distances = np.zeros(self.n) if do_sum_of_inverse_distances else None
        self.discounted_centralities = [np.zeros(self.n) for _ in self.discount_functions]
        self._current = self.counters.counts()
        w = weights if weights is not None else np.ones(self.n)
        self.neighbourhood_function.append(float((self._current * w).sum()))
        self.last_systolic = False

    def init(self, seed: int | None = None) -> None:
        """Reset the computation (reference: init, HyperBall.java:639)."""
        if seed is not None:
            self.seed = seed
        self.counters = HyperLogLogCounterArray(self.n, self.log2m, self.seed)
        self.iteration = 0
        self.modified = np.ones(self.n, dtype=bool)
        self.neighbourhood_function = []
        self._current = self.counters.counts()
        w = self.weights if self.weights is not None else np.ones(self.n)
        self.neighbourhood_function.append(float((self._current * w).sum()))
        if self.sum_of_distances is not None:
            self.sum_of_distances.fill(0)
        if self.sum_of_inverse_distances is not None:
            self.sum_of_inverse_distances.fill(0)
        for c in self.discounted_centralities:
            c.fill(0)

    def _candidates(self) -> np.ndarray | None:
        """Nodes whose counter can change this iteration (systolic mode):
        predecessors of modified nodes, via the transpose."""
        frac = self.modified.sum() / max(self.n, 1)
        if self.transpose is None or frac >= self.systolic_threshold:
            self.last_systolic = False
            return None
        self.last_systolic = True
        toff, tsucc = self.transpose.to_csr()
        mod_nodes = np.flatnonzero(self.modified)
        counts = (toff[mod_nodes + 1] - toff[mod_nodes]).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, dtype=np.int64)
        seg = np.repeat(np.arange(len(mod_nodes)), counts)
        base = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(total) - base[seg]
        preds = tsucc[toff[mod_nodes][seg] + within].astype(np.int64)
        return np.unique(preds)

    def _externalize(self) -> None:
        """Move the double-buffered register arrays to memory-mapped files
        (reference external mode: registers stream through disk so resident
        memory is bounded, HyperBall.java:996-1012, 1206-1238)."""
        import os

        os.makedirs(self.external_dir, exist_ok=True)
        shape = self.counters.registers.shape
        self._ext_files = [os.path.join(self.external_dir, f"regs{i}.bin")
                           for i in (0, 1)]
        mm = np.memmap(self._ext_files[0], dtype=np.uint8, mode="w+", shape=shape)
        mm[:] = self.counters.registers
        mm.flush()
        self.counters.registers = mm
        self._ext_which = 0

    def iterate(self) -> None:
        """One ball-growing step (reference: iterate, HyperBall.java:1102)."""
        if self.external_dir is not None:
            self._iterate_external()
            return
        offsets, succ = self.graph.to_csr()
        regs = self.counters.registers
        cand = self._candidates()
        if cand is None:
            cand = np.arange(self.n, dtype=np.int64)
        new_regs = regs.copy()
        if len(cand):
            counts = (offsets[cand + 1] - offsets[cand]).astype(np.int64)
            nz = counts > 0
            nodes = cand[nz]
            cnt = counts[nz]
            if len(nodes):
                starts = offsets[nodes]
                total = int(cnt.sum())
                seg = np.repeat(np.arange(len(nodes)), cnt)
                base = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                within = np.arange(total) - base[seg]
                arcs = succ[starts[seg] + within].astype(np.int64)
                gathered = regs[arcs]  # (total, m)
                # segmented max by source node
                red = np.maximum.reduceat(gathered, base, axis=0)
                new_regs[nodes] = np.maximum(new_regs[nodes], red)
        changed_rows = np.any(new_regs != regs, axis=1)
        self.counters.registers = new_regs
        self.modified = changed_rows
        self.iteration += 1
        t = self.iteration
        new_counts = self.counters.counts()
        inc = new_counts - self._current
        if self.sum_of_distances is not None:
            self.sum_of_distances += t * inc
        if self.sum_of_inverse_distances is not None:
            self.sum_of_inverse_distances += inc / t
        for fn, acc in zip(self.discount_functions, self.discounted_centralities):
            acc += fn(t) * inc
        self._current = new_counts
        w = self.weights if self.weights is not None else np.ones(self.n)
        self.neighbourhood_function.append(float((new_counts * w).sum()))

    def _iterate_external(self) -> None:
        """External-mode iteration: candidates stream in node chunks, the
        result registers land in the other memory-mapped buffer, and the
        buffers swap — byte-identical registers to the in-memory step."""
        import shutil

        offsets, succ = self.graph.to_csr()
        regs = self.counters.registers
        cand = self._candidates()
        if cand is None:
            cand = np.arange(self.n, dtype=np.int64)
        other = self._ext_files[1 - self._ext_which]
        regs.flush()
        shutil.copyfile(self._ext_files[self._ext_which], other)
        new_regs = np.memmap(other, dtype=np.uint8, mode="r+", shape=regs.shape)
        changed = np.zeros(self.n, dtype=bool)
        for c0 in range(0, len(cand), self.chunk_nodes):
            nodes = cand[c0 : c0 + self.chunk_nodes]
            counts = (offsets[nodes + 1] - offsets[nodes]).astype(np.int64)
            nz = counts > 0
            nodes = nodes[nz]
            cnt = counts[nz]
            if not len(nodes):
                continue
            starts = offsets[nodes]
            total = int(cnt.sum())
            seg = np.repeat(np.arange(len(nodes)), cnt)
            base = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            within = np.arange(total) - base[seg]
            arcs = succ[starts[seg] + within].astype(np.int64)
            gathered = regs[arcs]
            red = np.maximum.reduceat(gathered, base, axis=0)
            old = np.asarray(regs[nodes])
            upd = np.maximum(old, red)
            ch = np.any(upd != old, axis=1)
            new_regs[nodes[ch]] = upd[ch]
            changed[nodes[ch]] = True
        new_regs.flush()
        self.counters.registers = new_regs
        self._ext_which = 1 - self._ext_which
        self.modified = changed
        self.iteration += 1
        t = self.iteration
        new_counts = self.counters.counts()
        inc = new_counts - self._current
        if self.sum_of_distances is not None:
            self.sum_of_distances += t * inc
        if self.sum_of_inverse_distances is not None:
            self.sum_of_inverse_distances += inc / t
        for fn, acc in zip(self.discount_functions, self.discounted_centralities):
            acc += fn(t) * inc
        self._current = new_counts
        w = self.weights if self.weights is not None else np.ones(self.n)
        self.neighbourhood_function.append(float((new_counts * w).sum()))

    def modified_counters(self) -> int:
        return int(self.modified.sum())

    def run(self, upper_bound: int = 2**31 - 1, threshold: float = -1.0, pl=None) -> list[float]:
        """Iterate until no counter changes, the relative increment of the
        neighbourhood function falls below ``threshold``, or ``upper_bound``
        iterations (reference: run, HyperBall.java:1295-1350)."""
        upper_bound = min(upper_bound, self.n)
        if pl is not None:
            pl.items_name = "iterations"
            pl.start("hyperball")
        for _ in range(upper_bound):
            self.iterate()
            if pl is not None:
                pl.update()
            if self.modified_counters() == 0:
                break
            if threshold >= 0 and len(self.neighbourhood_function) >= 2:
                prev, curr = self.neighbourhood_function[-2], self.neighbourhood_function[-1]
                if prev != 0 and (curr - prev) / prev < threshold:
                    break
        if pl is not None:
            pl.done()
        return self.neighbourhood_function

    # -- checkpoint / resume ---------------------------------------------
    # The reference has no mid-computation checkpointing (SURVEY §5.4): its
    # restartability is artifact-per-stage.  Here the whole HyperBall state
    # is a handful of arrays, so a checkpoint is a single .npz; a restarted
    # run continues exactly (same registers -> same estimates).

    def checkpoint(self, path) -> None:
        """Persist the complete iteration state to ``path`` (.npz)."""
        np.savez_compressed(
            path,
            registers=self.counters.registers,
            iteration=np.int64(self.iteration),
            modified=self.modified,
            neighbourhood_function=np.asarray(self.neighbourhood_function, dtype=np.float64),
            current=self._current,
            log2m=np.int64(self.log2m),
            seed=np.int64(self.seed),
            sum_of_distances=(
                self.sum_of_distances if self.sum_of_distances is not None else np.zeros(0)
            ),
            sum_of_inverse_distances=(
                self.sum_of_inverse_distances
                if self.sum_of_inverse_distances is not None
                else np.zeros(0)
            ),
            discounted=np.stack(self.discounted_centralities)
            if self.discounted_centralities
            else np.zeros((0, self.n)),
        )

    def restore(self, path) -> None:
        """Resume from a checkpoint written by :meth:`checkpoint` (the graph
        and configuration must match)."""
        with np.load(path) as z:
            if int(z["log2m"]) != self.log2m:
                raise ValueError("checkpoint log2m mismatch")
            if z["registers"].shape != self.counters.registers.shape:
                raise ValueError("checkpoint register shape mismatch")
            self.seed = int(z["seed"])
            self.counters.registers = z["registers"].copy()
            self.iteration = int(z["iteration"])
            self.modified = z["modified"].copy()
            self.neighbourhood_function = [float(v) for v in z["neighbourhood_function"]]
            self._current = z["current"].copy()
            if self.sum_of_distances is not None and len(z["sum_of_distances"]):
                self.sum_of_distances = z["sum_of_distances"].copy()
            if self.sum_of_inverse_distances is not None and len(z["sum_of_inverse_distances"]):
                self.sum_of_inverse_distances = z["sum_of_inverse_distances"].copy()
            if self.discounted_centralities and len(z["discounted"]):
                self.discounted_centralities = [row.copy() for row in z["discounted"]]

    # -- derived outputs ------------------------------------------------

    def closeness_centrality(self) -> np.ndarray:
        if self.sum_of_distances is None:
            raise RuntimeError("run with do_sum_of_distances=True")
        with np.errstate(divide="ignore"):
            c = 1.0 / self.sum_of_distances
        c[~np.isfinite(c)] = 0.0
        return c

    def harmonic_centrality(self) -> np.ndarray:
        if self.sum_of_inverse_distances is None:
            raise RuntimeError("run with do_sum_of_inverse_distances=True")
        return self.sum_of_inverse_distances.copy()

    def reachable_nodes(self) -> np.ndarray:
        """Per-node reachable-set size estimates (the final ball sizes)."""
        return self._current.copy()
