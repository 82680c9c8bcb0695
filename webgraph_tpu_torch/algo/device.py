"""Graph analytics on a torch device: BFS, exact neighbourhood function,
geometric centralities, betweenness and eccentricities.

Counterpart of ``webgraph_tpu/algo/device.py``.  The reference parallelises
these with shared-memory threads (ParallelBreadthFirstVisit.java:79,
149-181 level-synchronous frontier BFS; NeighbourhoodFunction.java:100
parallel sweeps; GeometricCentralities.java:94-96 a BFS a source on a
thread pool; BetweennessCentrality.java:256 Brandes).  Here every step is
level-synchronous over a graph resident on the device:

* reachability (``bfs_distances``, ``nf64``, the NF and geometric
  batches): 64 sources a word, one bit a source in an int64 word (source
  ``i`` of a batch at bit ``i``), up to ``kernels.propagate.KMAX`` words
  a node (one a batch); a whole propagation, level after level, is one
  ``or_pull`` launch over the in-CSR (``kernels/propagate.py::propagate``,
  ``csrc/propagate.cu``);
* betweenness: batched Brandes in plain torch (gathers, ``index_add_``)
  with exact int64 path counts and float64 dependencies.

The JAX package keeps each loop inside one ``while_loop`` on the device,
and the batch loop inside the jit; the port runs a propagation's levels
inside one kernel launch, which stops on the device, and ``k`` batches in
one launch.  The host reads the level count and the counts once a launch
(a further launch only where a propagation outruns a launch's level
array, ``kernels.propagate.LEVELS``); :data:`host_reads` counts those
reads, and betweenness's one a level.

The JAX package keeps masks as ``uint32[n, 2]`` (source ``i`` at word
``i // 32``, bit ``i % 32``); :func:`masks_from_jax` and
:func:`masks_to_jax` convert.
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.algo.centralities import BetweennessCentrality
from webgraph_tpu_torch.kernels import propagate as _kernel
from webgraph_tpu_torch.kernels.propagate import propagate, pull_order
from webgraph_tpu_torch.transform.device import (arcs_of, graph_csr,
                                                 transpose_arcs_device)

# reads of a device value by the host loops, by the loop that made them
host_reads = {"bfs": 0, "nf": 0, "geometric": 0, "betweenness": 0}
GROUP = 4  # batches a launch in the NF and geometric batch runners

_BIT = torch.tensor([1], dtype=torch.int64) << torch.arange(64)
_LOW31 = 2**31 - 1


class DeviceCSR:
    """A graph resident on a torch device: the out-arcs ``src``/``dst``
    (int32[m], by source) and the in-CSR ``in_off`` (int64[n+1]) /
    ``in_src`` (int32[m]), the transpose, built on the device at
    construction (``transform/device.py::transpose_arcs_device``),
    ``pull``, the nodes by in-degree that ``or_pull`` maps to lanes
    (``kernels.propagate.pull_order``), and :attr:`out_pull`, the nodes by
    out-degree that ``hll_pull`` maps to lanes (made at first use)."""

    def __init__(self, offsets, succ, n: int | None = None, device="cuda"):
        self.device = torch.device(device)
        self.offsets = torch.as_tensor(offsets).to(self.device, torch.int64)
        succ = torch.as_tensor(succ).to(self.device, torch.int32)
        self.n = int(n if n is not None else self.offsets.numel() - 1)
        self.m = int(succ.numel())
        self.src, self.dst = arcs_of(self.offsets, succ)
        self.in_off, self.in_src, _ = transpose_arcs_device(
            self.src, self.dst, self.n)
        self.pull = pull_order(self.in_off)
        self._out_pull = None

    @property
    def out_pull(self):
        """:func:`kernels.propagate.pull_order` of the out-CSR: the nodes
        by out-degree and their out-arc ranges in ``dst``, for a pull over
        the successors (HyperBall's register max); one sort, at first
        use."""
        if self._out_pull is None:
            self._out_pull = pull_order(self.offsets)
        return self._out_pull

    @classmethod
    def from_graph(cls, g, device="cuda"):
        """The graph ``g`` on ``device``: a ``BVGraph`` that a kernel
        decodes is decoded there, any other graph copied from its
        ``to_csr()`` (``transform/device.py::graph_csr``)."""
        off, succ = graph_csr(g, device)
        return cls(off, succ, g.num_nodes(), device)

    def reversed(self) -> "DeviceCSR":
        """The transpose of this graph, sharing its tensors: the in-CSR
        becomes the out-CSR and the out-CSR the in-CSR (no sort)."""
        t = object.__new__(DeviceCSR)
        t.device, t.n, t.m = self.device, self.n, self.m
        t.offsets, t.in_off, t.in_src = self.in_off, self.offsets, self.dst
        t.src, t.dst = arcs_of(self.in_off, self.in_src)
        t.pull, t._out_pull = self.out_pull, self.pull
        return t


def masks_from_jax(masks: np.ndarray, device="cpu") -> torch.Tensor:
    """The JAX package's ``uint32[n, 2]`` masks as the port's int64[n]
    words (word 0 the low 32 bits)."""
    m = np.asarray(masks, dtype=np.uint32).astype(np.uint64)
    words = m[:, 0] | (m[:, 1] << np.uint64(32))
    return torch.from_numpy(words.view(np.int64).copy()).to(device)


def masks_to_jax(words: torch.Tensor) -> np.ndarray:
    """The port's int64[n] words as the JAX package's ``uint32[n, 2]``."""
    u = words.cpu().numpy().view(np.uint64)
    return np.stack([u & np.uint64(0xFFFFFFFF), u >> np.uint64(32)],
                    axis=1).astype(np.uint32)


def _sources(csr: DeviceCSR, sources) -> torch.Tensor:
    s = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    if s.ndim != 1:
        raise ValueError("sources must be an int or a 1-d list of node ids")
    if len(s) and (s.min() < 0 or s.max() >= csr.n):
        raise ValueError(f"sources must lie in [0, {csr.n})")
    return torch.from_numpy(s).to(csr.device)


def _batch_masks(csr: DeviceCSR, sources: torch.Tensor) -> torch.Tensor:
    """int64[n, 1] words with bit ``i`` set at node ``sources[i]`` (at most
    64 sources; a node named twice gets both bits)."""
    masks = torch.zeros(csr.n, dtype=torch.int64, device=csr.device)
    bits = _BIT[: sources.numel()].to(csr.device)
    return masks.index_put_((sources,), bits, accumulate=True).view(-1, 1)


def _propagate(loop: str, csr: DeviceCSR, words, cap: int, **kw):
    """``kernels.propagate.propagate`` over the graph's in-CSR, its host
    reads counted under ``loop``."""
    reads = _kernel.propagate.reads  # counted by the plain version too
    out = propagate(csr.in_off, csr.in_src, words, max_levels=cap,
                    order=csr.pull, **kw)
    host_reads[loop] += _kernel.propagate.reads - reads
    return out


def bfs_distances(csr: DeviceCSR, sources, max_levels: int | None = None):
    """Distances from ``sources`` (an int or a 1-d list): the minimum over
    the sources, one BFS from the set.  Returns int32[n] on the graph's
    device, -1 for unreachable.  Raises ValueError for a source outside
    ``[0, n)``.

    Level-synchronous (ParallelBreadthFirstVisit.java:149-181): one
    propagation of a one-bit word, which writes ``level + 1`` at each node
    it reaches; one ``or_pull`` launch and one host read (more only past
    ``kernels.propagate.LEVELS`` levels)."""
    s = _sources(csr, sources)
    cap = int(max_levels if max_levels is not None else csr.n)
    dist = torch.full((csr.n, 1), -1, dtype=torch.int32, device=csr.device)
    dist[s] = 0
    reached = torch.zeros(csr.n, 1, dtype=torch.int64, device=csr.device)
    reached[s] = 1
    _propagate("bfs", csr, reached, cap, dist=dist)
    return dist.view(-1)


def eccentricity(csr: DeviceCSR, source: int) -> int:
    """Eccentricity of ``source`` (its largest finite BFS distance)."""
    return int(bfs_distances(csr, source).max())


def _nf_rows(counts: np.ndarray, total0: int):
    """``(row, it)`` of one word's level counts (:func:`nf64`): ``row[t]``
    the pairs at distance <= t for t in 0..it, ``it`` the first level that
    reached nothing, plus one (all the levels when none did)."""
    zero = np.flatnonzero(counts == 0)
    it = int(zero[0]) + 1 if zero.size else len(counts)
    return np.concatenate([[total0], total0 + np.cumsum(counts[:it])]), it


def _nf_batch(csr: DeviceCSR, sources: torch.Tensor, cap: int):
    """Propagate one batch's words to convergence (or ``cap`` steps):
    ``(counts, masks, it)``, ``counts[t]`` the (source, node) pairs at
    distance <= t for t in 0..it, as the JAX loop counts them (its last
    step the one that reached nothing, unless ``cap`` stopped it)."""
    res = _propagate("nf", csr, _batch_masks(csr, sources), cap)
    row, it = _nf_rows(res.counts[:, 0].numpy(), sources.numel())
    return row.astype(np.int64), res.words.view(-1), it


def nf64(csr: DeviceCSR, sources, max_iters: int | None = None):
    """Bit-parallel BFS from up to 64 sources at once.

    Returns ``(counts int64[it + 1], masks int64[n], it)``: ``counts[t]``
    is the number of (source, node) pairs at distance <= t (the exact NF
    decomposition of NeighbourhoodFunction.java:100/118), ``masks`` the
    reach words on the graph's device, ``it`` the steps run.  The JAX
    package pads ``counts`` to ``cap + 1`` with its last value."""
    s = _sources(csr, sources)
    if s.numel() > 64:
        raise ValueError("nf64 takes at most 64 sources")
    cap = int(max_iters if max_iters is not None else csr.n)
    return _nf_batch(csr, s, cap)


def _group_words(csr: DeviceCSR, first: int, k: int) -> torch.Tensor:
    """int64[n, k]: word ``j`` holds batch ``first + j``'s sources, ``64 b
    .. 64 b + 63`` (those past the last node left out), source ``i`` of a
    batch at bit ``i``."""
    s = torch.arange(64 * first, min(64 * (first + k), csr.n),
                     device=csr.device)
    words = torch.zeros(csr.n, k, dtype=torch.int64, device=csr.device)
    rel = s - 64 * first
    words[s, rel // 64] = torch.ones_like(rel) << (rel % 64)
    return words


def _groups(start_batch: int, nbatch: int):
    """``(first, k)`` of each launch: ``nbatch`` batches, :data:`GROUP` a
    launch."""
    for first in range(start_batch, start_batch + nbatch, GROUP):
        yield first, min(GROUP, start_batch + nbatch - first)


def make_nf_batches(csr: DeviceCSR, cap: int):
    """``run(start_batch, nbatch) -> (counts int64[nbatch, deepest + 1],
    deepest)``: ``nbatch`` consecutive 64-source batches, each run to
    convergence, :data:`GROUP` of them a launch (a word each); each row
    padded with its last value to the deepest batch's steps (the JAX
    package pads every row to ``cap + 1``)."""

    def run(start_batch: int, nbatch: int):
        rows, deepest = [], 0
        for first, k in _groups(start_batch, nbatch):
            res = _propagate("nf", csr, _group_words(csr, first, k), cap)
            counts = res.counts.numpy()
            for j in range(k):
                total0 = min(64, max(0, csr.n - 64 * (first + j)))
                row, it = _nf_rows(counts[:, j], total0)
                rows.append(row)
                deepest = max(deepest, it)
        out = np.zeros((nbatch, deepest + 1), dtype=np.int64)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
            out[i, len(r):] = r[-1]
        return out, deepest

    return run


def neighbourhood_function_device(csr: DeviceCSR, max_iters: int | None = None,
                                  batches_per_dispatch: int = 64):
    """Exact NF by 64-source bit-parallel batches, ``batches_per_dispatch``
    of them a call of the batch runner (the device path of ``algo/nf.py``).
    Returns float64[t] cumulative pair counts, trimmed as the JAX package
    trims them."""
    n = csr.n
    cap = int(max_iters if max_iters is not None else n)
    nbatches = -(-n // 64)
    run = make_nf_batches(csr, cap)
    total = np.zeros(1, dtype=np.int64)
    for start in range(0, nbatches, batches_per_dispatch):
        k = min(batches_per_dispatch, nbatches - start)
        counts, _ = run(start, k)
        chunk = counts.sum(axis=0)
        width = max(len(total), len(chunk))
        total = np.concatenate([total, np.full(width - len(total), total[-1])])
        chunk = np.concatenate([chunk, np.full(width - len(chunk), chunk[-1])])
        total = total + chunk
    total = total.astype(np.float64)
    while len(total) > 1 and total[-1] == total[-2]:  # drop the no-change
        total = total[:-1]                            # convergence probe
    return total


def make_geometric_batches(csr: DeviceCSR, cap: int, alpha: float = 0.5):
    """``run(start_batch, nbatch) -> (reach, sumdist, sumrecip, sumexp)``,
    each of ``nbatch * 64`` slots on the graph's device, per source of 64
    consecutive sources a batch (GeometricCentralities.java:70/211 runs a
    BFS a node; here 64 a batch, bit-packed, :data:`GROUP` batches a
    launch)::

        reach[s]    = #{y != s : d(s, y) < inf}     int64
        sumdist[s]  = sum_y d(s, y)                 int64
        sumrecip[s] = sum_y 1 / d(s, y)             float64
        sumexp[s]   = sum_y alpha ** d(s, y)        float64

    from ``or_pull``'s per-bit counts of the nodes each source reaches at
    each distance."""
    dev = csr.device

    def run(start_batch: int, nbatch: int):
        acc = [torch.zeros(nbatch, 64, dtype=t, device=dev)
               for t in (torch.int64, torch.int64, torch.float64,
                         torch.float64)]
        reach, sumd, sumr, sume = acc
        for first, k in _groups(start_batch, nbatch):
            res = _propagate("geometric", csr, _group_words(csr, first, k),
                             cap, perbit=True)
            if not res.levels:
                continue
            cnew = res.bits  # [levels, k, 64]: nodes reached at distance
            d = torch.arange(1, res.levels + 1, device=dev)  # level + 1
            w = torch.tensor([float(alpha) ** t for t in range(1, res.levels
                                                               + 1)],
                             dtype=torch.float64, device=dev)
            rows = slice(first - start_batch, first - start_batch + k)
            reach[rows] += cnew.sum(dim=0)
            sumd[rows] += (cnew * d[:, None, None]).sum(dim=0)
            cf = cnew.to(torch.float64)
            sumr[rows] += (cf / d.to(torch.float64)[:, None, None]).sum(dim=0)
            sume[rows] += (cf * w[:, None, None]).sum(dim=0)
        return tuple(a.reshape(-1) for a in acc)

    return run


def geometric_centralities_device(csr: DeviceCSR, *, alpha: float = 0.5,
                                  max_iters: int | None = None,
                                  batches_per_dispatch: int = 64):
    """Closeness, harmonic, Lin, exponential and reachable counts for every
    node by 64-source batches (the device path of
    ``algo/centralities.GeometricCentralities``).  Returns ``(closeness,
    harmonic, lin, exponential, reachable)`` NumPy arrays, ``reachable``
    counting the source itself (the reference's convention)."""
    n = csr.n
    cap = int(max_iters if max_iters is not None else n)
    run = make_geometric_batches(csr, cap, alpha)
    nbatches = -(-n // 64)
    parts = [[], [], [], []]
    for start in range(0, nbatches, batches_per_dispatch):
        k = min(batches_per_dispatch, nbatches - start)
        for p, a in zip(parts, run(start, k)):
            p.append(a)
    reach, sumd, sumr, sume = (
        torch.cat(p).cpu().numpy()[:n] if p else np.zeros(0, dtype=dt)
        for p, dt in zip(parts, (np.int64, np.int64, np.float64, np.float64)))
    closeness = np.where(sumd > 0, 1.0 / np.where(sumd > 0, sumd, 1), 0.0)
    harmonic = sumr
    reachable = reach + 1  # reference convention: self counts
    lin = np.where(sumd > 0, reachable.astype(np.float64) ** 2
                   / np.where(sumd > 0, sumd, 1), 1.0)
    return closeness, harmonic, lin, sume, reachable


def make_betweenness_batches(csr: DeviceCSR, cap: int, batch: int = 16):
    """Batched Brandes (BetweennessCentrality.java:256; the reference farms
    a source a thread, :100): ``run(start_source) -> float64[n]``, the
    dependencies from sources ``[start_source, start_source + batch)`` on
    the graph's device.  Each source is a row of ``(batch, n)`` arrays: a
    forward BFS by levels that counts shortest paths exactly in int64, then
    the dependencies accumulated level by level backwards in float64.

    A path count past 2**62 raises the host path's
    ``BetweennessCentrality.PathCountOverflowException``.  The counts of a
    level are summed in two exact halves (the contributions' bits from 31
    up, and below 31), so a sum past int64 is seen, not wrapped."""
    n, dev = csr.n, csr.device
    src, dst = csr.src.long(), csr.dst.long()

    def run(start_source: int):
        sources = torch.arange(start_source, min(start_source + batch, n),
                               device=dev)
        rows = torch.arange(sources.numel(), device=dev)
        b = sources.numel()
        S, T = src.expand(b, -1), dst.expand(b, -1)  # (b, m) views

        def at(t, idx):  # t[:, idx] as one gather
            return torch.gather(t, 1, idx)

        dist = torch.full((b, n), -1, dtype=torch.int32, device=dev)
        dist[rows, sources] = 0
        sigma = torch.zeros((b, n), dtype=torch.int64, device=dev)
        sigma[rows, sources] = 1
        lev = 0
        while lev < cap:
            on = at(dist, S) == lev                              # (b, m)
            hit = torch.zeros((b, n), dtype=torch.int32, device=dev)
            hit.index_add_(1, dst, on.to(torch.int32))
            newf = (hit > 0) & (dist < 0)
            dist = torch.where(newf, lev + 1, dist)
            contrib = torch.where(on & at(newf, T), at(sigma, S), 0)
            hi = torch.zeros_like(sigma).index_add_(1, dst, contrib >> 31)
            lo = torch.zeros_like(sigma).index_add_(1, dst, contrib & _LOW31)
            hi += lo >> 31
            lo &= _LOW31
            over = (hi > 2**31) | ((hi == 2**31) & (lo > 0))
            sigma = torch.where(newf, (hi << 31) | lo, sigma)
            alive, overflow = torch.stack(
                [newf.sum(), (over & newf).any().to(torch.int64)]).tolist()
            host_reads["betweenness"] += 1
            if overflow:
                raise BetweennessCentrality.PathCountOverflowException(
                    f"path count overflow from sources {start_source}.."
                    f"{start_source + b - 1}")
            if alive == 0:
                break
            lev += 1
        sig = sigma.to(torch.float64)
        ds, dt = at(dist, S), at(dist, T)
        st = at(sig, T)
        ratio = at(sig, S) / torch.where(st > 0, st, 1.0)
        delta = torch.zeros((b, n), dtype=torch.float64, device=dev)
        for lv in range(lev - 1, -1, -1):
            down = (ds == lv) & (dt == lv + 1)
            term = torch.where(down, ratio * (1.0 + at(delta, T)), 0.0)
            delta.index_add_(1, src, term)
        delta[rows, sources] = 0.0
        return delta.sum(dim=0)

    return run


def betweenness_device(csr: DeviceCSR, *, batch: int = 16,
                       max_levels: int | None = None) -> np.ndarray:
    """Betweenness of every node by batched Brandes on the graph's device,
    summed there in float64 and read once."""
    n = csr.n
    cap = int(max_levels if max_levels is not None else n)
    run = make_betweenness_batches(csr, cap, batch)
    out = torch.zeros(n, dtype=torch.float64, device=csr.device)
    for start in range(0, n, batch):
        out += run(start)
    return out.cpu().numpy()
