"""Batched random access: the successor lists of a batch of nodes, decoded
on the card from the records of the batch's ancestor closure.

Counterpart of ``webgraph_tpu/pallas/query2.py::QueryPlanner``.  The
reference resolves ``successors(x)`` by positioning the stream at ``x``'s
record and decoding the reference chain recursively (BVGraph.java:853-888,
1032-1133); the TPU version gives each query a lane of K1's lane kernel and
decodes the node range ``[minanc(x), x]``.  The port has no lanes.  A batch
here decodes the union of its queries' ancestor closures (``x``, its
parent ``x - ref[x]``, the parent's parent, ... down to a node without a
reference) and nothing else, with the bulk decode's two kernels
(``kernels/decode2.py::decode_records``): ``k1_parse`` over the closure's
records, then ``k2_resolve`` over its copies, in the closure's depth plan
(``levels.level_order``).  Every parent of a closure node is in the
closure at a smaller global depth, so the depth order gives
``k2_resolve``'s rule that a parent comes first; a chain of any length
only lengthens one ``k2_resolve`` chain, so graphs past K1's bulk reach
(maxref unbounded) are answered the same way.

The lists land in the graph's own CSR slots (``m`` arcs, written only at
the closure's slots), from which the queried lists are gathered into a
zero-padded ``(q, maxd)`` block, as the reference returns them.  The plan
is made on the host in NumPy; a batch reads from the card once, at the
decode's error check.  CPU tensors take the plain versions of both
kernels; CUDA tensors take the kernels, or raise.

Host spans (``timing.span``): the planner's set-up is ``prepare``
(``prepare.scan``, ``prepare.upload``); a batch is ``query``, holding
``query.plan`` (counts ``records``, the closure's size, and ``levels``),
``query.upload`` (each copy to the device, count ``h2d_bytes``), the
decode's ``decode`` and ``query.gather``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from webgraph_tpu_torch.kernels import decode as K2
from webgraph_tpu_torch.kernels import decode2 as D2
from webgraph_tpu_torch.kernels.levels import (csr_starts, graph_fields,
                                               level_order)
from webgraph_tpu_torch.kernels.plan import scan_structure
from webgraph_tpu_torch.timing import span


@dataclass
class QueryPlan:
    """One batch, planned on the host."""

    nodes: np.ndarray   # int64 (q,) the queried nodes
    counts: np.ndarray  # int64 (q,) their outdegrees
    order: np.ndarray   # int64 (c,) the ancestor closure in depth order
    bounds: np.ndarray  # int64 (levels + 1,) depth k is order[b[k]:b[k+1]]
    long: np.ndarray    # int64 positions in order of the long records


class QueryPlanner:
    """Per-graph state for batched random access on one device: the
    structure scan's parents, depths and outdegrees on the host, and the
    stream, bit offsets, CSR offsets and block starts on ``device``, made
    once (the analogue of the reference's load-time offset caches)."""

    def __init__(self, g, device="cuda", *, scan=None):
        if not K2.supports(g):
            raise NotImplementedError(
                f"no device kernel reads this graph (codings "
                f"{g.settings.flags_string()!r}, window "
                f"{g.settings.window_size}): k1_parse reads gamma, delta, "
                f"zeta and unary codes with window <= 7")
        with span("prepare"):
            if scan is None:
                with span("prepare.scan"):
                    scan = scan_structure(g)
            n = g.num_nodes()
            self.n = n
            ref = scan.ref.astype(np.int64)
            self.parent = np.where(ref > 0, np.arange(n) - ref, -1)
            self.depth = scan.depth.astype(np.int64)
            self.d = scan.d.astype(np.int64)
            with span("prepare.upload"):
                f = graph_fields(g, device, *csr_starts(scan))
        self.device, self.words, self.bo = f["device"], f["words"], f["bo"]
        self.offsets, self.bstart = f["offsets"], f["bstart"]
        self.skey, self.m, self.nblocks = f["skey"], f["m"], f["nblocks"]

    def closure(self, nodes: np.ndarray) -> np.ndarray:
        """The ancestor closure of ``nodes`` (int64 node ids in range):
        the unique union of each node and its parents down to depth 0, in
        no particular order (``level_order`` sorts it).  Each node is
        visited once, and no step sorts."""
        seen = np.zeros(self.n, dtype=bool)
        slot = np.empty(self.n, dtype=np.int64)

        def new(v):
            """The values of ``v`` not seen before, each once."""
            v = v[~seen[v]]
            at = np.arange(v.size)
            slot[v] = at  # of repeated values, one write wins
            v = v[slot[v] == at]
            seen[v] = True
            return v

        front = new(nodes)
        parts = [front]
        while front.size:
            p = self.parent[front]
            front = new(p[p >= 0])
            parts.append(front)
        return np.concatenate(parts)

    def plan(self, nodes) -> QueryPlan:
        """The host plan of one batch: its closure in depth order, the
        depth bounds and the closure's long records.  Raises
        ``ValueError`` for a node outside ``[0, n)``."""
        nodes = np.asarray(nodes, dtype=np.int64)
        if nodes.ndim != 1:
            raise ValueError("nodes must be a 1-d array of node ids")
        if nodes.size and (int(nodes.min()) < 0
                           or int(nodes.max()) >= self.n):
            raise ValueError(f"query nodes must lie in [0, {self.n})")
        order, bounds, long = level_order(self.depth, self.d,
                                          self.closure(nodes),
                                          D2.LONG_ARCS)
        return QueryPlan(nodes=nodes, counts=self.d[nodes], order=order,
                         bounds=bounds, long=long)

    def decode(self, plan: QueryPlan) -> torch.Tensor:
        """Decode the closure of ``plan``: the graph's m CSR slots (int32,
        on the planner's device), written at the closure's lists only.
        Raises if a node reports an error."""
        order = self._upload(plan.order, np.int32)
        long = self._upload(plan.long, np.int32)
        return D2.decode_records(self.words, self.bo, order, plan.bounds,
                                 self.offsets, self.skey, self.bstart, long,
                                 m=self.m, nblocks=self.nblocks)

    def successors_batch(self, nodes):
        """The successor lists of ``nodes`` (any number, repeats allowed),
        from one decode of their closure: ``(out int32[q, maxd], counts
        int64[q])`` on the planner's device, ``out[i, :counts[i]]`` the
        list of ``nodes[i]``, zero-padded, ``maxd = max(counts)`` and at
        least 1."""
        with span("query"):
            with span("query.plan") as s:
                plan = self.plan(nodes)
                s.count(records=plan.order.size,
                        levels=plan.bounds.size - 1)
            dev = self.device
            q = plan.nodes.size
            maxd = int(plan.counts.max(initial=1))
            counts = self._upload(plan.counts, np.int64)
            out = torch.zeros((q, maxd), dtype=torch.int32, device=dev)
            if q == 0:
                return out, counts
            succ = self.decode(plan)
            with span("query.gather"):
                # slot j of query i: succ[offsets[x_i] + j] -> out[i, j]
                total = int(plan.counts.sum())
                seg = torch.repeat_interleave(torch.arange(q, device=dev),
                                              counts, output_size=total)
                j = torch.arange(total, device=dev) - (
                    torch.cumsum(counts, 0) - counts)[seg]
                start = self.offsets[self._upload(plan.nodes, np.int64)]
                out.view(-1)[seg * maxd + j] = succ[start[seg] + j]
            return out, counts

    def _upload(self, a: np.ndarray, dtype) -> torch.Tensor:
        """``a`` as ``dtype`` on the planner's device."""
        with span("query.upload") as s:
            a = a.astype(dtype, copy=False)
            s.count(h2d_bytes=a.nbytes)
            return torch.from_numpy(a).to(self.device)

    def adjacency(self, src, dst) -> torch.Tensor:
        """Whether ``(src[i], dst[i])`` is an arc, for each ``i``: a bool
        tensor on the planner's device, a membership test over
        :meth:`successors_batch` (the reference's
        ``BatchQuery.adjacency``)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.shape != dst.shape:
            raise ValueError("src and dst must have the same shape")
        out, counts = self.successors_batch(src)
        want = torch.from_numpy(dst).to(self.device)
        col = torch.arange(out.shape[1], device=self.device)
        return ((out == want[:, None]) & (col < counts[:, None])).any(1)
