"""The graph abstraction layer (reference analog: ImmutableGraph.java:169).

An :class:`ImmutableGraph` exposes node/arc counts, per-node outdegrees and
successor lists, sequential node iteration, disjoint iterator splitting for
parallel work, and flyweight copies.  Graphs persist as a ``basename`` plus a
``.properties`` file whose ``graphclass`` key names the implementation that
can load them (reflective dispatch, reference ImmutableGraph.java:647-710).

TPU-first departure from the reference: the primary bulk interface is
:meth:`to_csr`, which yields flat ``(offsets, successors)`` arrays — the form
every device kernel (decode, transform, analytics) consumes.  The scalar
iterator API is kept for format parity, streaming encoders and tests.
"""

from __future__ import annotations

import enum
import importlib
import os
from typing import Iterator

import numpy as np

from webgraph_tpu_torch.graph.properties import load_properties


class LoadMethod(enum.Enum):
    """Reference analog: ImmutableGraph.LoadMethod (ImmutableGraph.java:224)."""

    STANDARD = "load"
    MAPPED = "load_mapped"
    SEQUENTIAL = "load_sequential"
    OFFLINE = "load_offline"
    ONCE = "load_once"


#: Maps `graphclass` values (including the reference's Java class names, for
#: on-disk interop) to the port's implementations.  The port has BVGraph
#: only; other classes are still to port (ROADMAP A.10).
_GRAPH_CLASS_ALIASES = {
    "it.unimi.dsi.webgraph.BVGraph": "webgraph_tpu_torch.formats.bvgraph.BVGraph",
    "BVGraph": "webgraph_tpu_torch.formats.bvgraph.BVGraph",
}


def resolve_graph_class(name: str):
    try:
        name = _GRAPH_CLASS_ALIASES[name]
    except KeyError:
        raise NotImplementedError(
            f"graph class {name!r} is not ported: the port loads BVGraph "
            f"only (other formats: ROADMAP A.10)") from None
    module_name, _, cls_name = name.rpartition(".")
    mod = importlib.import_module(module_name)
    return getattr(mod, cls_name)


def load(basename: str | os.PathLike, method: LoadMethod = LoadMethod.STANDARD):
    """Load a graph with the class named by ``basename.properties``
    (reference: ImmutableGraph.load dispatch, ImmutableGraph.java:647-685)."""
    props = load_properties(f"{basename}.properties")
    try:
        cls = resolve_graph_class(props["graphclass"])
    except KeyError as e:
        raise ValueError(f"no graphclass key in {basename}.properties") from e
    loader = getattr(cls, method.value, None)
    if loader is None:
        loader = cls.load
    return loader(basename)


def store(graph_class, graph: "ImmutableGraph", basename: str | os.PathLike, **kwargs) -> None:
    """Store ``graph`` in the format of ``graph_class``
    (reference: ImmutableGraph.store, ImmutableGraph.java:699-710)."""
    graph_class.store(graph, basename, **kwargs)


class NodeIterator:
    """Sequential cursor over nodes and their successor lists
    (reference analog: NodeIterator.java:34).

    Subclasses implement :meth:`next_int`, :meth:`outdegree` and
    :meth:`successor_array`; :meth:`copy` (with an upper bound) enables
    iterator splitting for parallel compression.
    """

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_int(self) -> int:
        raise NotImplementedError

    def outdegree(self) -> int:
        raise NotImplementedError

    def successor_array(self) -> np.ndarray:
        raise NotImplementedError

    def copy(self, upper_bound: int) -> "NodeIterator":
        raise NotImplementedError(f"{type(self).__name__} does not support copy()")

    def skip(self, n: int) -> int:
        """Skip up to n nodes; returns how many were skipped."""
        skipped = 0
        while skipped < n and self.has_next():
            self.next_int()
            skipped += 1
        return skipped

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        while self.has_next():
            node = self.next_int()
            yield node, self.successor_array()


class ListNodeIterator(NodeIterator):
    """Node iterator over an in-memory list of successor arrays."""

    def __init__(self, lists, start: int = 0, upper_bound: int | None = None):
        self._lists = lists
        self._next = start
        self._bound = len(lists) if upper_bound is None else min(upper_bound, len(lists))
        self._curr = start - 1

    def has_next(self) -> bool:
        return self._next < self._bound

    def next_int(self) -> int:
        if not self.has_next():
            raise StopIteration
        self._curr = self._next
        self._next += 1
        return self._curr

    def outdegree(self) -> int:
        return len(self._lists[self._curr])

    def successor_array(self) -> np.ndarray:
        return np.asarray(self._lists[self._curr], dtype=np.int32)

    def copy(self, upper_bound: int) -> "ListNodeIterator":
        return ListNodeIterator(self._lists, self._next, upper_bound)


class ImmutableGraph:
    """Abstract immutable graph (reference analog: ImmutableGraph.java:169)."""

    def basename(self) -> str | None:
        return getattr(self, "_basename", None)

    # -- core accessors -------------------------------------------------

    def num_nodes(self) -> int:
        raise NotImplementedError

    def num_arcs(self) -> int:
        raise NotImplementedError

    def random_access(self) -> bool:
        return True

    def outdegree(self, x: int) -> int:
        raise NotImplementedError

    def successors(self, x: int) -> np.ndarray:
        """The sorted successor array of node ``x``."""
        raise NotImplementedError

    successor_array = successors

    # -- iteration ------------------------------------------------------

    def node_iterator(self, start: int = 0) -> NodeIterator:
        g = self

        class _Iter(NodeIterator):
            def __init__(self, frm: int, bound: int | None = None):
                self._next = frm
                self._curr = frm - 1
                self._bound = g.num_nodes() if bound is None else min(bound, g.num_nodes())

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

            def copy(self, upper_bound: int) -> NodeIterator:
                return _Iter(self._next, upper_bound)

        return _Iter(start)

    def split_node_iterators(self, how_many: int) -> list[NodeIterator]:
        """Disjoint per-shard iterators covering [0, n)
        (reference: ImmutableGraph.splitNodeIterators, ImmutableGraph.java:379-409)."""
        n = self.num_nodes()
        if how_many <= 1 or n == 0:
            return [self.node_iterator()] + [self.node_iterator(n)] * (how_many - 1)
        bounds = [round(i * n / how_many) for i in range(how_many + 1)]
        return [self.node_iterator(bounds[i]).copy(bounds[i + 1]) for i in range(how_many)]

    def copy(self) -> "ImmutableGraph":
        """Flyweight copy sharing immutable data (thread/shard-local cursors)."""
        return self

    # -- bulk interface (TPU-first) ------------------------------------

    def to_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """Flat ``(offsets[int64, n+1], successors[int32, m])`` arrays.

        Default implementation materializes via the node iterator; formats
        with faster bulk decode paths override this.
        """
        n = self.num_nodes()
        offsets = np.zeros(n + 1, dtype=np.int64)
        chunks = []
        it = self.node_iterator()
        while it.has_next():
            x = it.next_int()
            succ = it.successor_array()[: it.outdegree()]
            offsets[x + 1] = len(succ)
            chunks.append(np.asarray(succ, dtype=np.int32))
        np.cumsum(offsets, out=offsets)
        successors = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int32)
        return offsets, successors.astype(np.int32)

    # -- comparison -----------------------------------------------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, ImmutableGraph):
            return NotImplemented
        if self.num_nodes() != other.num_nodes():
            return False
        a_off, a_succ = self.to_csr()
        b_off, b_succ = other.to_csr()
        return bool(np.array_equal(a_off, b_off) and np.array_equal(a_succ, b_succ))

    def __hash__(self) -> int:
        """Successor-content hash (reference ImmutableGraph.hashCode,
        ImmutableGraph.java:757): node count folded with each list's
        contribution, via the CSR arrays."""
        offsets, succ = self.to_csr()
        h = hash((self.num_nodes(), len(succ)))
        if len(succ):
            a = np.asarray(succ, dtype=np.int64)
            # order-sensitive polynomial fold, vectorized (31^k mod p weights)
            p = 2**61 - 1
            w64 = np.array([pow(31, k, p) for k in range(64)], dtype=np.int64)
            w = w64[np.arange(len(a)) % 64]
            h ^= int(((a % p) * w % p).sum() % p)
        return h

    def __repr__(self) -> str:
        try:
            m: object = self.num_arcs()
        except Exception:
            m = "?"
        return f"{type(self).__name__}(nodes={self.num_nodes()}, arcs={m})"
