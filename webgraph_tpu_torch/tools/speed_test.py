"""The benchmark harness of the port (reference analog:
test/SpeedTest.java:44-189; counterpart of the JAX package's
``tools/speed_test.py``): sequential enumeration (ns/link via bulk decode),
random access (ns/node via ``successors``), batched random access (ns/node
via ``kernels/query2.py``) and adjacency queries (ns/pair), each the best
of ``repeat`` timed runs after ``warmup`` untimed ones.

Where a run uses the card, the harness synchronises it before every read of
the clock, so a time covers the device's work and not only its enqueueing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from webgraph_tpu_torch.graph.immutable_graph import ImmutableGraph
from webgraph_tpu_torch.utils.rng import XoRoShiRo128PlusRandom

WARMUP = 3
REPEAT = 10
BATCH = 1024  # queries a batch: the reference's lane count, for comparison


def _clock(device):
    """A clock that first waits for ``device`` when it is a CUDA device and
    a card is present (without one, ``to_csr`` decodes on the host)."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        def read():
            torch.cuda.synchronize(device)
            return time.perf_counter()
        return read
    return time.perf_counter


class SpeedTest:
    @staticmethod
    def sequential(graph: ImmutableGraph, warmup: int = WARMUP,
                   repeat: int = REPEAT, backend: str | None = None,
                   device="cuda") -> dict:
        """Full sequential enumeration; ns/link.  ``backend`` selects the
        decode path (device/native/numpy/scalar, ``BVGraph.to_csr``'s
        dispatch; default auto: the port's kernels on ``device`` when it is
        a CUDA device that is present)."""
        m = graph.num_arcs()
        clock = _clock(device)
        times = []
        for rep in range(warmup + repeat):
            t0 = clock()
            try:
                graph.to_csr(backend=backend, device=device)
            except TypeError:  # formats without backend dispatch
                graph.to_csr()
            dt = clock() - t0
            if rep >= warmup:
                times.append(dt)
        best = min(times)
        return {"seconds": best, "ns_per_link": 1e9 * best / max(m, 1),
                "links": m, "backend": backend or "auto"}

    @staticmethod
    def random_access_batched(graph, samples: int, seed: int = 0,
                              warmup: int = 1, repeat: int = 3,
                              device="cuda") -> dict:
        """Batched random access (``kernels/query2.py``): ``samples`` random
        ``successors(x)`` queries in batches of :data:`BATCH`, each batch
        one decode of its ancestor closure on ``device``, the device analog
        of the reference's per-node ``successors()`` loop
        (SpeedTest.java:90-122).  ``links`` counts the arcs returned."""
        from webgraph_tpu_torch.kernels.query2 import QueryPlanner

        rng = XoRoShiRo128PlusRandom(seed)
        n = graph.num_nodes()
        nodes = np.asarray([rng.next_int(n) for _ in range(samples)],
                           dtype=np.int64)
        qp = QueryPlanner(graph, device)
        clock = _clock(device)
        times = []
        links = 0
        for rep in range(warmup + repeat):
            t0 = clock()
            arcs = []
            for base in range(0, samples, BATCH):
                _, counts = qp.successors_batch(nodes[base:base + BATCH])
                arcs.append(counts.sum())
            dt = clock() - t0
            links = int(sum(arcs))
            if rep >= warmup:
                times.append(dt)
        best = min(times)
        return {
            "seconds": best,
            "ns_per_node": 1e9 * best / max(samples, 1),
            "links": links,
            "batched": True,
        }

    @staticmethod
    def random_access(graph: ImmutableGraph, samples: int, seed: int = 0,
                      warmup: int = WARMUP, repeat: int = REPEAT) -> dict:
        """Decode ``samples`` random successor lists on the host; ns/node
        and ns/link."""
        rng = XoRoShiRo128PlusRandom(seed)
        n = graph.num_nodes()
        nodes = [rng.next_int(n) for _ in range(samples)]
        times = []
        links = 0
        for rep in range(warmup + repeat):
            links = 0
            t0 = time.perf_counter()
            for x in nodes:
                links += len(graph.successors(x))
            dt = time.perf_counter() - t0
            if rep >= warmup:
                times.append(dt)
        best = min(times)
        return {
            "seconds": best,
            "ns_per_node": 1e9 * best / max(samples, 1),
            "ns_per_link": 1e9 * best / max(links, 1),
            "links": links,
        }

    @staticmethod
    def adjacency(graph: ImmutableGraph, samples: int, seed: int = 0,
                  warmup: int = WARMUP, repeat: int = REPEAT) -> dict:
        """Random adjacency queries (x, y) on the host; ns/pair.  Uses
        ``skip_to`` when the format provides it, else sorted-array
        search."""
        rng = XoRoShiRo128PlusRandom(seed)
        n = graph.num_nodes()
        pairs = [(rng.next_int(n), rng.next_int(n)) for _ in range(samples)]
        use_skip = hasattr(graph, "skip_to")
        times = []
        hits = 0
        for rep in range(warmup + repeat):
            hits = 0
            t0 = time.perf_counter()
            if use_skip:
                for x, y in pairs:
                    hits += graph.skip_to(x, y) == y
            else:
                for x, y in pairs:
                    s = graph.successors(x)
                    i = np.searchsorted(s, y)
                    hits += bool(i < len(s) and s[i] == y)
            dt = time.perf_counter() - t0
            if rep >= warmup:
                times.append(dt)
        best = min(times)
        return {"seconds": best, "ns_per_pair": 1e9 * best / max(samples, 1),
                "hits": hits}
