"""The benchmark's input maker: a seeded web-like graph as a CSR, its shape
set by a configuration file's ``graph`` entry.

Nodes come in runs of consecutive "pages of one site", and in shorter
runs ("sections"), each of which shares a template of links, mostly near
its first page; each page keeps each link of its site's and its
section's template with probability ``keep``, links a run of consecutive
ids near it with probability ``run_share``, and adds Poisson counts of
local single links (within ``local_reach``) and far ones (anywhere); a
share ``empty_share`` of the pages has no links.  This is the structure a
crawl in URL order gives.  The parameters are calibrated so that the
graph, stored as the configuration states, matches the published
statistics of the graph it stands for (``published`` in the
configuration file, within its ``tolerance``; held by
``benchmark/tests/test_bench_inputs.py``).

Hubs are the same for every seed: ``hubs.lengths`` pages of that many
run arcs and a third as many scattered links, each at a seeded position
and followed by a page that holds a near-copy of its list with
``hubs.copy_drop`` of its arcs left out, so that every seed has the same
long lists copied by reference.  The rest of the graph's work moves with
the seed by its sampling alone.

A frozen copy of the ideas of ``webgraph_tpu_torch/synth.py::
weblike_graph`` and of the dedup of ``graph/csr.py::CSRGraph.from_arcs``,
so that a change to the port cannot change the benchmark's inputs.
Plain NumPy; imports nothing of the port.
"""

from __future__ import annotations

import numpy as np


def _ragged(starts, counts):
    """Concatenated ranges [starts[i], starts[i] + counts[i])."""
    total = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(starts, counts) + (np.arange(total) - first)


def csr_from_arcs(src, dst, n):
    """``(offsets int64[n+1], succ int32[m])`` of the arcs ``src -> dst``,
    each list sorted and without repeats."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if len(src):
        keep = np.empty(len(src), dtype=bool)
        keep[0] = True
        np.not_equal(src[1:], src[:-1], out=keep[1:])
        keep[1:] |= dst[1:] != dst[:-1]
        src, dst = src[keep], dst[keep]
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(np.bincount(src, minlength=n))
    return offsets, dst.astype(np.int32)


def _range(rng, lohi, size):
    """Uniform whole numbers in ``[lo, hi]``."""
    return rng.integers(int(lohi[0]), int(lohi[1]) + 1, size=size)


def _hubs(rng, n, spec, free):
    """The ``(src, dst)`` arcs of the hub pages and their near-copies; the
    nodes they take are cleared in ``free``."""
    lengths = np.asarray(spec.get("lengths", []), dtype=np.int64)
    if lengths.size == 0:
        return []
    # one hub a stretch of n / hubs nodes, so no two come close
    stretch = n // lengths.size
    hub = np.arange(lengths.size) * stretch + rng.integers(
        0, max(stretch - 2, 1), size=lengths.size)
    hub = np.minimum(hub, n - 2)
    lengths = rng.permutation(lengths)
    parts = []
    for h, length in zip(hub, lengths):
        first = int(rng.integers(0, max(n - int(length), 1)))
        run = np.arange(first, min(first + int(length), n))
        scattered = rng.integers(0, n, size=int(length) // 3)
        lst = np.unique(np.concatenate([run, scattered]))
        lst = lst[(lst != h) & (lst != h + 1)]
        drop = rng.random(lst.size) < float(spec.get("copy_drop", 0.0))
        parts.append((np.full(lst.size, h), lst))
        parts.append((np.full(int((~drop).sum()), h + 1), lst[~drop]))
    free[hub] = False
    free[hub + 1] = False
    return parts


def _templates(rng, n, pages, links, p):
    """``(src, dst)``: the nodes cut into groups of ``pages`` consecutive
    pages, each with a template of ``links`` links (a share ``base_local``
    of them within ``base_reach`` of the group's first page, the rest
    anywhere), each page keeping each link with probability ``keep``."""
    sizes = _range(rng, pages, n)
    sizes = sizes[: int(np.searchsorted(np.cumsum(sizes), n)) + 1]
    sizes[-1] -= int(sizes.sum()) - n
    start = np.cumsum(sizes) - sizes
    group = np.repeat(np.arange(len(sizes)), sizes)
    nb = _range(rng, links, len(sizes))
    owner = np.repeat(np.arange(len(sizes)), nb)
    local = rng.random(len(owner)) < float(p["base_local"])
    lo, hi = p["base_reach"]
    base = np.where(
        local, start[owner] + rng.integers(int(lo), int(hi), size=len(owner)),
        rng.integers(0, n, size=len(owner)))
    per = nb[group]
    src = np.repeat(np.arange(n), per)
    dst = base[_ragged((np.cumsum(nb) - nb)[group], per)]
    keep = rng.random(len(src)) < float(p["keep"])
    return src[keep], dst[keep]


def weblike_graph(n: int, seed: int, params: dict):
    """A directed web-like graph of ``n`` nodes under ``params`` (a
    configuration's ``graph`` entry), as ``(offsets int64[n+1], succ
    int32[m])``; the same ``seed`` gives the same graph."""
    p = params
    rng = np.random.default_rng(seed)
    free = np.ones(n, dtype=bool)
    hub_parts = _hubs(rng, n, p.get("hubs", {}), free)

    # sites, and sections of sites: runs of consecutive pages that share
    # a template of links; every page keeps each link of its site's and
    # of its section's template with probability keep
    parts = [_templates(rng, n, p["site_pages"], p["base_links"], p),
             _templates(rng, n, p["section_pages"], p["section_links"], p)]

    # runs of consecutive ids near the page
    has_run = np.flatnonzero(rng.random(n) < float(p["run_share"]))
    rlen = _range(rng, p["run_length"], len(has_run))
    r = int(p["run_reach"])
    rfirst = has_run + rng.integers(-r, r, size=len(has_run))
    parts.append((np.repeat(has_run, rlen), _ragged(rfirst, rlen)))

    # single links: local gaps and far jumps
    nloc = rng.poisson(float(p["local_links"]), size=n)
    s = np.repeat(np.arange(n), nloc)
    r = int(p["local_reach"])
    parts.append((s, s + rng.integers(-r, r, size=len(s))))
    nfar = rng.poisson(float(p["far_links"]), size=n)
    s = np.repeat(np.arange(n), nfar)
    parts.append((s, rng.integers(0, n, size=len(s))))

    # pages with no links (not crawled, or dead ends); a hub page and its
    # near-copy hold their hub lists alone
    free &= rng.random(n) >= float(p.get("empty_share", 0.0))
    parts = [tuple(a[free[q[0]]] for a in q) for q in parts] + hub_parts
    src = np.concatenate([q[0] for q in parts])
    dst = np.concatenate([q[1] for q in parts])
    ok = (dst >= 0) & (dst < n) & (dst != src)
    return csr_from_arcs(src[ok], dst[ok], n)


def make_graph(config: dict, seed: int):
    """The CSR of a configuration file's ``graph`` entry under ``seed``."""
    g = config["graph"]
    if g["generator"] != "weblike":
        raise ValueError(f"unknown generator {g['generator']!r}")
    return weblike_graph(int(g["nodes"]), seed_of(seed), g)


def seed_of(seed: int) -> int:
    """A run's ``--seed`` (any whole number) as a NumPy seed."""
    return int(seed) % (1 << 64)
