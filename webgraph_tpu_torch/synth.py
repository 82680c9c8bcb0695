"""Seeded synthetic graphs with web-like locality.

A stand-in for a crawled web graph (cnr-2000: 325,557 nodes, 3,216,152
arcs) where the real file is absent.  Nodes come in runs of consecutive
"pages of one site" that share a set of base links, so a page's list is
largely a copy of a nearby page's list; pages also link runs of
consecutive ids (intervals), local and far single links (gap-coded
residuals), and a few hub pages carry lists of thousands of arcs.  Stored
with cnr-2000's parameters (window 7, maxref 3, minint 3, ζ_3) the
encoder finds copies, intervals and residuals in all three parts of the
record, as on a real crawl.

``big_sites`` gives a share of the sites 300-3,000 pages, as on a crawl of
hosts with thousands of template pages: stored with unbounded reference
chains (maxref 2**31 - 1), such sites chain hundreds of pages, past the
reach K1 covers.  :func:`deep_chain_graph` is the deep-chain synthetic
graph of the JAX package's config 3 (``scripts/bench_configs.py``).
"""

from __future__ import annotations

import numpy as np

from webgraph_tpu_torch.graph.csr import CSRGraph

CNR2000_NODES = 325_557
CNR2000_ARCS = 3_216_152


def _ragged(starts, counts):
    """Concatenated ranges [starts[i], starts[i] + counts[i])."""
    total = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(starts, counts) + (np.arange(total) - first)


def weblike_graph(n: int = CNR2000_NODES, seed: int = 0, *,
                  hubs: int = 12, big_sites: float = 0.0) -> CSRGraph:
    """A directed graph of ``n`` nodes and about 9.9 arcs per node.

    ``big_sites``: the share of site draws given 300..3,000 pages instead
    of 1..40.  At 0 no extra random numbers are drawn, so the graph is the
    same as without the option."""
    rng = np.random.default_rng(seed)
    # sites: runs of 1..40 consecutive pages
    sizes = rng.integers(1, 41, size=n)
    if big_sites > 0:
        big = rng.random(n) < big_sites
        sizes = np.where(big, rng.integers(300, 3001, size=n), sizes)
    sizes = sizes[: int(np.searchsorted(np.cumsum(sizes), n)) + 1]
    sizes[-1] -= int(sizes.sum()) - n
    site_start = np.cumsum(sizes) - sizes
    site_of = np.repeat(np.arange(len(sizes)), sizes)

    # base links of each site: mostly inside the site's neighbourhood
    nb = rng.integers(3, 13, size=len(sizes))
    bsite = np.repeat(np.arange(len(sizes)), nb)
    local = rng.random(len(bsite)) < 0.8
    base = np.where(
        local,
        site_start[bsite] + rng.integers(-20, 60, size=len(bsite)),
        rng.integers(0, n, size=len(bsite)))
    bstart = np.cumsum(nb) - nb

    # every page keeps each base link of its site with probability 0.8
    per = nb[site_of]
    src = np.repeat(np.arange(n), per)
    dst = base[_ragged(bstart[site_of], per)]
    keep = rng.random(len(src)) < 0.8
    parts = [(src[keep], dst[keep])]

    # runs of consecutive ids near the page
    has_run = np.flatnonzero(rng.random(n) < 0.4)
    rlen = rng.integers(3, 13, size=len(has_run))
    rfirst = has_run + rng.integers(-40, 40, size=len(has_run))
    parts.append((np.repeat(has_run, rlen), _ragged(rfirst, rlen)))

    # single links: local gaps and far jumps
    nloc = rng.poisson(0.6, size=n)
    s = np.repeat(np.arange(n), nloc)
    parts.append((s, s + rng.integers(-3000, 3000, size=len(s))))
    nfar = rng.poisson(0.5, size=n)
    s = np.repeat(np.arange(n), nfar)
    parts.append((s, rng.integers(0, n, size=len(s))))

    # hub pages with thousands of arcs: long runs and scattered links
    hub = rng.choice(n, size=hubs, replace=False)
    hlen = rng.integers(1500, 6000, size=hubs)
    parts.append((np.repeat(hub, hlen),
                  _ragged(rng.integers(0, max(n - 6000, 1), size=hubs),
                          hlen)))
    hs = np.repeat(hub, hlen // 3)
    parts.append((hs, rng.integers(0, n, size=len(hs))))

    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    ok = (dst >= 0) & (dst < n) & (dst != src)
    return CSRGraph.from_arcs(src[ok], dst[ok], n, dedup=True)


def deep_chain_graph(n: int = 60000, period: int = 37) -> CSRGraph:
    """Config 3's deep-chain graph: the first n // 2 nodes share prefixes
    ``0 .. x % period`` (plus two far links), the rest are empty.  Stored
    with unbounded maxref, its reference chains run thousands deep."""
    lists = []
    for x in range(n // 2):
        lists.append(sorted(set(range(0, 1 + x % period))
                            | {n - 1 - (x % 5), n // 2 + (x % 97)}))
    return CSRGraph.from_lists(lists + [[]] * (n - n // 2))


def long_record_graph(n: int = 300_000, seed: int = 0) -> CSRGraph:
    """Sparse random lists (0 or 1 arc) around a few long records: node 10
    links 4,000 scattered nodes (~40,000 bits of residuals, 5 tiles of
    K1's long-record parse), node 11 copies 3,000 of them and adds 200
    more, node 12 is one interval of 6,000 nodes, node 13 holds 600
    intervals with a residual after each (more than K1's long-record parse
    keeps in shared memory) and node 14 holds 100 intervals with residuals
    between them."""
    rng = np.random.default_rng(seed)
    src = np.flatnonzero(rng.random(n) < 0.5)
    parts = [(src, rng.integers(0, n, size=len(src)))]
    hub = np.sort(rng.choice(n, 4000, replace=False))
    rest = np.setdiff1d(np.arange(n), hub)
    special = {
        10: hub,
        11: np.concatenate([rng.choice(hub, 3000, replace=False),
                            rng.choice(rest, 200, replace=False)]),
        12: np.arange(100, 6100),
        13: (7000 + 9 * np.arange(600)[:, None]
             + np.array([0, 1, 2, 3, 4, 7])).ravel(),
        14: (15000 + 20 * np.arange(100)[:, None]
             + np.array([0, 1, 2, 3, 4, 5, 11, 15])).ravel(),
    }
    parts[0] = tuple(a[~np.isin(parts[0][0], list(special))]
                     for a in parts[0])
    parts += [(np.full(len(v), x), v) for x, v in special.items()]
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    ok = dst != src
    return CSRGraph.from_arcs(src[ok], dst[ok], n, dedup=True)


MAXREF_INF = 2**31 - 1  # maxref of unbounded reference chains

#: The decode cells at size: name -> (graph maker, ``BVGraph.store``
#: keywords, the kernel that decodes it).  cnr-2000's parameters are
#: window 7, maxref 3, minint 3, ζ_3.
CELLS = {
    "weblike-cnr2000-size": (
        weblike_graph,
        dict(window_size=7, max_ref_count=3, min_interval_length=3,
             zeta_k=3), "k1"),
    "weblike-cnr2000-size-maxref-inf": (
        lambda: weblike_graph(big_sites=0.005),
        dict(window_size=7, max_ref_count=MAXREF_INF, min_interval_length=3,
             zeta_k=3), "k2"),
    "deep-chain-config3-minint2": (
        deep_chain_graph,
        dict(window_size=7, max_ref_count=MAXREF_INF,
             min_interval_length=2), "k2"),
}
