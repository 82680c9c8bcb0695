"""``propagate`` (webgraph_tpu_torch/kernels/propagate.py): whole
propagations over k words a node, level after level, as one launch of
``or_pull`` on the card.

* ``propagate_plain`` against ``or_pull_plain`` iterated level by level and
  word by word, and against distances by a NumPy BFS from every source
  bit, on random small graphs, k in {1, 2, 3}, with and without ``perbit``
  and ``dist``, exactly;
* k words against k one-word propagations;
* a 300-node chain with a level array of 8 levels against one unbounded
  run: the same words, counts and ``dist``, a host read a level array;
* the analytics' host reads: one a propagation.

Card twins (``gpu``) hold the kernel to ``propagate_plain`` for k in {1,
2, 4, 8, 16} and a chain deep enough for further launches, and check that
a k past ``KMAX`` raises; they skip without a card."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from webgraph_tpu_torch.algo import device as D
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.kernels import propagate as P
from webgraph_tpu_torch.synth import weblike_graph
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)

GRAPHS = {
    "er300": lambda: MutableGraph.erdos_renyi(300, 0.02, seed=3),
    "weblike500": lambda: weblike_graph(500),
    "weblike2000": lambda: weblike_graph(2_000),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _in_csr(n, arcs):
    """The in-CSR of ``arcs`` ((src, dst) pairs), by target then source."""
    arcs = sorted(set(arcs), key=lambda a: (a[1], a[0]))
    in_off = np.zeros(n + 1, dtype=np.int64)
    for _, x in arcs:
        in_off[x + 1] += 1
    return (torch.from_numpy(np.cumsum(in_off)),
            torch.tensor([y for y, _ in arcs], dtype=torch.int32), arcs)


def _chain(n):
    """The in-CSR of the path 0 -> 1 -> ... -> n - 1."""
    in_off = torch.from_numpy(np.arange(n + 1).clip(min=1) - 1)
    return in_off, torch.arange(n - 1, dtype=torch.int32)


def _iterated(in_off, in_src, words, cap, perbit, dist):
    """``or_pull_plain`` level by level and word by word, until a level
    reaches nothing or ``cap`` levels."""
    counts, bits, cur = [], [], words.clone()
    for level in range(cap):
        cols, stats = [], []
        for j in range(words.shape[1]):
            new, s = P.or_pull_plain(
                in_off, in_src, cur[:, j].contiguous(), perbit=perbit,
                dist=None if dist is None else dist[:, j], level=level)
            cols.append(new)
            stats.append(s)
        cur = torch.stack(cols, dim=1)
        counts.append([int(s[0]) for s in stats])
        bits.append([s[1:].tolist() for s in stats])
        if sum(counts[-1]) == 0:
            break
    return cur, counts, bits


def _bfs_dist(n, arcs, src):
    """Distances from ``src`` by a NumPy frontier BFS (-1 unreached)."""
    d = np.full(n, -1)
    d[src] = 0
    front, t = [src], 0
    out = [[] for _ in range(n)]
    for y, x in arcs:
        out[y].append(x)
    while front:
        t += 1
        nxt = []
        for y in front:
            for x in out[y]:
                if d[x] < 0:
                    d[x] = t
                    nxt.append(x)
        front = nxt
    return d


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_propagate_plain_matches_iterated_or_pull(data):
    n = data.draw(st.integers(1, 30))
    arcs = data.draw(st.lists(st.tuples(st.integers(0, n - 1),
                                        st.integers(0, n - 1)), max_size=90))
    k = data.draw(st.sampled_from([1, 2, 3]))
    perbit = data.draw(st.booleans())
    with_dist = data.draw(st.booleans())
    cap = data.draw(st.integers(0, n + 2))
    # a source a bit: bit b of word j at node sources[j][b]
    sources = [data.draw(st.lists(st.integers(0, n - 1), max_size=5))
               for _ in range(k)]
    in_off, in_src, arcs = _in_csr(n, arcs)
    words = torch.zeros(n, k, dtype=torch.int64)
    for j, ss in enumerate(sources):
        for b, s in enumerate(ss):
            words[s, j] |= 1 << b
    keep = words.clone()
    dist = torch.full((n, k), -1, dtype=torch.int32) if with_dist else None
    dist2 = dist.clone() if with_dist else None
    reads = P.propagate.reads
    res = P.propagate_plain(in_off, in_src, words, max_levels=cap,
                            perbit=perbit, dist=dist)
    assert P.propagate.reads == reads + (cap > 0)
    assert torch.equal(words, keep)  # the input is read, never written
    want, counts, bits = _iterated(in_off, in_src, words, cap, perbit, dist2)
    assert res.levels == len(counts) <= cap
    assert torch.equal(res.words, want)
    assert res.counts.tolist() == (counts or torch.zeros(0, k).tolist())
    if perbit:
        assert res.bits.tolist() == (bits or torch.zeros(0, k, 64).tolist())
    else:
        assert res.bits is None
    if with_dist:
        assert torch.equal(dist, dist2)
    # each bit's reach and level against a BFS from its source
    for j, ss in enumerate(sources):
        for b, s in enumerate(ss):
            d = _bfs_dist(n, arcs, s)
            reached = ((res.words[:, j] >> b) & 1).numpy().astype(bool)
            assert np.array_equal(reached, (d >= 0) & (d <= res.levels))
            if perbit:
                for t in range(res.levels):
                    got = int(res.bits[t, j, b])
                    assert got == int(((d == t + 1)
                                       & ~((keep[:, j] >> b) & 1)
                                       .numpy().astype(bool)).sum())


@pytest.mark.parametrize("name", ["er300", "weblike500"])
def test_k_words_equal_k_propagations(name):
    csr = D.DeviceCSR.from_graph(GRAPHS[name](), "cpu")
    words = D._group_words(csr, 0, 3)
    words[:, 1] &= 0x0F0F0F0F  # unlike batches: not every source set
    dist = torch.full(words.shape, -1, dtype=torch.int32)
    res = P.propagate(csr.in_off, csr.in_src, words, max_levels=csr.n,
                      perbit=True, dist=dist)
    for j in range(3):
        dj = torch.full((csr.n, 1), -1, dtype=torch.int32)
        one = P.propagate(csr.in_off, csr.in_src,
                          words[:, j:j + 1].contiguous(), max_levels=csr.n,
                          perbit=True, dist=dj)
        L = one.levels
        assert L <= res.levels
        assert torch.equal(res.words[:, j], one.words[:, 0])
        assert torch.equal(res.counts[:L, j], one.counts[:, 0])
        assert not res.counts[L:, j].any()  # converged: nothing more
        assert torch.equal(res.bits[:L, j], one.bits[:, 0])
        assert torch.equal(dist[:, j], dj[:, 0])


def test_chain_across_level_arrays():
    """300 levels in arrays of 8: 38 host reads, the same result as one
    array, and a cap that stops inside an array."""
    n = 300
    in_off, in_src = _chain(n)
    words = torch.zeros(n, 2, dtype=torch.int64)
    words[0, 0] = 1
    words[150, 1] = -2**63
    out = []
    for per in (8, P.LEVELS):
        dist = torch.full((n, 2), -1, dtype=torch.int32)
        reads = P.propagate.reads
        res = P.propagate(in_off, in_src, words, max_levels=n, perbit=True,
                          dist=dist, levels_per_launch=per)
        out.append((res, dist, P.propagate.reads - reads))
    (a, da, ra), (b, db, rb) = out
    assert a.levels == b.levels == n  # 299 hops, then the level of nothing
    assert (ra, rb) == (-(-n // 8), 1)
    assert torch.equal(a.words, b.words) and torch.equal(a.counts, b.counts)
    assert torch.equal(a.bits, b.bits) and torch.equal(da, db)
    assert da[:, 0].tolist() == [-1] + list(range(1, n))  # sources keep
    assert da[:, 1].tolist() == [-1] * 151 + list(range(1, n - 150))
    assert a.counts[:, 0].tolist() == [1] * (n - 1) + [0]
    assert int(a.bits[0, 1, 63]) == 1 and int(a.bits[149, 1, 63]) == 0
    c = P.propagate(in_off, in_src, words, max_levels=21,
                    levels_per_launch=8)
    assert c.levels == 21 and torch.equal(c.counts, a.counts[:21])


def test_host_reads_one_a_propagation():
    """BFS, a group of NF batches and a group of geometric batches: one
    host read each (their levels fit one level array)."""
    csr = D.DeviceCSR.from_graph(GRAPHS["weblike500"](), "cpu")
    before = dict(D.host_reads)
    D.bfs_distances(csr, [3, 9])
    D.make_nf_batches(csr, csr.n)(0, D.GROUP)
    D.make_nf_batches(csr, csr.n)(1, D.GROUP + 1)  # two launches
    D.make_geometric_batches(csr, csr.n)(2, 3)
    D.nf64(csr, [1, 2, 3])
    got = {k: D.host_reads[k] - before[k] for k in before}
    assert got == {"bfs": 1, "nf": 1 + 2 + 1, "geometric": 1,
                   "betweenness": 0}


def test_propagate_checks_its_inputs():
    in_off, in_src = _chain(4)
    words = torch.zeros(4, 2, dtype=torch.int64)
    with pytest.raises(ValueError, match="words"):
        P.propagate(in_off, in_src, words[:, 0], max_levels=2)
    with pytest.raises(ValueError, match="words"):
        P.propagate(in_off, in_src, words.t(), max_levels=2)
    with pytest.raises(ValueError, match="dist"):
        P.propagate(in_off, in_src, words, max_levels=2,
                    dist=torch.zeros(4, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="in_off"):
        P.propagate(in_off[:3], in_src, words, max_levels=2)
    with pytest.raises(ValueError, match="max_levels"):
        P.propagate(in_off, in_src, words, max_levels=-1)
    launches = P.or_pull.launches
    res = P.propagate(in_off, in_src, torch.zeros(4, 20, dtype=torch.int64),
                      max_levels=3)  # the plain version takes any k
    assert res.levels == 1 and P.or_pull.launches == launches


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


def _card_case(csr, k, seed, cuda):
    """Seeded words of k columns (bits kept sparse, a few rows empty)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**63, 2**63 - 1, size=(csr.n, k), dtype=np.int64)
    w &= rng.integers(-2**63, 2**63 - 1, size=(csr.n, k), dtype=np.int64)
    w[rng.random((csr.n, k)) < 0.9] = 0
    return torch.from_numpy(w).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_propagate_matches_plain_on_card(name, k, cuda):
    csr = D.DeviceCSR.from_graph(GRAPHS[name](), cuda)
    words = _card_case(csr, k, k, cuda)
    for perbit, with_dist in ((False, False), (True, True), (True, False)):
        got_d = (torch.full((csr.n, k), -1, dtype=torch.int32, device=cuda)
                 if with_dist else None)
        want_d = got_d.clone() if with_dist else None
        launches = P.or_pull.launches
        got = P.propagate(csr.in_off, csr.in_src, words, max_levels=csr.n,
                          perbit=perbit, dist=got_d, order=csr.pull)
        torch.cuda.synchronize()
        assert P.or_pull.launches == launches + 1
        want = P.propagate_plain(csr.in_off, csr.in_src, words,
                                 max_levels=csr.n, perbit=perbit,
                                 dist=want_d)
        assert got.levels == want.levels
        assert torch.equal(got.words, want.words)
        assert torch.equal(got.counts, want.counts)
        if perbit:
            assert torch.equal(got.bits, want.bits)
        if with_dist:
            assert torch.equal(got_d, want_d)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 16])
def test_deep_chain_on_card(k, cuda):
    """A 2,100-node chain (2,100 levels): three launches of up to 1,024
    levels, the same as the plain version with one level array."""
    n = 2_100
    in_off, in_src = (t.to(cuda) for t in _chain(n))
    words = torch.zeros(n, k, dtype=torch.int64, device=cuda)
    words[0] = 1
    words[n // 2, k - 1] = -2**63
    dist = torch.full((n, k), -1, dtype=torch.int32, device=cuda)
    pdist = dist.clone()
    launches, reads = P.or_pull.launches, P.propagate.reads
    got = P.propagate(in_off, in_src, words, max_levels=n, perbit=True,
                      dist=dist)
    assert P.or_pull.launches - launches == P.propagate.reads - reads == 3
    want = P.propagate_plain(in_off, in_src, words, max_levels=n,
                             perbit=True, dist=pdist, levels_per_launch=n)
    assert got.levels == want.levels == n
    assert torch.equal(got.words, want.words)
    assert torch.equal(got.counts, want.counts)
    assert torch.equal(got.bits, want.bits) and torch.equal(dist, pdist)


@pytest.mark.gpu
def test_k_past_the_maximum_raises_on_card(cuda):
    in_off, in_src = (t.to(cuda) for t in _chain(8))
    words = torch.zeros(8, P.KMAX + 1, dtype=torch.int64, device=cuda)
    launches = P.or_pull.launches
    with pytest.raises(ValueError, match="at most"):
        P.propagate(in_off, in_src, words, max_levels=4)
    assert P.or_pull.launches == launches
