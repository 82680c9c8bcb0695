"""The port's BVGraph encoder on a device (webgraph_tpu_torch/formats/
bvgraph_encode.py, kernels/encode.py) against the port's host store
(``BVGraph.store(..., use_native=False)``, the scalar oracle), on the CPU
through the kernels' plain versions, on the sweep of the JAX package's
tests/test_bvgraph_jax_encode.py:

* 5 generators x 5 (window, maxref, minint) settings, the 7 codings sets,
  the ζ_k sweep 1, 2, 4, 7, successors far below their node (the zigzag
  first gaps): ``.graph`` and ``.offsets`` bytes, ``graphbits``,
  ``offsetbits`` and six stats;
* ``store_device``: a round trip, and its ``.properties`` equal to the
  host store's key for key;
* ``shard_start``: costs of the candidate shifts equal the host
  ``_diff_comp`` bits, the shifts before it are no candidates, and an
  encode with ``shard_start`` decodes back to the graph;
* a graph without nodes or arcs raises ValueError;
* streams whose last word holds 1, 2, 3 or 4 bytes: bytes, bit counts
  and every stats field against the host store's ``_CompressionStats``;
* config 4's composition: the device transpose, the Gray-code map (host
  keys), then the encode, against the host pipeline.

``enc_select``'s chunked selection is modelled in NumPy
(:func:`select_model`) and held to ``enc_select_plain`` at chunk lengths
1, 3, 8 and 128 on random tables, its counts on a chain through every
chunk and on a table whose guesses hold.

Card twins (``gpu``) hold each kernel to its plain version and
``encode_device(..., device="cuda")`` to the host store on the same
sweep, a graph with a hub of 2,500 arcs, config 3's graph at 2,000 nodes
with maxref 2^31-1 (a long chain) and a 12-node window (the ring in
shared memory), and ``enc_select`` to its plain version and its counts to
the model's on the random tables and the two made ones, and two
encodes of one read size to the host store (the page-locked block
aliases no result); they skip without a card.  The JAX package: tests/test_torch_encode_ref.py."""

import os

import numpy as np
import pytest
import torch

from webgraph_tpu_torch import timing
from webgraph_tpu_torch.bits import codes as C
from webgraph_tpu_torch.formats import bvgraph_encode as E
from webgraph_tpu_torch.formats.bvgraph import (_DEFAULT_CODINGS, BVGraph,
                                                BVGraphSettings,
                                                _CompressionStats,
                                                _diff_comp)
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.graph.properties import load_properties
from webgraph_tpu_torch.kernels import encode as K
from webgraph_tpu_torch.synth import MAXREF_INF, deep_chain_graph
from webgraph_tpu_torch.transform import device as TD
from webgraph_tpu_torch.transform import transform as T
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)

GENERATORS = [
    ("cycle", lambda: MutableGraph.directed_cycle(40)),
    ("complete", lambda: MutableGraph.complete_graph(24, loops=False)),
    ("er-sparse", lambda: MutableGraph.erdos_renyi(120, 0.04, seed=7)),
    ("er-dense", lambda: MutableGraph.erdos_renyi(60, 0.3, seed=11)),
    ("outtree", lambda: MutableGraph.complete_binary_outtree(5)),
]
SETTINGS = [(7, 3, 4), (0, 0, 2), (2, 1, 0), (4, 10**9, 3), (1, 0, 1)]
CODINGS = [
    {"RESIDUALS": C.GAMMA},
    {"RESIDUALS": C.DELTA},
    {"RESIDUALS": C.ZETA},
    {"RESIDUALS": C.GOLOMB},
    {"RESIDUALS": C.NIBBLE},
    {"OUTDEGREES": C.DELTA, "BLOCKS": C.DELTA, "BLOCK_COUNT": C.UNARY,
     "OFFSETS": C.DELTA},
    {"REFERENCES": C.GAMMA, "BLOCK_COUNT": C.DELTA},
]
STATS = (("copied_arcs", "copiedarcs"),
         ("intervalised_arcs", "intervalisedarcs"),
         ("residual_arcs", "residualarcs"),
         ("bits_residuals", "bitsforresiduals"),
         ("bits_blocks", "bitsforblocks"),
         ("bits_intervals", "bitsforintervals"))


def _codings(codings):
    full = dict(_DEFAULT_CODINGS)
    full.update(codings)
    return BVGraphSettings(codings=full, zeta_k=3, window_size=3,
                           max_ref_count=2, min_interval_length=2)


def _negative_first_gaps():
    g = MutableGraph(50)
    for x in range(40, 50):
        for y in (0, 1, 2, 3, x - 1):
            g.add_arc(x, y)
    return g.immutable_view()


def _host(g, tmp_path, name, s, **kw):
    base = os.path.join(tmp_path, name)
    props = BVGraph.store(g, base, settings=s, **kw)
    with open(base + ".graph", "rb") as f:
        gb = f.read()
    with open(base + ".offsets", "rb") as f:
        ob = f.read()
    return gb, ob, props


def _check(g, tmp_path, name, s, device="cpu", host_kw=None, **kw):
    """encode_device on ``device`` against the host store: bytes, bit
    counts and the six stats of the JAX test."""
    gb, ob, props = _host(g, tmp_path, name, s,
                          **(host_kw or {"use_native": False}))
    off, succ = g.to_csr()
    if device != "cpu":
        off = torch.as_tensor(np.asarray(off, dtype=np.int64), device=device)
        succ = torch.as_tensor(np.asarray(succ, dtype=np.int32),
                               device=device)
    dgb, gbits, dob, obits, stats = E.encode_device(off, succ, s,
                                                    device=device, **kw)
    assert dgb == gb, f"{name}: .graph bytes differ"
    assert dob == ob, f"{name}: .offsets bytes differ"
    assert gbits == int(props["graphbits"])
    assert obits == int(props["offsetbits"])
    for mine, theirs in STATS:
        assert stats[mine] == int(props[theirs]), mine
    return stats


@pytest.mark.parametrize("gname,gen", GENERATORS)
@pytest.mark.parametrize("window,maxref,minint", SETTINGS)
def test_encode_matches_host_store(tmp_path, gname, gen, window, maxref,
                                   minint):
    _check(gen(), tmp_path, f"{gname}-{window}-{maxref}-{minint}",
           BVGraphSettings(window_size=window, max_ref_count=maxref,
                     min_interval_length=minint))


@pytest.mark.parametrize("codings", CODINGS)
def test_encode_codings(tmp_path, codings):
    _check(MutableGraph.erdos_renyi(90, 0.08, seed=3), tmp_path,
           "-".join(f"{k}{v}" for k, v in codings.items()), _codings(codings))


def test_encode_zeta_k_sweep(tmp_path):
    g = MutableGraph.erdos_renyi(80, 0.1, seed=5)
    for k in (1, 2, 4, 7):
        _check(g, tmp_path, f"zk{k}", BVGraphSettings(zeta_k=k))


def test_encode_first_gap_negative(tmp_path):
    _check(_negative_first_gaps(), tmp_path, "neg-first-gap", BVGraphSettings())


def test_store_device_roundtrip_and_properties(tmp_path):
    g = MutableGraph.erdos_renyi(150, 0.05, seed=13)
    base = os.path.join(tmp_path, "dev")
    props = E.store_device(g, base, device="cpu")
    bv = BVGraph.load(base)
    off, succ = g.to_csr()
    off2, succ2 = bv.to_csr(backend="numpy")
    np.testing.assert_array_equal(np.asarray(off, dtype=np.int64),
                                  np.asarray(off2, dtype=np.int64))
    np.testing.assert_array_equal(succ, succ2)
    hbase = os.path.join(tmp_path, "host")
    hprops = BVGraph.store(g, hbase, use_native=False)
    assert props == hprops
    assert load_properties(base + ".properties") \
        == load_properties(hbase + ".properties")
    for ext in (".graph", ".offsets"):
        with open(base + ext, "rb") as a, open(hbase + ext, "rb") as b:
            assert a.read() == b.read(), ext


def test_shard_start_costs_and_round_trip(tmp_path):
    """Shifts reaching before ``shard_start`` are no candidates (so the
    nodes before it take no reference); the cost of every candidate is the
    host ``_diff_comp``'s bits; an encode with ``shard_start`` decodes back
    to the graph."""
    g = MutableGraph.erdos_renyi(120, 0.06, seed=21)
    s = BVGraphSettings(window_size=4, max_ref_count=2, min_interval_length=2)
    off, succ = (torch.as_tensor(np.asarray(a)) for a in g.to_csr())
    off, succ = off.long(), succ.int()
    n, shard = off.numel() - 1, 60
    skey = E.skey_of(s)
    costs, valid = E.compute_costs(off, succ, None, skey, shard)
    base, valid0 = E.compute_costs(off, succ, None, skey)
    lists = [succ[off[x]:off[x + 1]].tolist() for x in range(n)]
    for x in range(n):
        for r in range(s.window_size + 1):
            assert bool(valid[x, r]) == (bool(valid0[x, r])
                                         and (r == 0 or x - r >= shard))
            if valid[x, r]:
                want = _diff_comp(None, s, x, r, lists[x - r], lists[x], None)
                assert int(costs[x, r]) == want == int(base[x, r]), (x, r)
    refs, _ = E.select_references(costs, valid, skey)
    x = torch.arange(n)
    assert bool(((refs == 0) | (x - refs >= shard)).all())
    gb, gbits, ob, obits, st = E.encode_device(off, succ, s,
                                               shard_start=shard,
                                               device="cpu")
    basename = os.path.join(tmp_path, "shard")
    for ext, data in ((".graph", gb), (".offsets", ob)):
        with open(basename + ext, "wb") as f:
            f.write(data)
    cs = _CompressionStats()
    for k, v in st.items():
        setattr(cs, k, v)
    BVGraph._write_properties(basename, n, s, cs, gbits, obits, "shard")
    off2, succ2 = BVGraph.load(basename).to_csr(backend="numpy")
    np.testing.assert_array_equal(off2, off.numpy())
    np.testing.assert_array_equal(succ2, succ.numpy())


def test_empty_graph_raises():
    s = BVGraphSettings()
    with pytest.raises(ValueError, match="non-empty"):
        E.encode_device(np.zeros(1, np.int64), np.zeros(0, np.int32), s,
                        device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        E.encode_device(np.zeros(6, np.int64), np.zeros(0, np.int32), s,
                        device="cpu")


def test_config4_composition(tmp_path):
    """Config 4 in the port: the device transpose, the map by the Gray-code
    permutation (host keys), then the encode, byte for byte the host
    pipeline (transform.transpose, map_graph, BVGraph.store)."""
    g = MutableGraph.erdos_renyi(200, 0.04, seed=17)
    n = g.num_nodes()
    off, succ = TD.graph_csr(g, "cpu")
    t_off, t_succ, _ = TD.transpose_arcs_device(*TD.arcs_of(off, succ), n)
    gt = T.transpose(g)
    np.testing.assert_array_equal(t_succ.numpy(), gt.to_csr()[1])
    perm = T.gray_code_permutation(gt)
    p_off, p_succ, m = TD.map_arcs_device(*TD.arcs_of(t_off, t_succ),
                                          torch.as_tensor(perm), n)
    want = T.map_graph(gt, perm)
    gb, ob, _ = _host(want, tmp_path, "config4", BVGraphSettings(),
                      use_native=False)
    dgb, _, dob, _, _ = E.encode_device(p_off, p_succ[:int(m)],
                                        BVGraphSettings(), device="cpu")
    assert (dgb, dob) == (gb, ob)


@pytest.mark.parametrize("entry", ["encode_device", "store_device"])
def test_entry_points_default_to_the_card(entry):
    import inspect

    fn = getattr(E, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cpu_tensors_launch_nothing_and_read_twice():
    """The plain versions run for CPU tensors: no kernel launch is
    counted; an encode reads its totals and its output once each, the
    first read also giving ``enc_select``'s three counts (zeros: the host
    loop runs no rounds)."""
    g = MutableGraph.erdos_renyi(40, 0.1, seed=2)
    launches = [K.enc_costs.launches, K.enc_select.launches,
                K.enc_emit.launches]
    reads = E.encode_device.reads
    with timing.recording() as spans:
        E.encode_device(*g.to_csr(), BVGraphSettings(), device="cpu")
    assert [K.enc_costs.launches, K.enc_select.launches,
            K.enc_emit.launches] == launches
    assert E.encode_device.reads == reads + 2
    (totals,) = [s for s in spans if s.name == "encode.read_totals"]
    assert totals.counts == {"d2h_bytes": 48, "select_rounds": 0,
                             "select_rerun_nodes": 0,
                             "select_serial_nodes": 0}
    off, succ = (torch.as_tensor(np.asarray(a)) for a in g.to_csr())
    with pytest.raises(ValueError, match="unsupported device"):
        K.enc_costs(off.long().to("meta"), succ.int().to("meta"),
                    E.skey_of(BVGraphSettings()))


def test_plan_sizes_and_node_bits():
    """``plan_sizes``' total bits equal the starts' end from the costs
    (``node_bits_of``), and its block, interval and residual counts equal
    the stats of the emission."""
    g = MutableGraph.erdos_renyi(90, 0.08, seed=3)
    s = _codings({})
    skey = E.skey_of(s)
    off, succ = (torch.as_tensor(np.asarray(a)) for a in g.to_csr())
    off, succ = off.long(), succ.int()
    costs, valid = E.compute_costs(off, succ, None, skey)
    refs, depths = E.select_references(costs, valid, skey)
    tb, tblk, tiv, tres = E.plan_sizes(off, succ, None, refs, skey)
    words, starts, stats, _, _ = E.emit_graph(off, succ, None, refs, depths,
                                              skey, costs=costs)
    assert tb == int(starts[-1]) == int(
        E.node_bits_of(off, costs, refs, skey).sum())
    assert tres == int(stats[7]) and tblk > 0 and tiv > 0
    owords = E.emit_offsets(starts[1:] - starts[:-1], s.offset_coding,
                            s.zeta_k)
    assert owords.dtype == torch.int32 and words.dtype == torch.int32


def _host_with_stats(g, tmp_path, name, s, monkeypatch, **kw):
    """:func:`_host` and the host store's ``_CompressionStats``."""
    kept = []
    write = BVGraph._write_properties.__func__

    def spy(cls, basename, n, settings, stats, *rest):
        kept.append(stats)
        return write(cls, basename, n, settings, stats, *rest)

    monkeypatch.setattr(BVGraph, "_write_properties", classmethod(spy))
    gb, ob, props = _host(g, tmp_path, name, s, **kw)
    monkeypatch.undo()
    (stats,) = kept
    return gb, ob, props, {k: v for k, v in vars(stats).items()
                           if k != "last_offset"}


def _assert_stats_equal(mine, host):
    assert mine.keys() == host.keys()
    for k, v in host.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


# (bytes of the last word that the streams fill, 0 for bits a multiple of
# 32; nodes, seed of erdos_renyi(nodes, 0.1)): both streams alike
LAST_WORD = [(1, 40, 17), (2, 40, 22), (3, 40, 28), (0, 83, 18)]


@pytest.mark.parametrize("tail,n,seed", LAST_WORD)
def test_encode_last_word_bytes_and_stats(tmp_path, monkeypatch, tail, n,
                                          seed):
    """Streams whose last word holds 1, 2 or 3 bytes, or is whole: the
    bytes cut from the words swapped to file order, the bit counts and
    every stats field equal the host store's.  The stats follow the
    streams in the one read and are left in the host's byte order: a
    swapped int64 would not equal the host's count."""
    g = MutableGraph.erdos_renyi(n, 0.1, seed=seed)
    s = BVGraphSettings()
    gb, ob, props, host = _host_with_stats(g, tmp_path, "tail", s,
                                           monkeypatch, use_native=False)
    gbits, obits = int(props["graphbits"]), int(props["offsetbits"])
    for bits in (gbits, obits):
        assert bits % 32 == 0 if tail == 0 else (bits + 7) // 8 % 4 == tail
    dgb, dgbits, dob, dobits, stats = E.encode_device(*g.to_csr(), s,
                                                      device="cpu")
    assert (dgb, dgbits, dob, dobits) == (gb, gbits, ob, obits)
    assert type(dgb) is bytes and type(dob) is bytes
    _assert_stats_equal(stats, host)


# ----------------------------------------------------------------------
# the chunked selection of csrc/encode.cu's enc_select, in NumPy
# ----------------------------------------------------------------------


def select_model(costs, valid, maxref, chunk, rounds=K.SELECT_ROUNDS,
                 gain=K.SELECT_GAIN):
    """``enc_select``'s three phases in NumPy, ``chunk`` nodes a chunk:
    ``(refs, depths, (rounds run, nodes re-run, nodes walked))``.

    1. Each chunk runs from a guessed ring of zero depths.
    2. A round snapshots every chunk's incoming ring (the depths of the w
       nodes before it).  A chunk whose snapshot differs from the ring it
       last ran from re-runs from the snapshot, comparing each new depth
       with the stored one, and stops once the last w agree (a position
       before the chunk agrees where the two rings do).  Rounds go on
       while some chunk changed a depth that a later chunk's ring holds,
       at most ``rounds``, and from the third on only while the round
       before cut the chunks still changing by ``gain`` or more.
    3. If one still did, a walk from the first chunk whose ring changed,
       chunk after chunk, re-running as a repair each chunk whose ring
       differs from the one it last ran from."""
    rows = np.where(np.asarray(valid), np.asarray(costs), -1)
    n, cbs = rows.shape
    w = cbs - 1
    refs = np.zeros(n, np.int32)
    dep = np.zeros(n, np.int32)
    nch = -(-n // chunk)

    def ring_of(c):
        return np.array([dep[p] if p >= 0 else 0
                         for p in range(c * chunk - w, c * chunk)], np.int32)

    def run(lo, hi, ring, eq=None):
        """Nodes lo..hi - 1 from ``ring``, the depths of the w nodes
        before lo; with ``eq`` (the agreements so far) a repair:
        (nodes run, whether a depth of the last w nodes changed)."""
        ran, tail = 0, False
        for x in range(lo, hi):
            if eq is not None and eq >= w:
                break
            best, br, bd = -1, 0, -1
            for r in range(cbs):
                cr = rows[x, r]
                if cr >= 0 and (best < 0 or cr < best):
                    p = x - r
                    dr = dep[p] if p >= lo else ring[p - lo + w]
                    if r == 0 or dr < maxref:
                        best, br, bd = cr, r, dr if r else -1
            if eq is not None:
                same = bd + 1 == dep[x]
                eq = eq + 1 if same else 0
                tail |= not same and x >= hi - w
            refs[x], dep[x] = br, bd + 1
            ran += 1
        return ran, tail

    def repair(c, s):
        eq = 0
        while s[w - 1 - eq] == last[c][w - 1 - eq]:
            eq += 1
        last[c] = s
        return run(c * chunk, min(n, (c + 1) * chunk), s, eq)

    for c in range(nch):
        run(c * chunk, min(n, (c + 1) * chunk), np.zeros(w, np.int32))
    last = np.zeros((nch, w), np.int32)  # the ring each chunk last ran from
    nrounds = rerun = walked = 0
    changed, before = [], None
    for k in range(1, rounds + 1 if nch > 1 else 1):
        if k > 2 and before - len(changed) < gain:
            break
        before, nrounds = len(changed), k
        snaps = [ring_of(c) for c in range(nch)]
        changed = []
        for c in range(1, nch):
            if not np.array_equal(snaps[c], last[c]):
                ran, tail = repair(c, snaps[c])
                rerun += ran
                if tail and c + 1 < nch:
                    changed.append(c)
        if not changed:
            break
    for c in range(min(changed) + 1, nch) if changed else ():
        s = ring_of(c)
        if not np.array_equal(s, last[c]):
            walked += repair(c, s)[0]
    return refs, dep, (nrounds, rerun, walked)


def _random_table(n, w, seed):
    """A cost table with ~30% of its slots no candidates and costs in
    0..3, so that ties are frequent."""
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 4, size=(n, w + 1), dtype=np.int32)
    valid = rng.random((n, w + 1)) >= 0.3
    return torch.from_numpy(costs), torch.from_numpy(valid)


def _chain_table(n, w):
    """Every node's cheapest candidate is the node before it: with an
    unbounded maxref each depth is its node's index, so every repair runs
    through its chunk."""
    costs = np.full((n, w + 1), 9, np.int32)
    costs[:, 1] = 1
    valid = np.arange(w + 1)[None, :] <= np.arange(n)[:, None]
    return torch.from_numpy(costs), torch.from_numpy(valid)


def _chains_table(n, w, chunk):
    """Chains of three and a half chunks, one starting in every fourth
    chunk, no reference elsewhere: the second round settles one chunk of
    each (ten, over ``SELECT_GAIN``), so a third runs and settles them."""
    costs, valid = _chain_table(n, w)
    x = np.arange(n)
    costs[(x % (4 * chunk)) >= 7 * chunk // 2, 1] = 9
    return costs, valid


def _gap_table(n, w, chunk):
    """Two chains of fifteen chunks, from the start and from the middle,
    no reference between them: the walk re-runs the first, passes the
    chunks between as they stand, and re-runs the second."""
    costs, valid = _chain_table(n, w)
    x = np.arange(n) % (n // 2)
    costs[x >= 15 * chunk, 1] = 9
    return costs, valid


def _flat_table(n, w):
    """Random costs, but no node's w last nodes has a reference: each
    chunk's guessed ring of zeros holds."""
    costs, valid = _random_table(n, w, 5)
    valid[:, 1:] = False
    return costs, valid


SELECT_CASES = [(w, mr) for w in (0, 1, 7, 12) for mr in (0, 1, 3, MAXREF_INF)]


@pytest.mark.parametrize("chunk", [1, 3, 8, 128])
@pytest.mark.parametrize("w,maxref", SELECT_CASES)
def test_select_model_matches_plain(chunk, w, maxref):
    """The model's refs and depths equal ``enc_select_plain``'s at every
    chunk length, the nodes before a chunk included in its ring where the
    chunk is shorter than the window."""
    for n, seed in ((1, 0), (chunk + 1, 1), (600, 2)):
        costs, valid = _random_table(n, w, seed)
        refs, depths, _ = select_model(costs, valid, maxref, chunk)
        pr, pd = K.enc_select_plain(costs, valid, maxref)
        assert np.array_equal(refs, pr.numpy()), (n, chunk)
        assert np.array_equal(depths, pd.numpy()), (n, chunk)


@pytest.mark.parametrize("chunk", [3, 8, 128])
def test_select_model_counts(chunk):
    """A chain through every chunk runs two rounds (the second settles
    one chunk) and walks the rest; ten chains of three and a half chunks
    settle in three rounds or more; two chains with chunks between them
    walk each chain and none between; a table whose guesses hold re-runs
    nothing."""
    n = 40 * chunk + 5
    costs, valid = _chain_table(n, 7)
    refs, depths, (rounds, rerun, walked) = select_model(
        costs, valid, MAXREF_INF, chunk)
    assert np.array_equal(depths, np.arange(n)) and rounds == 2
    assert walked == n - 3 * chunk and rerun > 0
    costs, valid = _chains_table(n, 7, chunk)
    refs, depths, (rounds, rerun, walked) = select_model(
        costs, valid, MAXREF_INF, chunk)
    pr, pd = K.enc_select_plain(costs, valid, MAXREF_INF)
    assert np.array_equal(refs, pr.numpy()) and np.array_equal(depths, pd)
    assert rounds >= 3 and walked == 0 and rerun > 0
    costs, valid = _gap_table(n, 7, chunk)
    refs, depths, (rounds, rerun, walked) = select_model(
        costs, valid, MAXREF_INF, chunk)
    pr, pd = K.enc_select_plain(costs, valid, MAXREF_INF)
    assert np.array_equal(refs, pr.numpy()) and np.array_equal(depths, pd)
    assert rounds == 2 and 15 * chunk < walked <= 30 * chunk
    costs, valid = _flat_table(n, 7)
    assert select_model(costs, valid, 3, chunk)[2] == (1, 0, 0)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hub_graph():
    """An Erdős–Rényi background with two hubs of 2,500 arcs that share
    most of them (long merges, long copy blocks)."""
    g = MutableGraph(3000)
    src = MutableGraph.erdos_renyi(3000, 0.002, seed=1)
    off, succ = src.to_csr()
    for x in range(3000):
        for y in succ[off[x]:off[x + 1]]:
            g.add_arc(x, int(y))
    for y in range(0, 3000, 1):
        if y % 6:
            g.add_arc(10, y)
        if y % 5:
            g.add_arc(11, y)
    return g.immutable_view()


CARD_GRAPHS = [
    ("hub", _hub_graph, dict(window_size=7, max_ref_count=3,
                             min_interval_length=3)),
    ("deep-chain-2000", lambda: deep_chain_graph(2000),
     dict(window_size=7, max_ref_count=MAXREF_INF, min_interval_length=2)),
    ("window-12", lambda: MutableGraph.erdos_renyi(300, 0.05, seed=9),
     dict(window_size=12, max_ref_count=4, min_interval_length=2)),
]


def _on(device, g):
    off, succ = g.to_csr()
    return (torch.as_tensor(np.asarray(off, dtype=np.int64), device=device),
            torch.as_tensor(np.asarray(succ, dtype=np.int32), device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("name,gen,kw", CARD_GRAPHS + [
    (f"{n}-{w}-{mr}-{mi}", gen, dict(window_size=w, max_ref_count=mr,
                                     min_interval_length=mi))
    for n, gen in GENERATORS for w, mr, mi in SETTINGS])
def test_kernels_match_plain_gpu(cuda, name, gen, kw):
    """Each kernel against its plain version on the same card tensors,
    exactly, with shard_start 0 and 5."""
    s = BVGraphSettings(**kw)
    skey = E.skey_of(s)
    off, succ = _on(cuda, gen())
    for shard in (0, 5):
        costs, valid = K.enc_costs(off, succ, skey, shard)
        pc, pv = K.enc_costs_plain(off, succ, skey, shard)
        assert torch.equal(costs, pc) and torch.equal(valid, pv), name
    refs, depths = K.enc_select(costs, valid, s.max_ref_count)
    pr, pd = K.enc_select_plain(costs, valid, s.max_ref_count)
    assert torch.equal(refs, pr) and torch.equal(depths, pd), name
    nb = E.node_bits_of(off, costs, refs, skey)
    starts = torch.cat([nb.new_zeros(1), torch.cumsum(nb, 0)])
    opos = K.offset_positions(nb, s.offset_coding, s.zeta_k)
    out = []
    for emit in (K.enc_emit, K.enc_emit_plain):
        words = torch.zeros(int(starts[-1]) // 32 + 3, dtype=torch.int32,
                            device=cuda)
        owords = torch.zeros(int(opos[-1]) // 32 + 3, dtype=torch.int32,
                             device=cuda)
        stats = torch.zeros(K.STATS + 1, dtype=torch.int64, device=cuda)
        emit(off, succ, refs, depths, starts, skey, stats, words=words,
             opos=opos, owords=owords, offset_coding=s.offset_coding)
        out.append((words, owords, stats))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b), name
    assert int(out[0][2][K.ERR]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,gen,kw", CARD_GRAPHS + [
    (f"{n}-{w}-{mr}-{mi}", gen, dict(window_size=w, max_ref_count=mr,
                                     min_interval_length=mi))
    for n, gen in GENERATORS for w, mr, mi in SETTINGS])
def test_encode_matches_host_store_gpu(cuda, tmp_path, name, gen, kw):
    launches = (K.enc_costs.launches, K.enc_select.launches,
                K.enc_emit.launches, E.encode_device.reads)
    _check(gen(), tmp_path, name, BVGraphSettings(**kw), device=cuda, host_kw={})
    after = (K.enc_costs.launches, K.enc_select.launches,
             K.enc_emit.launches, E.encode_device.reads)
    assert [b - a for a, b in zip(launches, after)] == [1, 1, 1, 2]


SELECT_SIZES = (1, K.SELECT_CHUNK - 1, K.SELECT_CHUNK, K.SELECT_CHUNK + 1,
                50_000)
SELECT_COUNTS = ("select_rounds", "select_rerun_nodes", "select_serial_nodes")


@pytest.mark.gpu
@pytest.mark.parametrize("w,maxref", SELECT_CASES)
def test_select_matches_plain_gpu(cuda, w, maxref):
    """``enc_select`` on random tables of each size equals
    ``enc_select_plain`` exactly, and its counts are the model's at the
    kernel's chunk length."""
    for n in SELECT_SIZES:
        costs, valid = _random_table(n, w, n)
        refs, depths = K.enc_select(costs.to(cuda), valid.to(cuda), maxref)
        pr, pd = K.enc_select_plain(costs, valid, maxref)
        assert torch.equal(refs.cpu(), pr) and torch.equal(depths.cpu(), pd), n
        assert tuple(K.enc_select.last_counts.tolist()) \
            == select_model(costs, valid, maxref, K.SELECT_CHUNK)[2], n


@pytest.mark.gpu
@pytest.mark.parametrize("table,maxref", [("chain", MAXREF_INF),
                                          ("chain", 3), ("chains", MAXREF_INF),
                                          ("gap", MAXREF_INF), ("flat", 3)])
def test_select_counts_gpu(cuda, table, maxref):
    """A chain through every chunk engages a second round and the walk;
    chains of three and a half chunks a third round; two chains with
    chunks between them the walk past chunks that stand; a table whose
    guesses hold re-runs nothing; one launch a call, and an encode
    records the call's counts on its ``encode.read_totals``."""
    n = 60 * K.SELECT_CHUNK + 7
    costs, valid = (_chain_table(n, 7) if table == "chain" else
                    _chains_table(n, 7, K.SELECT_CHUNK) if table == "chains"
                    else _gap_table(n, 7, K.SELECT_CHUNK) if table == "gap"
                    else _flat_table(n, 7))
    launches = K.enc_select.launches
    refs, depths = K.enc_select(costs.to(cuda), valid.to(cuda), maxref)
    assert K.enc_select.launches == launches + 1
    pr, pd = K.enc_select_plain(costs, valid, maxref)
    assert torch.equal(refs.cpu(), pr) and torch.equal(depths.cpu(), pd)
    counts = tuple(K.enc_select.last_counts.tolist())
    assert counts == select_model(costs, valid, maxref, K.SELECT_CHUNK)[2]
    rounds, rerun, walked = counts
    if table == "chain" and maxref == MAXREF_INF:
        assert rounds == 2 and walked == n - 3 * K.SELECT_CHUNK
    if table == "chains":
        assert rounds == 3 and walked == 0
    if table == "gap":
        c = K.SELECT_CHUNK
        assert rounds == 2 and 15 * c < walked <= 30 * c
    if table == "flat":
        assert rounds <= 1 and rerun == 0 and walked == 0
    g = deep_chain_graph(3000)
    off, succ = _on(cuda, g)
    with timing.recording() as spans:
        E.encode_device(off, succ, BVGraphSettings(max_ref_count=maxref))
    (t,) = [s for s in spans if s.name == "encode.read_totals"]
    assert [t.counts[k] for k in SELECT_COUNTS] \
        == K.enc_select.last_counts.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("codings", CODINGS)
def test_encode_codings_gpu(cuda, tmp_path, codings):
    _check(MutableGraph.erdos_renyi(90, 0.08, seed=3), tmp_path, "codings",
           _codings(codings), device=cuda, host_kw={})


@pytest.mark.gpu
def test_encode_zeta_and_gaps_gpu(cuda, tmp_path):
    g = MutableGraph.erdos_renyi(80, 0.1, seed=5)
    for k in (1, 2, 4, 7):
        _check(g, tmp_path, f"zk{k}", BVGraphSettings(zeta_k=k), device=cuda,
               host_kw={})
    _check(_negative_first_gaps(), tmp_path, "neg", BVGraphSettings(), device=cuda,
           host_kw={})


@pytest.mark.gpu
def test_shard_start_and_store_device_gpu(cuda, tmp_path):
    g = MutableGraph.erdos_renyi(120, 0.06, seed=21)
    s = BVGraphSettings(window_size=4, max_ref_count=2, min_interval_length=2)
    off, succ = _on(cuda, g)
    assert E.encode_device(off, succ, s, shard_start=60)[:4] \
        == E.encode_device(off.cpu(), succ.cpu(), s, shard_start=60,
                           device="cpu")[:4]
    base = os.path.join(tmp_path, "dev")
    props = E.store_device(g, base, settings=s)
    assert props == BVGraph.store(g, os.path.join(tmp_path, "h"), settings=s)


@pytest.mark.gpu
def test_page_locked_read_is_shared_by_no_result_gpu(cuda, tmp_path,
                                                     monkeypatch):
    """Graph A, then graph B whose streams take as many words, so B's read
    reuses the page-locked block that held A's: A's bytes and stats are
    unchanged after it and still equal the host store's.  Each read lands
    whole in page-locked memory."""
    s = BVGraphSettings()
    a, b = (MutableGraph.erdos_renyi(200, 0.05, seed=k) for k in (4, 7))
    agb, aob, _, ahost = _host_with_stats(a, tmp_path, "a", s, monkeypatch,
                                          use_native=False)
    with timing.recording() as spans:
        ga, gbits_a, oa, obits_a, sa = E.encode_device(*_on(cuda, a), s,
                                                       device=cuda)
        kept = (bytes(bytearray(ga)), bytes(bytearray(oa)),
                {k: np.copy(v) for k, v in sa.items()})
        gb, gbits_b, ob, obits_b, _ = E.encode_device(*_on(cuda, b), s,
                                                      device=cuda)
    words = [(x + 31) // 32 + (y + 31) // 32
             for x, y in ((gbits_a, obits_a), (gbits_b, obits_b))]
    assert words[0] == words[1] and (ga, oa) != (gb, ob)
    assert (ga, oa) == kept[:2] == (agb, aob)
    _assert_stats_equal(sa, kept[2])
    _assert_stats_equal(sa, ahost)
    reads = [sp.counts for sp in spans if sp.name == "encode.read_streams"]
    assert len(reads) == 2
    for c in reads:
        assert c["pinned_bytes"] == c["d2h_bytes"] > 0


@pytest.mark.gpu
def test_unsupported_device_and_settings_raise(cuda):
    off, succ = _on(cuda, MutableGraph.directed_cycle(10))
    bad = E.skey_of(BVGraphSettings())[:5] + (0, 7, 3, 3)  # zeta_k 0
    with pytest.raises(ValueError):
        K.enc_costs(off, succ, bad)
    with pytest.raises(ValueError):
        K.enc_costs(off.cpu(), succ, E.skey_of(BVGraphSettings()))
