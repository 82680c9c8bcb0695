"""The benchmark's input makers and its work arithmetic (CPU)."""

import os

import numpy as np
import pytest

from benchmark import harness, work
from benchmark.reference import encoder, generator

SIZES = dict(window_size=7, max_ref_count=3, min_interval_length=3, zeta_k=3)


SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CONFIGS = {c["name"]: harness.load_json(os.path.join(harness.ROOT, c["file"]))
           for c in SPEC["configs"]}
TINY = dict(next(iter(CONFIGS.values()))["graph"], nodes=5000,
            hubs={"lengths": [100, 300], "copy_drop": 0.02})


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 7, -5])
def test_generator_is_deterministic_by_seed(seed):
    a = generator.weblike_graph(5000, generator.seed_of(seed), TINY)
    b = generator.weblike_graph(5000, generator.seed_of(seed), TINY)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = generator.weblike_graph(5000, generator.seed_of(seed + 1), TINY)
    assert not np.array_equal(a[1][:1000], c[1][:1000])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generator_gives_a_sorted_csr_without_loops(name):
    graph = dict(CONFIGS[name]["graph"], nodes=100_000)
    off, succ = generator.weblike_graph(100_000, 3, graph)
    n = off.size - 1
    assert off[0] == 0 and off[-1] == succ.size and (np.diff(off) >= 0).all()
    node = np.repeat(np.arange(n), np.diff(off))
    key = node.astype(np.int64) * n + succ
    assert (np.diff(key) > 0).all()  # sorted and without repeats
    assert ((succ >= 0) & (succ < n) & (succ != node)).all()


@pytest.mark.parametrize("seed", [1, 2**33 + 7])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generated_graph_matches_the_published_statistics(name, seed):
    """At its full size, stored as the configuration states, the generated
    graph gives the published graph's arcs, bits/link, average reference
    chain depth and average reference distance, each within the
    configuration's tolerance."""
    conf = CONFIGS[name]
    off, succ = generator.make_graph(conf, seed)
    assert off.size - 1 == conf["published"]["nodes"]
    got = encoder.statistics(off, succ, conf["store"])
    for key, tol in conf["tolerance"].items():
        want = conf["published"][key]
        assert abs(got[key] / want - 1) <= tol, (key, got[key], want)


def test_every_seed_has_the_same_long_lists_copied_by_reference():
    """Each hub's list, of the same lengths for every seed, is followed by
    a near-copy of it, which BVGraph's greedy choice stores by reference
    to the hub (the copy's list is most of the hub's)."""
    spec = {"lengths": [400, 900], "copy_drop": 0.02}
    for seed in (4, 2**40 + 1):
        off, succ = generator.weblike_graph(
            20_000, seed, dict(TINY, nodes=20_000, hubs=spec))
        deg = np.diff(off)
        hubs = np.flatnonzero(deg >= 400)
        assert hubs.size == 4 and (hubs[1::2] == hubs[::2] + 1).all()
        for h in hubs[::2]:
            lst = set(succ[off[h]:off[h + 1]])
            cp = set(succ[off[h + 1]:off[h + 2]])
            assert cp <= lst and len(cp) >= 0.9 * len(lst)


def test_make_graph_reads_the_configuration():
    conf = {"graph": dict(TINY, nodes=3000)}
    off, succ = generator.make_graph(conf, 11)
    ref = generator.weblike_graph(3000, 11, conf["graph"])
    assert np.array_equal(off, ref[0]) and np.array_equal(succ, ref[1])
    with pytest.raises(ValueError):
        generator.make_graph({"graph": dict(conf["graph"], generator="x")}, 1)


def test_store_round_trips_through_the_port(tmp_path):
    """The frozen encoder's files load in the port and decode to the
    generator's CSR, byte for byte what the port's host store writes."""
    from webgraph_tpu_torch.formats.bvgraph import BVGraph
    from webgraph_tpu_torch.graph.csr import CSRGraph

    off, succ = generator.weblike_graph(6000, 5, TINY)
    sizes = encoder.store(str(tmp_path / "a"), off, succ, SIZES)
    assert sizes == {"nodes": 6000, "arcs": int(off[-1]),
                     "graph_bytes": os.path.getsize(tmp_path / "a.graph"),
                     "offsets_bytes": os.path.getsize(tmp_path / "a.offsets")}
    g = BVGraph.load(str(tmp_path / "a"))
    o2, s2 = g.to_csr(backend="numpy")
    assert np.array_equal(o2, off) and np.array_equal(s2, succ)
    BVGraph.store(CSRGraph(off, succ), str(tmp_path / "b"), **SIZES)
    for ext in (".graph", ".offsets"):
        assert (tmp_path / f"a{ext}").read_bytes() == \
            (tmp_path / f"b{ext}").read_bytes()


def test_codings_default_to_bvgraphs():
    c = encoder.codings({})
    assert c == {"OUTDEGREES": 2, "BLOCKS": 2, "RESIDUALS": 6,
                 "REFERENCES": 5, "BLOCK_COUNT": 2, "OFFSETS": 2}
    assert encoder.codings({"codings": {"RESIDUALS": "DELTA"}})[
        "RESIDUALS"] == 1


def test_work_on_a_hand_counted_graph(tmp_path):
    """Three nodes 0 -> {1, 2}, 1 -> {2}, 2 -> {0}: m = 4.  Stored with
    gamma outdegrees, unary references, zeta_3 residuals and no intervals,
    each node takes no reference (the cheapest): node 0 is 011 (d 2) 1
    (ref 0) 1011 (residual 1 - 0 -> 2) 100 (gap 0); node 1 is 010 1 1011
    (2 - 1 -> 2); node 2 is 010 1 1100 (0 - 2 -> 3): 27 bits, 4 bytes.
    The offsets are the gamma codes of 0, 11, 8, 8: 1 0001100 0001001
    0001001, 22 bits, 3 bytes."""
    off = np.array([0, 2, 3, 4], dtype=np.int64)
    succ = np.array([1, 2, 2, 0], dtype=np.int32)
    st = dict(SIZES, min_interval_length=0)
    gb, gbits, ob, obits = encoder.encode(off, succ, st)
    assert (gbits, obits) == (27, 22)
    assert gb == bytes([0b01111011, 0b10001011, 0b01101011, 0b10000000])
    assert ob == bytes([0b10001100, 0b00010010, 0b00100100])
    nbytes, ops = work.decode_work(3, 4, len(gb))
    assert (nbytes, ops) == (4 + 32 + 16 + 32, 4)
    nbytes, ops = work.encode_work(3, 4, len(gb), len(ob))
    assert (nbytes, ops) == (16 + 32 + 4 + 3, 4)
    assert work.least_s(85, 4) == 85 / 3.35e12
    assert work.least_s(1, 10**9) == 10**9 / 67e12
