"""The port's copies of the host modules against their JAX-package
originals, on the graph set of tests/test_torch_bvgraph.py: the same bytes
from BVGraph.store (Python and native encoders), each package loading the
other's files, the same structure scan and the same NumPy decode.  Exact.

None of the modules compared here imports JAX; the JAX package's are
imported only as the reference."""

import hashlib
import os

import numpy as np
import pytest

from test_torch_bvgraph import GRAPHS
from webgraph_tpu.bits import bitstream as JBS
from webgraph_tpu.bits import codes as JC
from webgraph_tpu.bits import vcodes as JV
from webgraph_tpu.bits.elias_fano import EliasFanoMonotoneList as JEF
from webgraph_tpu.formats import bvgraph_np as J_np
from webgraph_tpu.formats.bvgraph import BVGraph as JBV
from webgraph_tpu.graph.builders import MutableGraph as JMG
from webgraph_tpu.graph.properties import load_properties as j_load_props
from webgraph_tpu.pallas.plan import scan_structure as j_scan
from webgraph_tpu.utils.rng import XoRoShiRo128PlusRandom as JRNG
import webgraph_tpu_torch as wgt
from webgraph_tpu_torch import native
from webgraph_tpu_torch.bits import bitstream as PBS
from webgraph_tpu_torch.bits import codes as PC
from webgraph_tpu_torch.bits import vcodes as PV
from webgraph_tpu_torch.bits.elias_fano import EliasFanoMonotoneList as PEF
from webgraph_tpu_torch.formats import bvgraph_np as P_np
from webgraph_tpu_torch.formats.bvgraph import BVGraph as PBV
from webgraph_tpu_torch.graph.builders import MutableGraph as PMG
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.graph.properties import store_properties
from webgraph_tpu_torch.kernels.plan import scan_structure as p_scan
from webgraph_tpu_torch.synth import weblike_graph
from webgraph_tpu_torch.utils.rng import XoRoShiRo128PlusRandom as PRNG

_EXT = (".graph", ".offsets", ".properties")


def _kw(name):
    return GRAPHS[name][1]


def _files(base):
    return {ext: open(base + ext, "rb").read() for ext in _EXT}


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """name -> (graph, port basename, JAX basename); both stored with the
    native encoders."""
    tmp = tmp_path_factory.mktemp("host")
    out = {}
    for name, (make, kw, _) in GRAPHS.items():
        g = make()
        pb, jb = os.path.join(tmp, f"p_{name}"), os.path.join(tmp, f"j_{name}")
        PBV.store(g, pb, **kw)
        JBV.store(g, jb, **kw)
        out[name] = (g, pb, jb)
    return out


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_store_writes_the_same_bytes(name, use_native, tmp_path):
    if use_native:
        assert native.available()
    g = GRAPHS[name][0]()
    pb, jb = os.path.join(tmp_path, "p"), os.path.join(tmp_path, "j")
    PBV.store(g, pb, use_native=use_native, **_kw(name))
    JBV.store(g, jb, use_native=use_native, **_kw(name))
    assert _files(pb) == _files(jb)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_each_package_loads_the_others_files(name, stored):
    g, pb, jb = stored[name]
    toff, tsucc = g.to_csr()
    for bv in (PBV.load(jb), JBV.load(pb), wgt.load(jb)):
        for backend in ("native", "numpy", "scalar"):
            off, succ = bv.to_csr(backend=backend)
            np.testing.assert_array_equal(off, toff)
            np.testing.assert_array_equal(succ, tsucc)
    np.testing.assert_array_equal(PBV.load(jb).bit_offsets,
                                  JBV.load(jb).bit_offsets)
    assert j_load_props(pb + ".properties") == j_load_props(jb + ".properties")


@pytest.mark.parametrize("name", list(GRAPHS))
def test_scan_and_numpy_decode_match(name, stored):
    _, pb, _ = stored[name]
    pbv, jbv = PBV.load(pb), JBV.load(pb)
    ps, js = p_scan(pbv), j_scan(jbv)
    for f in ("d", "ref", "block_count", "int_count", "res_count", "copied",
              "depth", "pos_after_ic"):
        a, b = getattr(ps, f), getattr(js, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(P_np.decode_to_csr(pbv), J_np.decode_to_csr(jbv)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_random_access_matches(stored):
    _, pb, _ = stored["deep_chains"]
    pbv, jbv = PBV.load(pb), JBV.load(pb)
    for x in range(0, pbv.num_nodes(), 7):
        np.testing.assert_array_equal(pbv.successors(x), jbv.successors(x))
        assert pbv.outdegree(x) == jbv.outdegree(x)


@pytest.mark.parametrize("coding,k", [
    (JC.GAMMA, 0), (JC.DELTA, 0), (JC.UNARY, 0), (JC.NIBBLE, 0),
    (JC.GOLOMB, 5), *[(JC.ZETA, k) for k in range(1, 8)]])
def test_codes_and_bitstreams_match(coding, k):
    rng = np.random.default_rng(coding * 10 + k)
    vals = np.concatenate([np.arange(40), rng.integers(0, 1 << 20, 300)])
    if coding == JC.UNARY:
        vals = vals % 200
    pobs, jobs = PBS.OutputBitStream(), JBS.OutputBitStream()
    for v in vals:
        assert pobs.write(coding, int(v), k) == jobs.write(coding, int(v), k)
        assert PC.code_length(coding, int(v), k) == \
            JC.code_length(coding, int(v), k)
    data = pobs.to_bytes()
    assert data == jobs.to_bytes()
    ibs = PBS.InputBitStream(data)
    assert [ibs.read(coding, k) for _ in vals] == [int(v) for v in vals]
    if coding in (JC.GAMMA, JC.DELTA, JC.ZETA, JC.UNARY):
        words = np.concatenate([PBS.bytes_to_words(data),
                                np.zeros(2, np.uint64)])
        pos = np.zeros(1, dtype=np.int64)
        pr, jr = PV.make_reader(coding, k), JV.make_reader(coding, k)
        for v in vals[:50]:
            (a, pa), (b, pbb) = pr(words, pos), jr(words, pos)
            assert int(a[0]) == int(b[0]) == int(v)
            assert int(pa[0]) == int(pbb[0])
            pos = pa


def test_elias_fano_and_properties_match(tmp_path):
    rng = np.random.default_rng(3)
    vals = np.cumsum(rng.integers(0, 1000, 5000)).astype(np.int64)
    pe, je = PEF(vals), JEF(vals)
    np.testing.assert_array_equal(pe.get_array(), je.get_array())
    assert [int(pe.get(i)) for i in range(0, 5000, 97)] == \
        [int(je.get(i)) for i in range(0, 5000, 97)]
    props = {"nodes": 5, "graphclass": "BVGraph", "comment": "a=b"}
    store_properties(os.path.join(tmp_path, "x.properties"), props)
    assert j_load_props(os.path.join(tmp_path, "x.properties")) == \
        {k: str(v) for k, v in props.items()}


def test_builders_match():
    for n, p, m, seed in ((200, 0.05, None, 1), (3000, 0.0, 30000, 11)):
        a = PMG.erdos_renyi(n, p, m=m, seed=seed).to_csr()
        b = JMG.erdos_renyi(n, p, m=m, seed=seed).to_csr()
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_load_maps_only_bvgraph(tmp_path):
    base = os.path.join(tmp_path, "ef")
    store_properties(base + ".properties",
                     {"graphclass": "it.unimi.dsi.webgraph.EFGraph"})
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        wgt.load(base)
    g = CSRGraph.from_lists([[1], [0, 2], []])
    PBV.store(g, os.path.join(tmp_path, "bv"))
    assert isinstance(wgt.load(os.path.join(tmp_path, "bv")), PBV)


def test_native_codec_builds_in_the_port(tmp_path):
    """g++ builds the port's codec into webgraph_tpu_torch/build/."""
    lib = native.get_lib()
    assert lib is not None
    assert os.path.dirname(lib._name) == native._BUILD_DIR


@pytest.mark.parametrize("seed", [0, 1, 42, 2**63 + 5])
def test_rng_matches(seed):
    """The port's XoRoShiRo128PlusRandom draws what the original draws:
    SpeedTest's nodes, and every other method, from the same seed."""
    p, j = PRNG(seed), JRNG(seed)
    assert [p.next_long() for _ in range(50)] == \
        [j.next_long() for _ in range(50)]
    for bound in (1, 2, 7, 1000, 325_557, 2**40 + 3):
        assert [p.next_int(bound) for _ in range(20)] == \
            [j.next_int(bound) for _ in range(20)]
    assert [p.next_long_signed() for _ in range(20)] == \
        [j.next_long_signed() for _ in range(20)]
    assert [p.next_double() for _ in range(20)] == \
        [j.next_double() for _ in range(20)]
    assert p.shuffle(list(range(100))) == j.shuffle(list(range(100)))
    with pytest.raises(ValueError):
        p.next_int(0)


def test_weblike_graph_is_unchanged_without_big_sites():
    """At big_sites 0 no extra random numbers are drawn: the graph is the
    one the bulk-decode cell has used since it was added."""
    g = weblike_graph(seed=0)
    assert (g.num_nodes(), g.num_arcs()) == (325_557, 3_218_945)
    h = hashlib.sha256(g.offsets.tobytes() + g.succ.tobytes()).hexdigest()
    assert h == ("c580d275b3c3257559c89aae4f6dfcb91b8402bc"
                 "61c1a6adfa32f27baefd3413")
    a = weblike_graph(20_000, seed=0, big_sites=0.005)
    b = weblike_graph(20_000, seed=0, big_sites=0.005)
    assert a.num_nodes() == 20_000
    np.testing.assert_array_equal(a.succ, b.succ)
    assert a.num_arcs() != weblike_graph(20_000, seed=0).num_arcs()


# ----------------------------------------------------------------------
# the analytics' host copies: transform/transform.py, algo/bfs.py, nf.py,
# components.py, centralities.py, sumsweep.py
# ----------------------------------------------------------------------

_SAME_SOURCE = ("transform/transform.py", "algo/bfs.py", "algo/nf.py",
                "algo/components.py", "algo/hyperball.py")


@pytest.mark.parametrize("rel", _SAME_SOURCE)
def test_analytics_copies_differ_only_in_imports(rel):
    """These copies are their originals with the package name changed."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    orig = open(os.path.join(here, "webgraph_tpu", rel)).read()
    copy = open(os.path.join(here, "webgraph_tpu_torch", rel)).read()
    assert copy == orig.replace("webgraph_tpu.", "webgraph_tpu_torch.")


def test_hll_copy_differs_only_in_estimate_rows():
    """algo/hll.py is its original up to ``estimate_rows``, the last
    function, whose JAX body the copy replaces with a torch one."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    orig = open(os.path.join(here, "webgraph_tpu", "algo", "hll.py")).read()
    copy = open(os.path.join(here, "webgraph_tpu_torch", "algo",
                             "hll.py")).read()
    cut = "\n\ndef estimate_rows("
    assert orig.count(cut) == copy.count(cut) == 1
    assert copy.split(cut)[0] == orig.split(cut)[0]
    assert "jax" in orig.split(cut)[1] and "jax" not in copy.split(cut)[1]


@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 3])
def test_register_init_matches(seed):
    from webgraph_tpu.algo import hll as JH
    from webgraph_tpu_torch.algo import hll as PH

    for n, log2m in ((0, 4), (1, 4), (500, 4), (333, 6), (100, 10)):
        np.testing.assert_array_equal(PH.register_init(n, log2m, seed),
                                      JH.register_init(n, log2m, seed))
    p, j = PH.HyperLogLogCounterArray(300, 5, seed), \
        JH.HyperLogLogCounterArray(300, 5, seed)
    assert p.alpha_mm == j.alpha_mm
    np.testing.assert_array_equal(p.counts(), j.counts())


def _both(n, p, seed):
    return (PMG.erdos_renyi(n, p, seed=seed), JMG.erdos_renyi(n, p, seed=seed))


def _same_csr(a, b):
    for x, y in zip(a.to_csr(), b.to_csr()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [3, 8])
def test_transform_copy_matches(seed):
    from webgraph_tpu.transform import transform as JT
    from webgraph_tpu_torch.transform import transform as PT

    pg, jg = _both(200, 0.03, seed)
    perm = np.random.default_rng(seed).permutation(200)
    perm[::9] = -1
    for f in ("transpose", "symmetrize", "simplify", "remove_dangling"):
        _same_csr(getattr(PT, f)(pg), getattr(JT, f)(jg))
    _same_csr(PT.map_graph(pg, perm), JT.map_graph(jg, perm))
    _same_csr(PT.transpose_offline(pg, batch_size=97),
              JT.transpose_offline(jg, batch_size=97))
    for f in ("gray_code_permutation", "lexicographical_permutation",
              "random_permutation"):
        np.testing.assert_array_equal(getattr(PT, f)(pg), getattr(JT, f)(jg))


@pytest.mark.parametrize("seed", [3, 8])
def test_bfs_nf_components_copies_match(seed):
    from webgraph_tpu.algo import bfs as JB
    from webgraph_tpu.algo import components as JCo
    from webgraph_tpu.algo import nf as JN
    from webgraph_tpu_torch.algo import bfs as PB
    from webgraph_tpu_torch.algo import components as PCo
    from webgraph_tpu_torch.algo import nf as PN

    pg, jg = _both(250, 0.01, seed)
    for s in (0, 7, [3, 100]):
        np.testing.assert_array_equal(PB.bfs_distances(pg, s),
                                      JB.bfs_distances(jg, s))
    pv, jv = PB.ParallelBreadthFirstVisit(pg), JB.ParallelBreadthFirstVisit(jg)
    pv.visit_all()
    jv.visit_all()
    assert pv.queue == jv.queue and pv.cut_points == jv.cut_points
    np.testing.assert_array_equal(pv.marker, jv.marker)
    np.testing.assert_array_equal(PN.NeighbourhoodFunction.compute(pg),
                                  JN.NeighbourhoodFunction.compute(jg))
    np.testing.assert_array_equal(
        PCo.StronglyConnectedComponents.compute(pg).component,
        JCo.StronglyConnectedComponents.compute(jg).component)
    np.testing.assert_array_equal(
        PCo.ConnectedComponents.compute(pg).component,
        JCo.ConnectedComponents.compute(jg).component)


def test_centralities_and_sumsweep_copies_match():
    """The host paths (use_device False) of the two copies that differ from
    their originals in their device branches."""
    from webgraph_tpu.algo import centralities as JCe
    from webgraph_tpu.algo import sumsweep as JS
    from webgraph_tpu_torch.algo import centralities as PCe
    from webgraph_tpu_torch.algo import sumsweep as PS

    pg, jg = _both(150, 0.03, 5)
    p, j = (PCe.GeometricCentralities(pg, 0.4).compute(),
            JCe.GeometricCentralities(jg, 0.4).compute())
    for f in ("closeness", "harmonic", "lin", "exponential", "reachable"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f))
    np.testing.assert_array_equal(
        PCe.BetweennessCentrality(pg).compute().betweenness,
        JCe.BetweennessCentrality(jg).compute().betweenness)
    c = np.array([0.0, 1.0, 0.5, 0.25])
    np.testing.assert_array_equal(
        PCe.LinearGeometricCentrality(pg, c).compute().centrality,
        JCe.LinearGeometricCentrality(jg, c).compute().centrality)
    for kind in ("HARMONIC", "LIN"):
        a = PCe.TopKGeometricCentrality.compute(pg, 5, kind)
        b = JCe.TopKGeometricCentrality.compute(jg, 5, kind)
        np.testing.assert_array_equal(a.top_k, b.top_k)
    for out in (PS.OutputLevel.RADIUS_DIAMETER, PS.OutputLevel.ALL):
        a = PS.SumSweepDirectedDiameterRadius(pg, out)
        b = JS.SumSweepDirectedDiameterRadius(jg, JS.OutputLevel(out.value))
        a.compute()
        b.compute()
        assert (a.get_diameter(), a.get_radius()) == \
            (b.get_diameter(), b.get_radius())
    u = PS.SumSweepUndirectedDiameterRadius(pg)
    v = JS.SumSweepUndirectedDiameterRadius(jg)
    u.compute()
    v.compute()
    assert (u.get_diameter(), u.get_radius()) == \
        (v.get_diameter(), v.get_radius())
