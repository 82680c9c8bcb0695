"""The port's HyperBall on a device (webgraph_tpu_torch/algo/hyperball_device.py,
kernels/hyperball.py) against the port's host ``HyperBall``
(algo/hyperball.py, the JAX package's host copy), on the CPU through the
kernel's plain versions:

* registers byte for byte and the modified flags after every iteration
  (Erdős–Rényi n 200 p 0.04, log2m 4, 5 and 8);
* the NF, closeness, harmonic and one discounted centrality with weights
  within rtol 1e-9 (both in float64; the sums differ in order only);
* systolic iterations equal to dense ones (threshold 1.1: always
  systolic), ``last_systolic`` as the host's;
* ``run(threshold=...)`` stopping on the host's iteration, ``upper_bound``,
  ``iterate()`` then ``run()``, a run split over launches of 2 iterations
  equal to one launch (a host read each);
* graphs with no nodes, no arcs, and self-loops; log2m < 4 raises;
* the torch ``estimate_rows`` against the host ``_estimate``.

Card twins (``gpu``) hold ``hll_pull`` to ``hll_pull_plain`` on the card
at log2m 4, 6, 8 and 10, systolic, with a hub past the block threshold,
over several launches, on graphs with no nodes, no arcs and self-loops,
and check that an unsupported log2m raises; they skip without a card.
The JAX package: tests/test_torch_hyperball_ref.py."""

import numpy as np
import pytest
import torch

from webgraph_tpu_torch.algo import hyperball_device as HD
from webgraph_tpu_torch.algo.hll import _estimate, estimate_rows
from webgraph_tpu_torch.algo.hyperball import HyperBall
from webgraph_tpu_torch.algo.hyperball_device import (HyperBallDevice,
                                                      hyperball_step,
                                                      hyperball_step_systolic)
from webgraph_tpu_torch.formats.bvgraph import BVGraph
from webgraph_tpu_torch.graph.builders import MutableGraph
from webgraph_tpu_torch.graph.csr import CSRGraph
from webgraph_tpu_torch.kernels import hyperball as K
from webgraph_tpu_torch.synth import weblike_graph
from webgraph_tpu_torch.transform.transform import transpose
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)

DISC = [lambda t: 0.5**t]


def _er():
    return MutableGraph.erdos_renyi(200, 0.04, seed=11)


def _pair(g, device="cpu", **kw):
    """The host HyperBall (dense) and the port's on ``device``, alike."""
    host = HyperBall(g, systolic_threshold=-1, **kw)
    return host, HyperBallDevice(g, device=device, **kw)


def _same_registers(dev, host, what):
    np.testing.assert_array_equal(dev.registers.cpu().numpy(),
                                  host.counters.registers, err_msg=what)
    np.testing.assert_array_equal(dev.modified.cpu().numpy(), host.modified,
                                  err_msg=what)


@pytest.mark.parametrize("log2m", [4, 5, 8])
def test_registers_match_host_every_iteration(log2m):
    host, dev = _pair(_er(), log2m=log2m, seed=3)
    for it in range(10):
        host.iterate()
        dev.iterate()
        _same_registers(dev, host, f"iteration {it}")
        assert dev.modified_counters() == host.modified_counters()
        assert dev.iteration == host.iteration == it + 1
    np.testing.assert_allclose(dev.neighbourhood_function,
                               host.neighbourhood_function, rtol=1e-9)
    np.testing.assert_allclose(dev.reachable_nodes(), host.reachable_nodes(),
                               rtol=1e-9)


def test_accumulators_match_host():
    """Closeness, harmonic, a discount function and weights
    (HyperBall.java:949-968, :259), all in float64."""
    g = MutableGraph.erdos_renyi(150, 0.05, seed=2)
    kw = dict(log2m=5, seed=7, weights=np.linspace(0.5, 2.0, 150),
              do_sum_of_distances=True, do_sum_of_inverse_distances=True,
              discount_functions=DISC)
    host, dev = _pair(g, **kw)
    host.run(10)
    dev.run(10)
    _same_registers(dev, host, "after run(10)")
    np.testing.assert_allclose(dev.neighbourhood_function,
                               host.neighbourhood_function, rtol=1e-9)
    np.testing.assert_allclose(dev.closeness_centrality(),
                               host.closeness_centrality(), rtol=1e-9)
    np.testing.assert_allclose(dev.harmonic_centrality(),
                               host.harmonic_centrality(), rtol=1e-9)
    np.testing.assert_allclose(dev.discounted_centralities[0].numpy(),
                               host.discounted_centralities[0], rtol=1e-9)


def test_systolic_matches_dense():
    """Systolic iterations (HyperBall.java:981-991) keep the dense
    registers; the choice is the host's, iteration by iteration."""
    g = MutableGraph.erdos_renyi(180, 0.03, seed=4)
    dense = HyperBallDevice(g, log2m=4, seed=9, device="cpu")
    syst = HyperBallDevice(g, transpose=transpose(g), log2m=4, seed=9,
                           systolic_threshold=1.1, device="cpu")
    hsys = HyperBall(g, transpose=transpose(g), log2m=4, seed=9,
                     systolic_threshold=1.1)
    went = False
    for _ in range(12):
        dense.iterate()
        syst.iterate()
        hsys.iterate()
        went |= syst.last_systolic
        assert syst.last_systolic == hsys.last_systolic
        assert torch.equal(dense.registers, syst.registers)
        _same_registers(syst, hsys, "systolic")
        if dense.modified_counters() == 0:
            break
    assert went and dense.modified_counters() == 0
    # a threshold that switches part way: dense first, systolic later
    part = HyperBallDevice(g, transpose=g, log2m=4, seed=9,
                           systolic_threshold=0.3, device="cpu")
    hpart = HyperBall(g, transpose=transpose(g), log2m=4, seed=9,
                      systolic_threshold=0.3)
    seen = []
    while True:
        part.iterate()
        hpart.iterate()
        seen.append(part.last_systolic)
        assert part.last_systolic == hpart.last_systolic
        if part.modified_counters() == 0:
            break
    assert not seen[0] and seen[-1]
    assert torch.equal(part.registers, dense.registers)


@pytest.mark.parametrize("threshold", [0.02, 0.1, 0.5])
def test_run_threshold_stops_on_the_hosts_iteration(threshold):
    host, dev = _pair(_er(), log2m=5, seed=3)
    host.run(threshold=threshold)
    dev.run(threshold=threshold)
    nf = host.neighbourhood_function
    rises = [(b - a) / a for a, b in zip(nf[:-1], nf[1:])]
    assert min(abs(r - threshold) for r in rises) > 1e-6  # no tie
    assert dev.iteration == host.iteration < 10
    _same_registers(dev, host, f"threshold {threshold}")
    np.testing.assert_allclose(dev.neighbourhood_function, nf, rtol=1e-9)


def test_upper_bound_and_iterate_then_run():
    host, dev = _pair(_er(), log2m=6, seed=1)
    host.run(upper_bound=3)
    dev.run(upper_bound=3)
    assert dev.iteration == host.iteration == 3
    _same_registers(dev, host, "upper_bound 3")
    host.iterate()
    dev.iterate()
    host.run()
    dev.run()
    assert dev.iteration == host.iteration and dev.modified_counters() == 0
    _same_registers(dev, host, "iterate then run")
    np.testing.assert_allclose(dev.neighbourhood_function,
                               host.neighbourhood_function, rtol=1e-9)


def test_split_launches_equal_one_launch():
    """Launches of 2 iterations (a host read each) give what one launch
    gives."""
    g = weblike_graph(600)
    kw = dict(log2m=5, seed=2, do_sum_of_distances=True,
              discount_functions=DISC, device="cpu")
    one = HyperBallDevice(g, **kw)
    split = HyperBallDevice(g, **kw)
    split.levels_per_launch = 2
    reads = K.hll_levels.reads
    one.run()
    between = K.hll_levels.reads
    split.run()
    assert between - reads == 1
    assert K.hll_levels.reads - between == -(-split.iteration // 2)
    assert one.iteration == split.iteration > 2
    assert torch.equal(one.registers, split.registers)
    assert one.neighbourhood_function == split.neighbourhood_function
    assert torch.equal(one.sum_of_distances, split.sum_of_distances)
    assert torch.equal(one.discounted_centralities[0],
                       split.discounted_centralities[0])


@pytest.mark.parametrize("name", ["no nodes", "no arcs", "self-loops"])
def test_degenerate_graphs(name):
    g = {"no nodes": lambda: CSRGraph.from_lists([]),
         "no arcs": lambda: CSRGraph.from_lists([[], [], [], []]),
         "self-loops": lambda: CSRGraph.from_lists(
             [[0, 1], [1], [2, 0], [3], []])}[name]()
    host, dev = _pair(g, log2m=4, seed=5, do_sum_of_distances=True)
    host.run()
    dev.run()
    assert dev.iteration == host.iteration
    _same_registers(dev, host, name)
    np.testing.assert_allclose(dev.neighbourhood_function,
                               host.neighbourhood_function, rtol=1e-9)
    host.iterate()  # one step more, as the JAX package allows
    dev.iterate()
    _same_registers(dev, host, name + ", one more")
    assert dev.neighbourhood_function[-1] == pytest.approx(
        host.neighbourhood_function[-1], rel=1e-9)


def test_log2m_below_4_raises():
    with pytest.raises(ValueError, match="log2m"):
        HyperBallDevice(_er(), log2m=3, device="cpu")
    regs = torch.zeros(3, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="log2m"):
        K.hll_pull(torch.zeros(4, dtype=torch.int64),
                   torch.zeros(0, dtype=torch.int32), regs)


@pytest.mark.parametrize("log2m", [4, 6, 10])
def test_estimate_rows_matches_the_host_estimate(log2m):
    rng = np.random.default_rng(log2m)
    m = 1 << log2m
    regs = rng.integers(0, 12, size=(300, m)).astype(np.uint8)
    regs[rng.random((300, m)) < 0.7] = 0
    regs[:5] = 0
    alpha_mm = 0.709 * m * m
    np.testing.assert_allclose(
        estimate_rows(torch.from_numpy(regs), alpha_mm, m).numpy(),
        _estimate(regs, alpha_mm, m), rtol=1e-13)


def test_steps_match_a_numpy_oracle():
    """hyperball_step / hyperball_step_systolic against a loop over the
    arcs."""
    g = MutableGraph.erdos_renyi(120, 0.05, seed=8)
    off, succ = g.to_csr()
    rng = np.random.default_rng(1)
    regs = rng.integers(0, 30, size=(120, 16)).astype(np.uint8)
    modified = rng.random(120) < 0.3
    for mask in (None, modified):
        want = regs.copy()
        for x in range(120):
            for y in succ[off[x]:off[x + 1]]:
                if mask is None or mask[y]:
                    want[x] = np.maximum(want[x], regs[y])
        args = (torch.from_numpy(regs), torch.from_numpy(off.astype(np.int64)),
                torch.from_numpy(succ.astype(np.int32)))
        new, changed = (hyperball_step(*args) if mask is None else
                        hyperball_step_systolic(*args,
                                                torch.from_numpy(mask)))
        np.testing.assert_array_equal(new.numpy(), want)
        np.testing.assert_array_equal(changed.numpy(),
                                      (want != regs).any(axis=1))


def test_out_pull_follows_the_out_degree():
    """``DeviceCSR.out_pull`` sorts the nodes by out-degree over the
    out-CSR, and ``reversed()`` swaps it with ``pull``."""
    from webgraph_tpu_torch.algo.device import DeviceCSR
    from webgraph_tpu_torch.kernels.propagate import pull_order

    csr = DeviceCSR.from_graph(weblike_graph(500), "cpu")
    order, bounds, span = csr.out_pull
    deg = csr.offsets[1:] - csr.offsets[:-1]
    assert torch.equal(deg[order.long()], deg.sort(stable=True).values)
    assert torch.equal(span[:, 1] - span[:, 0], deg[order.long()])
    assert torch.equal(span[:, 0], csr.offsets[order.long()])
    for a, b in zip(csr.out_pull, pull_order(csr.offsets)):
        assert torch.equal(a, b)
    t = csr.reversed()
    for a, b in zip(t.pull, csr.out_pull):
        assert torch.equal(a, b)
    for a, b in zip(t.out_pull, csr.pull):
        assert torch.equal(a, b)
    for a, b in zip(t.out_pull, pull_order(t.offsets)):
        assert torch.equal(a, b)


def test_bvgraph_decodes_through_the_device_route(tmp_path):
    g = weblike_graph(400)
    base = str(tmp_path / "g")
    BVGraph.store(g, base)
    launches = K.hll_pull.launches
    dev = HyperBallDevice(BVGraph.load(base), log2m=4, seed=1, device="cpu")
    host = HyperBall(g, log2m=4, seed=1, systolic_threshold=-1)
    dev.run()
    host.run()
    _same_registers(dev, host, "BVGraph input")
    assert K.hll_pull.launches == launches  # CPU tensors launch nothing


# ----------------------------------------------------------------------
# the kernel on the card against its plain version
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain(monkeypatch):
    """HyperBallDevice iterating through hll_levels_plain."""
    monkeypatch.setattr(HD, "hll_levels",
                        lambda *a, order=None, **kw: K.hll_levels_plain(*a,
                                                                         **kw))


def _hub_graph():
    """4,000 nodes: node 0 points at every other node (out-degree 3,999,
    past every log2m's block threshold), nodes 1..30 at 600-900 each, and
    a chain with a few random arcs besides."""
    rng = np.random.default_rng(5)
    n = 4_000
    src = [np.zeros(n - 1, np.int64), np.arange(1, n - 1)]
    dst = [np.arange(1, n), np.arange(2, n)]
    for x in range(1, 31):
        k = int(rng.integers(600, 900))
        src.append(np.full(k, x))
        dst.append(rng.integers(0, n, k))
    src.append(rng.integers(0, n, 8_000))
    dst.append(rng.integers(0, n, 8_000))
    return CSRGraph.from_arcs(np.concatenate(src), np.concatenate(dst), n=n,
                              dedup=True)


def _both(g, cuda, monkeypatch, iterate=3, **kw):
    """A kernel run and a plain run on the card: ``iterate`` single
    iterations compared each, then ``run()`` to the end; returns both."""
    kw = dict(seed=4, weights=np.linspace(0.1, 3.0, g.num_nodes()),
              do_sum_of_distances=True, do_sum_of_inverse_distances=True,
              discount_functions=DISC, device=cuda, **kw)
    got = HyperBallDevice(g, **kw)
    want = HyperBallDevice(g, **kw)
    for it in range(iterate + 1):
        launches = K.hll_pull.launches
        if it < iterate:
            got.iterate()
        else:
            got.run()
        torch.cuda.synchronize()
        assert K.hll_pull.launches == launches + 1
        with monkeypatch.context() as mp:
            _plain(mp)
            if it < iterate:
                want.iterate()
            else:
                want.run()
        assert K.hll_pull.launches == launches + 1
        assert got.iteration == want.iteration
        assert torch.equal(got.registers, want.registers), it
        assert torch.equal(got.modified, want.modified), it
        assert got.last_systolic == want.last_systolic
    np.testing.assert_allclose(got.neighbourhood_function,
                               want.neighbourhood_function, rtol=1e-9)
    for a, b in ((got.sum_of_distances, want.sum_of_distances),
                 (got.sum_of_inverse_distances, want.sum_of_inverse_distances),
                 (got._state.current, want._state.current),
                 (got.discounted_centralities[0],
                  want.discounted_centralities[0])):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=0)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("log2m", [4, 6, 8, 10])
def test_kernel_matches_plain_on_card(log2m, cuda, monkeypatch):
    got, _ = _both(weblike_graph(3_000), cuda, monkeypatch, log2m=log2m)
    assert got.modified_counters() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [1.1, 0.25])
def test_systolic_on_card(threshold, cuda, monkeypatch):
    g = weblike_graph(3_000)
    got, _ = _both(g, cuda, monkeypatch, transpose=g, log2m=6,
                   systolic_threshold=threshold)
    dense = HyperBallDevice(g, log2m=6, seed=4, device=cuda)
    dense.run()
    assert got.iteration == dense.iteration
    assert torch.equal(got.registers, dense.registers)


@pytest.mark.gpu
@pytest.mark.parametrize("log2m", [4, 9])
def test_hub_on_card(log2m, cuda, monkeypatch):
    _both(_hub_graph(), cuda, monkeypatch, log2m=log2m)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["no nodes", "no arcs", "self-loops"])
def test_degenerate_graphs_on_card(name, cuda, monkeypatch):
    g = {"no nodes": lambda: CSRGraph.from_lists([]),
         "no arcs": lambda: CSRGraph.from_lists([[], [], [], []]),
         "self-loops": lambda: CSRGraph.from_lists(
             [[0, 1], [1], [2, 0], [3], []])}[name]()
    got = HyperBallDevice(g, log2m=4, seed=5, do_sum_of_distances=True,
                          device=cuda)
    want = HyperBallDevice(g, log2m=4, seed=5, do_sum_of_distances=True,
                           device=cuda)
    got.run()
    got.iterate()
    with monkeypatch.context() as mp:
        _plain(mp)
        want.run()
        want.iterate()
    assert got.iteration == want.iteration
    assert torch.equal(got.registers, want.registers)
    assert torch.equal(got.modified, want.modified)
    np.testing.assert_allclose(got.neighbourhood_function,
                               want.neighbourhood_function, rtol=1e-9)


@pytest.mark.gpu
def test_multi_launch_run_on_card(cuda, monkeypatch):
    """A 1,500-node chain: iterations in launches of 64 (a host read each),
    the same as the plain version in one array."""
    n = 1_500
    g = CSRGraph.from_lists([[x + 1] for x in range(n - 1)] + [[]])
    got = HyperBallDevice(g, log2m=4, seed=2, do_sum_of_distances=True,
                          device=cuda)
    got.levels_per_launch = 64
    launches, reads = K.hll_pull.launches, K.hll_levels.reads
    got.run(threshold=0.0)
    runs = -(-got.iteration // 64)
    assert K.hll_pull.launches - launches == K.hll_levels.reads - reads \
        == runs > 2
    want = HyperBallDevice(g, log2m=4, seed=2, do_sum_of_distances=True,
                           device=cuda)
    with monkeypatch.context() as mp:
        _plain(mp)
        want.run(threshold=0.0)
    assert got.iteration == want.iteration
    assert torch.equal(got.registers, want.registers)
    np.testing.assert_allclose(got.neighbourhood_function,
                               want.neighbourhood_function, rtol=1e-9)
    torch.testing.assert_close(got.sum_of_distances, want.sum_of_distances,
                               rtol=1e-9, atol=0)


@pytest.mark.gpu
def test_unsupported_log2m_raises_on_card(cuda):
    from webgraph_tpu_torch.kernels import _build

    g = weblike_graph(200)
    launches = K.hll_pull.launches
    with pytest.raises(ValueError, match="log2m"):
        HyperBallDevice(g, log2m=11, device=cuda)
    regs = torch.zeros(200, 2048, dtype=torch.uint8, device=cuda)
    off, succ = (torch.as_tensor(a, device=cuda) for a in g.to_csr())
    with pytest.raises(ValueError, match="log2m"):
        K.hll_pull(off.long(), succ.int(), regs)
    assert K.hll_pull.launches == launches
    # the C entry point refuses a log2m outside 4..10 itself
    stat = torch.zeros(2 + 3 + 2 * K._PARTS, dtype=torch.int64, device=cuda)
    lib = _build.load()
    for log2m in (3, 11):
        rc = lib.wgt_hll_pull(
            succ.int().data_ptr(), None, None, None, 200, log2m,
            regs.data_ptr(), regs.data_ptr(), regs.data_ptr(), None, None,
            None, None, None, None, None, None, 0, None, 1.0, 0, 0.0, -1.0,
            0, 0.0, 0, 1, stat.data_ptr(), None)
        assert rc != 0
    assert int(stat.abs().sum()) == 0
