"""The port's HyperBall on a device (webgraph_tpu_torch/algo/hyperball_device.py)
against the JAX package's (webgraph_tpu/algo/hyperball_jax.py) on the CPU,
on the graphs of tests/test_hyperball_jax.py (:17, :74, :101), inputs
from a seed with NumPy:

* registers and modified flags byte for byte after every iteration;
* the NF within rtol 1e-5 and the accumulators within rtol 1e-4, the
  tolerances of the JAX package's own test (its estimate, accumulators
  and NF run in float32, the port's in float64);
* the systolic run, iteration by iteration, ``last_systolic`` included;
* ``hyperball_step`` / ``hyperball_step_systolic`` on random registers;
* ``HyperBallDevice.from_jax_state``: a run started in JAX and finished in
  the port has the registers of one finished in JAX."""

import numpy as np
import pytest
import torch

from webgraph_tpu.algo import hyperball_jax as J
from webgraph_tpu.graph.builders import MutableGraph as JMG
from webgraph_tpu.transform.transform import transpose as j_transpose
from webgraph_tpu_torch.algo import hyperball_device as HD
from webgraph_tpu_torch.graph.builders import MutableGraph as PMG
from test_torch_algo import one_torch_thread  # noqa: F401  (autouse)

DISC = [lambda t: 0.5**t]
ACC = dict(weights=np.linspace(0.5, 2.0, 150), do_sum_of_distances=True,
           do_sum_of_inverse_distances=True, discount_functions=DISC)


def _graphs(n, p, seed):
    """The same Erdős–Rényi graph from each package's builder."""
    return JMG.erdos_renyi(n, p, seed=seed), PMG.erdos_renyi(n, p, seed=seed)


def _same(dev, jax_hb, what):
    np.testing.assert_array_equal(dev.registers.numpy(),
                                  np.asarray(jax_hb.registers), err_msg=what)
    np.testing.assert_array_equal(dev.modified.numpy(),
                                  np.asarray(jax_hb.modified), err_msg=what)
    assert dev.modified_counters() == jax_hb.modified_counters(), what


def _accumulators_close(dev, jax_hb):
    np.testing.assert_allclose(dev.neighbourhood_function,
                               jax_hb.neighbourhood_function, rtol=1e-5)
    np.testing.assert_allclose(dev.closeness_centrality(),
                               jax_hb.closeness_centrality(), rtol=1e-4)
    np.testing.assert_allclose(dev.harmonic_centrality(),
                               jax_hb.harmonic_centrality(), rtol=1e-4)
    np.testing.assert_allclose(dev.discounted_centralities[0].numpy(),
                               np.asarray(jax_hb.discounted_centralities[0]),
                               rtol=1e-4)
    np.testing.assert_allclose(dev.reachable_nodes(), jax_hb.reachable_nodes(),
                               rtol=1e-5)


def test_registers_match_jax_every_iteration():
    jg, pg = _graphs(200, 0.04, 11)
    jax_hb = J.HyperBallJax(jg, log2m=5, seed=3)
    dev = HD.HyperBallDevice(pg, log2m=5, seed=3, device="cpu")
    for it in range(8):
        jax_hb.iterate()
        dev.iterate()
        _same(dev, jax_hb, f"iteration {it}")
    assert dev.modified_counters() == 0
    np.testing.assert_allclose(dev.neighbourhood_function,
                               jax_hb.neighbourhood_function, rtol=1e-5)


def test_accumulators_match_jax():
    jg, pg = _graphs(150, 0.05, 2)
    jax_hb = J.HyperBallJax(jg, log2m=5, seed=7, **ACC)
    dev = HD.HyperBallDevice(pg, log2m=5, seed=7, device="cpu", **ACC)
    jax_hb.run(10)
    dev.run(10)
    assert dev.iteration == jax_hb.iteration
    _same(dev, jax_hb, "after run(10)")
    _accumulators_close(dev, jax_hb)


def test_systolic_matches_jax():
    jg, pg = _graphs(180, 0.03, 4)
    jax_hb = J.HyperBallJax(jg, transpose=j_transpose(jg), log2m=4, seed=9,
                            systolic_threshold=1.1)
    dev = HD.HyperBallDevice(pg, transpose=pg, log2m=4, seed=9,
                             systolic_threshold=1.1, device="cpu")
    for it in range(12):
        jax_hb.iterate()
        dev.iterate()
        assert dev.last_systolic == jax_hb.last_systolic
        _same(dev, jax_hb, f"systolic iteration {it}")
        if jax_hb.modified_counters() == 0:
            break
    assert dev.last_systolic and dev.modified_counters() == 0
    np.testing.assert_allclose(dev.neighbourhood_function,
                               jax_hb.neighbourhood_function, rtol=1e-5)


@pytest.mark.parametrize("log2m", [4, 6])
def test_steps_match_jax(log2m):
    jg, _ = _graphs(200, 0.04, 11)
    off, succ = jg.to_csr()
    rng = np.random.default_rng(log2m)
    regs = rng.integers(0, 20, size=(200, 1 << log2m)).astype(np.uint8)
    regs[rng.random(regs.shape) < 0.6] = 0
    modified = rng.random(200) < 0.2
    src = np.repeat(np.arange(200, dtype=np.int32), np.diff(off))
    dst = succ.astype(np.int32)
    t = (torch.from_numpy(regs), torch.from_numpy(off.astype(np.int64)),
         torch.from_numpy(dst))
    for got, want in (
            (HD.hyperball_step(*t), J.hyperball_step(regs, src, dst, 200)),
            (HD.hyperball_step_systolic(*t, torch.from_numpy(modified)),
             J.hyperball_step_systolic(regs, src, dst, modified, 200))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_from_jax_state_continues_the_run():
    """Three iterations in JAX, the rest in the port: the registers of a
    run finished in JAX, its NF and accumulators within the JAX package's
    tolerances."""
    jg, pg = _graphs(150, 0.05, 2)
    jax_hb = J.HyperBallJax(jg, log2m=5, seed=7, **ACC)
    for _ in range(3):
        jax_hb.iterate()
    arrays = {k: np.asarray(getattr(jax_hb, k)) for k in
              ("registers", "modified", "_current", "sum_of_distances",
               "sum_of_inverse_distances")}
    arrays.update(iteration=jax_hb.iteration,
                  neighbourhood_function=list(jax_hb.neighbourhood_function),
                  discounted_centralities=[
                      np.asarray(a) for a in jax_hb.discounted_centralities])
    dev = HD.HyperBallDevice.from_jax_state(arrays, pg, log2m=5, seed=7,
                                            device="cpu", **ACC)
    assert dev.iteration == 3
    _same(dev, jax_hb, "carried over")
    jax_hb.run()
    dev.run()
    assert dev.iteration == jax_hb.iteration > 3
    _same(dev, jax_hb, "finished")
    _accumulators_close(dev, jax_hb)
    with pytest.raises(ValueError, match="registers"):
        HD.HyperBallDevice.from_jax_state(arrays, pg, log2m=6, device="cpu")
