"""HyperBall on a torch device: the counterpart of
``webgraph_tpu/algo/hyperball_jax.py`` (its sharded step, ``HaloPlan``
``:176``, ``plan_halo`` ``:232`` and ``make_sharded_step`` ``:236``, is
ROADMAP A.12's).

The reference's hot loop (HyperBall.java:907-914: per node, per successor,
a broadword register max) is one kernel here, ``hll_pull``
(``kernels/hyperball.py``, ``csrc/hyperball.cu``): a pull over the
out-CSR, lanes a node by out-degree (``DeviceCSR.out_pull``), the
iterations of a run in one persistent launch.  Line by line:

* ``hyperball_step`` ``:38`` (a gather of ``regs[arc_dst]``, a
  ``segment_max`` by ``arc_src``) -> :func:`hyperball_step`, one
  iteration of ``kernels.hyperball.hll_pull`` over the CSR;
* ``hyperball_step_systolic`` ``:49`` (the arcs whose destination did not
  change routed to a sink) -> :func:`hyperball_step_systolic`, the same
  kernel skipping those successors;
* ``HyperBallJax`` ``:63`` -> :class:`HyperBallDevice`, with the same
  attributes and methods.  ``iterate`` ``:109`` (two host reads an
  iteration, ``:110`` and ``:135``; the estimate and the accumulators in
  XLA) is one launch capped at one iteration; ``run`` ``:140`` (an
  ``iterate`` and a read a loop) is one launch for up to
  ``kernels.hyperball.LEVELS`` iterations, which stops on the device on
  the same tests; the centralities ``:153-168`` read the accumulators
  back.

Registers are ``uint8[n, 2**log2m]`` as in the JAX package (byte for byte
the same after every iteration); the estimate, the accumulators, the
weights and the NF run in float64 (the JAX package's in float32, ``:88-91``;
the host ``HyperBall``'s in float64).  ``graph`` may be a ``DeviceCSR`` or
any graph: a ``BVGraph`` that a kernel decodes is decoded on the device
(``DeviceCSR.from_graph``: K1 on the card), so no host CSR is built.
"""

from __future__ import annotations

import numpy as np
import torch

from webgraph_tpu_torch.algo.device import DeviceCSR
from webgraph_tpu_torch.algo.hll import HyperLogLogCounterArray
from webgraph_tpu_torch.kernels.hyperball import (LEVELS, LOG2M_MAX, HllState,
                                                  hll_levels, hll_pull)


def hyperball_step(regs, offsets, succ):
    """One HyperBall iteration: ``regs'[x] = max(regs[x], max over succ(x)
    regs[y])`` over the out-CSR ``(offsets, succ)``.  Returns ``(new,
    changed)``."""
    return hll_pull(offsets, succ, regs)


def hyperball_step_systolic(regs, offsets, succ, modified):
    """Systolic variant: only successors whose counter changed last
    iteration (``modified``, bool[n]) are read (HyperBall.java:981-991).
    The same registers as the dense step."""
    return hll_pull(offsets, succ, regs, modified=modified)


class HyperBallDevice:
    """Device-resident HyperBall; mirrors ``HyperBallJax`` and the host
    ``HyperBall``, with bit-identical registers (same init, same max
    schedule).

    ``transpose`` (any value) enables systolic iterations, as in the JAX
    package: the mask is by successor, so the transpose itself is not
    read.  ``registers`` and ``modified`` are the run's buffers, which the
    next iteration may overwrite: copy them to keep them."""

    def __init__(self, graph, transpose=None, log2m: int = 6, seed: int = 0,
                 weights=None, do_sum_of_distances: bool = False,
                 do_sum_of_inverse_distances: bool = False,
                 discount_functions=None, systolic_threshold: float = 0.25,
                 device="cuda"):
        self.csr = (graph if isinstance(graph, DeviceCSR)
                    else DeviceCSR.from_graph(graph, device))
        dev = self.csr.device
        self.n = n = self.csr.n
        self.log2m = log2m
        self.seed = seed
        host = HyperLogLogCounterArray(n, log2m, seed)  # raises below 4
        if dev.type == "cuda" and log2m > LOG2M_MAX:
            raise ValueError(f"HyperBallDevice: the kernel takes log2m up to "
                             f"{LOG2M_MAX}, got {log2m}")
        self.systolic = transpose is not None
        self.systolic_threshold = systolic_threshold
        self.discount_functions = list(discount_functions or [])
        self.do_sum_of_distances = do_sum_of_distances
        self.do_sum_of_inverse_distances = do_sum_of_inverse_distances
        self.levels_per_launch = LEVELS
        w = None if weights is None else np.asarray(weights, dtype=np.float64)
        current = host.counts()
        nf0 = float((current * (w if w is not None else np.ones(n))).sum())

        def zeros(*shape):
            return torch.zeros(*shape, dtype=torch.float64, device=dev)

        self._state = HllState(
            registers=torch.from_numpy(host.registers).to(dev),
            modified=torch.ones(n, dtype=torch.bool, device=dev),
            current=torch.from_numpy(current).to(dev),
            alpha_mm=host.alpha_mm,
            weights=None if w is None else torch.from_numpy(w).to(dev),
            sum_of_distances=zeros(n) if do_sum_of_distances else None,
            sum_of_inverse_distances=(zeros(n) if do_sum_of_inverse_distances
                                      else None),
            discounted=zeros(len(self.discount_functions), n),
            modified_count=n, nf=nf0)
        self.alpha_mm = host.alpha_mm
        self.neighbourhood_function = [nf0]
        self.last_systolic = False

    # -- the state, as HyperBallJax names it ----------------------------

    @property
    def registers(self) -> torch.Tensor:
        return self._state.registers

    @property
    def modified(self) -> torch.Tensor:
        return self._state.modified

    @property
    def iteration(self) -> int:
        return self._state.iteration

    @property
    def sum_of_distances(self):
        return self._state.sum_of_distances

    @property
    def sum_of_inverse_distances(self):
        return self._state.sum_of_inverse_distances

    @property
    def discounted_centralities(self) -> list:
        return list(self._state.discounted)

    @property
    def weights(self):
        return self._state.weights

    # -- iterations -----------------------------------------------------

    def _levels(self, cap: int, threshold: float):
        res = hll_levels(
            self.csr.offsets, self.csr.dst, self._state, max_levels=cap,
            threshold=threshold,
            systolic_threshold=(self.systolic_threshold if self.systolic
                                else None),
            discount_functions=self.discount_functions,
            levels_per_launch=self.levels_per_launch,
            order=self.csr.out_pull if self.csr.device.type == "cuda"
            else None)
        self.neighbourhood_function.extend(res.nf.tolist())
        if res.levels:
            self.last_systolic = bool(res.systolic[-1])
        return res

    def iterate(self) -> None:
        """One iteration: one launch capped at one iteration."""
        self._levels(1, -1.0)

    def modified_counters(self) -> int:
        return self._state.modified_count

    def run(self, upper_bound: int = 2**31 - 1,
            threshold: float = -1.0) -> list[float]:
        """Iterate until no counter changes, the relative rise of the NF
        falls under ``threshold`` (``threshold >= 0``), or ``upper_bound``
        iterations (at most n): one launch a
        ``kernels.hyperball.LEVELS`` iterations, one host read each."""
        cap = min(upper_bound, self.n)
        if cap > 0:
            self._levels(cap, threshold)
        return self.neighbourhood_function

    # -- derived outputs (HyperBall.java:271-279) -----------------------

    def closeness_centrality(self):
        if self.sum_of_distances is None:
            raise RuntimeError("run with do_sum_of_distances=True")
        s = self.sum_of_distances.cpu().numpy()
        with np.errstate(divide="ignore"):
            c = 1.0 / s
        c[~np.isfinite(c)] = 0.0
        return c

    def harmonic_centrality(self):
        if self.sum_of_inverse_distances is None:
            raise RuntimeError("run with do_sum_of_inverse_distances=True")
        return self.sum_of_inverse_distances.cpu().numpy().copy()

    def reachable_nodes(self):
        return self._state.current.cpu().numpy().copy()

    # -- a run carried over from the JAX package ------------------------

    @classmethod
    def from_jax_state(cls, arrays, graph, **kwargs) -> "HyperBallDevice":
        """A port object that goes on with a ``HyperBallJax`` run: ``arrays``
        holds the JAX object's state as NumPy arrays (``registers``,
        ``modified``, ``_current``, ``iteration``,
        ``neighbourhood_function``, and where kept ``sum_of_distances``,
        ``sum_of_inverse_distances``, ``discounted_centralities``);
        ``graph`` and ``kwargs`` are the constructor's, as the JAX object was
        made."""
        hb = cls(graph, **kwargs)
        s = hb._state
        dev = s.registers.device
        regs = np.asarray(arrays["registers"], dtype=np.uint8)
        if regs.shape != tuple(s.registers.shape):
            raise ValueError(f"from_jax_state: registers of shape "
                             f"{regs.shape}, the graph and log2m give "
                             f"{tuple(s.registers.shape)}")

        def f64(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.float64)).to(dev)

        s.registers = torch.from_numpy(regs.copy()).to(dev)
        s.modified = torch.from_numpy(
            np.asarray(arrays["modified"], dtype=bool).copy()).to(dev)
        s.spare = s.spare_modified = None
        s.modified_count = int(np.asarray(arrays["modified"]).sum())
        s.current = f64(arrays["_current"])
        s.iteration = int(arrays["iteration"])
        hb.neighbourhood_function = [
            float(v) for v in arrays["neighbourhood_function"]]
        s.nf = hb.neighbourhood_function[-1]
        if s.sum_of_distances is not None:
            s.sum_of_distances = f64(arrays["sum_of_distances"])
        if s.sum_of_inverse_distances is not None:
            s.sum_of_inverse_distances = f64(
                arrays["sum_of_inverse_distances"])
        if hb.discount_functions:
            s.discounted = f64(np.stack(
                [np.asarray(a) for a in arrays["discounted_centralities"]]))
        return hb
