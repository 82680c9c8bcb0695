"""``hll_pull``: HyperBall's register max by pull over an out-CSR, with the
HyperLogLog estimate, the centrality accumulators and the neighbourhood
function fused in; its plain PyTorch versions and its wrappers.

Registers are ``uint8[n, 2**log2m]``, the JAX package's layout
(``webgraph_tpu/algo/hll.py``).  Iteration ``T`` computes, from ``regs``::

    new[x]  = max(regs[x], max of regs[y] over the successors y of x)
    flag[x] = new[x] != regs[x]
    where flag[x]:  c = estimate(new[x]); inc = c - cur[x]; cur[x] = c
                    sum_of_distances[x] += T inc
                    sum_of_inverse_distances[x] += inc / T
                    discounted[d][x] += f_d(T) inc
    nf = sum of w[x] cur[x]

in float64 (``algo/hll.py::estimate_rows`` is the estimate).  In a
systolic iteration the successors whose flag of the iteration before is 0
are left out, which gives the same registers.  It serves
``algo/hyperball_device.py`` in the place of the JAX package's
``hyperball_step``, ``hyperball_step_systolic`` and the rest of
``HyperBallJax.iterate`` (``webgraph_tpu/algo/hyperball_jax.py:38, 49,
109``), which XLA runs as a gather and a ``segment_max`` over all m arcs
and two host reads an iteration.

:func:`hll_levels` runs iterations until one changes no row, the NF's rise
falls under a threshold, or a cap, all of them in one launch of the kernel
(``csrc/hyperball.cu``), which stops on the device; the host reads the
iterations run and each one's modified count, NF and systolic choice once
a launch.  A launch holds at most ``levels_per_launch`` iterations (the
size of its count arrays): a longer run goes on in a further launch from
the state the last one left.  :func:`hll_pull` is one iteration of the
registers alone, on the same kernel.

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise (the kernel takes ``4 <= log2m <= 10``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from webgraph_tpu_torch.algo.hll import estimate_rows
from webgraph_tpu_torch.kernels import _build
from webgraph_tpu_torch.kernels.propagate import _in_targets, pull_order

LEVELS = 1024  # iterations a launch: the size of its count arrays
LOG2M_MIN, LOG2M_MAX = 4, 10  # the kernel's range (the plain versions: >= 4)
_PARTS = 2048  # NF partial slots an iteration (csrc/hyperball.cu MAXB)


@dataclass
class HllState:
    """A HyperBall run on one device, updated in place by :func:`hll_levels`.

    ``registers`` and ``modified`` are the run's buffers: the kernel
    ping-pongs them with ``spare`` and ``spare_modified`` (made at its first
    launch), so copy them to keep them past the next iteration."""

    registers: torch.Tensor  # uint8[n, 2**log2m]
    modified: torch.Tensor   # bool[n]: the rows the last iteration changed
    current: torch.Tensor    # float64[n]: each counter's estimate
    alpha_mm: float
    weights: torch.Tensor | None = None  # float64[n]; None: every weight 1
    sum_of_distances: torch.Tensor | None = None          # float64[n]
    sum_of_inverse_distances: torch.Tensor | None = None  # float64[n]
    discounted: torch.Tensor | None = None  # float64[D, n]
    iteration: int = 0       # iterations run
    modified_count: int = 0  # rows the last iteration changed
    nf: float = 0.0          # the last iteration's NF
    spare: torch.Tensor | None = None
    spare_modified: torch.Tensor | None = None


class HllRun(NamedTuple):
    """What :func:`hll_levels` returns, by iteration, on the host."""

    levels: int                # iterations run
    modified: torch.Tensor     # int64[levels]: rows each one changed
    nf: torch.Tensor           # float64[levels]: the NF after each
    systolic: torch.Tensor     # bool[levels]: whether each ran systolic


def _log2m(regs: torch.Tensor) -> int:
    m = regs.shape[1] if regs.dim() == 2 else 0
    return m.bit_length() - 1 if m > 0 and m & (m - 1) == 0 else -1


def _check(offsets, succ, regs, modified, what):
    """Raise ValueError unless the out-CSR, the registers (uint8[n, 2**log2m],
    log2m >= 4; at most 10 on a CUDA device) and ``modified`` (bool[n]) are
    contiguous, on one device, of matching sizes."""
    dev = regs.device
    lg = _log2m(regs)
    if regs.dtype != torch.uint8 or lg < LOG2M_MIN or not regs.is_contiguous():
        raise ValueError(f"{what}: registers must be a contiguous uint8[n, "
                         f"2**log2m] tensor, log2m >= {LOG2M_MIN}, got "
                         f"{regs.dtype}{tuple(regs.shape)}")
    if dev.type == "cuda" and lg > LOG2M_MAX:
        raise ValueError(f"{what}: the kernel takes log2m {LOG2M_MIN}.."
                         f"{LOG2M_MAX}, got {lg}")
    n = regs.shape[0]
    for name, t, dtype, size in (("offsets", offsets, torch.int64, n + 1),
                                 ("succ", succ, torch.int32, None),
                                 ("modified", modified, torch.bool, n)):
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or t.dim() != 1 \
                or not t.is_contiguous() \
                or (size is not None and t.numel() != size):
            raise ValueError(
                f"{what}: {name} must be a contiguous 1-d {dtype} tensor "
                f"of {size if size is not None else 'any'} elements on {dev}")


def _check_state(offsets, succ, s: HllState, what):
    _check(offsets, succ, s.registers, s.modified, what)
    n = s.registers.shape[0]
    for name in ("current", "weights", "sum_of_distances",
                 "sum_of_inverse_distances"):
        t = getattr(s, name)
        if t is None and name == "current":
            raise ValueError(f"{what}: the state needs current")
        if t is not None and (t.device != s.registers.device
                              or t.dtype != torch.float64
                              or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"float64[{n}] tensor on {s.registers.device}")
    d = s.discounted
    if d is not None and (d.device != s.registers.device
                          or d.dtype != torch.float64 or d.dim() != 2
                          or d.shape[1] != n or not d.is_contiguous()):
        raise ValueError(f"{what}: discounted must be a contiguous "
                         f"float64[D, {n}] tensor on {s.registers.device}")


def _stop(prev: float, nf: float, modified: int, threshold: float) -> bool:
    """Whether a run stops after an iteration (HyperBall's run): it changed
    no row, or, with ``threshold >= 0``, the NF rose from ``prev`` by a share
    under it (the kernel's test, in the same float64 operations)."""
    return modified == 0 or (threshold >= 0 and prev != 0
                             and (nf - prev) / prev < threshold)


def hll_pull_plain(offsets, succ, regs, *, modified=None, state=None,
                   factors=()):
    """One HyperBall iteration in plain PyTorch, on any device: the gather
    ``regs[succ]``, a ``scatter_reduce_(amax, include_self=True)`` by
    source, the changed rows; with ``modified`` (bool[n], systolic) the arcs
    to a successor outside it left out.  With ``state`` (an
    :class:`HllState` of these registers) the float64 estimate of each
    changed row and the accumulators of iteration ``state.iteration + 1``,
    in place (``factors``: f_d of that iteration, one a discounted row);
    ``state.registers`` is not written.  Returns ``(new uint8[n, M],
    changed bool[n], nf)``, ``nf`` a float64 0-d tensor (None without
    ``state``)."""
    m = regs.shape[1]
    src, dst = _in_targets(offsets), succ.long()  # each arc's source
    if modified is not None:
        live = modified[dst]
        src, dst = src[live], dst[live]
    new = regs.clone()
    if dst.numel():
        new.scatter_reduce_(0, src.unsqueeze(1).expand(-1, m), regs[dst],
                            "amax", include_self=True)
    changed = (new != regs).any(dim=1)
    if state is None:
        return new, changed, None
    s, t = state, state.iteration + 1
    idx = changed.nonzero().view(-1)
    cnt = estimate_rows(new[idx], s.alpha_mm, m)
    inc = cnt - s.current[idx]
    s.current[idx] = cnt
    if s.sum_of_distances is not None:
        s.sum_of_distances[idx] += t * inc
    if s.sum_of_inverse_distances is not None:
        s.sum_of_inverse_distances[idx] += inc / t
    for d, f in enumerate(factors):
        s.discounted[d, idx] += f * inc
    nf = (s.current * s.weights if s.weights is not None else s.current).sum()
    return new, changed, nf


def _factors(fns, first: int, count: int):
    """f(T) for T in first .. first + count - 1, a row an iteration."""
    return [[float(f(t)) for f in fns] for t in range(first, first + count)]


def _steps_plain(offsets, succ, state, threshold, systolic_threshold, fns):
    """A step of :func:`_drive` by :func:`hll_pull_plain`, iteration by
    iteration."""
    n = state.registers.shape[0]

    def step(cap):
        s = state
        mods, nfs, syss = [], [], []
        for _ in range(cap):
            syst = systolic_threshold is not None \
                and s.modified_count / max(n, 1) < systolic_threshold
            factors = _factors(fns, s.iteration + 1, 1)[0]
            new, changed, nf = hll_pull_plain(
                offsets, succ, s.registers,
                modified=s.modified if syst else None, state=s,
                factors=factors)
            prev = s.nf
            s.registers, s.modified = new, changed
            s.iteration += 1
            s.modified_count, s.nf = int(changed.sum()), float(nf)
            mods.append(s.modified_count)
            nfs.append(s.nf)
            syss.append(syst)
            if _stop(prev, s.nf, s.modified_count, threshold):
                break
        return mods, nfs, syss

    return step


def _launch(succ, order, state, *, cap, threshold, systolic_threshold,
            fns, regs_only=False, out=None):
    """One launch of ``hll_pull`` (up to ``cap`` iterations); returns the
    stat tensor.  ``out`` (registers, flags) takes the one iteration of
    :func:`hll_pull` and leaves ``state`` as it is."""
    s = state
    n = s.registers.shape[0]
    dev = s.registers.device
    if out is None:
        if s.spare is None:
            s.spare = torch.empty_like(s.registers)
            s.spare_modified = torch.empty_like(s.modified)
        a, fa = s.spare, s.spare_modified
        b, fb = s.registers, s.modified  # iteration 1 writes them, 0 reads
    else:
        a, fa = out
        b, fb = a, fa
    nd = 0 if regs_only or s.discounted is None else s.discounted.shape[0]
    factors = None
    if nd:
        factors = torch.tensor(_factors(fns, s.iteration + 1, cap),
                               dtype=torch.float64).to(dev)
    stat = torch.zeros(2 + 3 * cap + 2 * _PARTS, dtype=torch.int64,
                       device=dev)

    def ptr(t):
        return None if t is None or regs_only else t.data_ptr()

    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.wgt_hll_pull(
            succ.data_ptr(), order[0].data_ptr(), order[1].data_ptr(),
            order[2].data_ptr(), n, _log2m(s.registers),
            s.registers.data_ptr(), a.data_ptr(), b.data_ptr(),
            s.modified.data_ptr(), fa.data_ptr(), fb.data_ptr(),
            ptr(s.current), ptr(s.weights), ptr(s.sum_of_distances),
            ptr(s.sum_of_inverse_distances),
            ptr(s.discounted) if nd else None, nd,
            factors.data_ptr() if nd else None, float(s.alpha_mm),
            int(s.modified_count), float(s.nf), float(threshold),
            int(systolic_threshold is not None),
            float(systolic_threshold if systolic_threshold is not None
                  else 0.0),
            int(s.iteration), int(cap), stat.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("wgt_hll_pull", rc)
    hll_pull.launches += 1
    return stat


def _steps_kernel(succ, order, state, threshold, systolic_threshold, fns):
    """A step of :func:`_drive` by one launch of ``hll_pull``: the state's
    buffers ping-pong with its spares."""

    def step(cap):
        s = state
        stat = _launch(succ, order, s, cap=cap, threshold=threshold,
                       systolic_threshold=systolic_threshold, fns=fns)
        head = stat[: 2 + 3 * cap].cpu()  # the launch's one host read
        run = int(head[0])
        mods = head[2: 2 + run].tolist()
        nfs = head[2 + cap: 2 + cap + run].view(torch.float64).tolist()
        syss = [bool(x) for x in head[2 + 2 * cap: 2 + 2 * cap + run]]
        if run % 2:  # the result lies in the spares
            s.registers, s.spare = s.spare, s.registers
            s.modified, s.spare_modified = s.spare_modified, s.modified
        s.iteration += run
        s.modified_count, s.nf = mods[-1], nfs[-1]
        return mods, nfs, syss

    return step


def _drive(step, state, max_levels, per_launch, threshold):
    """Arrays of ``per_launch`` iterations until a run stops (:func:`_stop`)
    or ``max_levels`` have run: ``step(cap) -> (modified, nf, systolic)``,
    lists of the iterations it ran, one host read each
    (:attr:`hll_levels.reads`)."""
    if max_levels < 0 or per_launch < 1:
        raise ValueError("hll_levels: max_levels must be >= 0 and "
                         "levels_per_launch >= 1")
    mods, nfs, syss, done = [], [], [], 0
    while done < max_levels:
        cap = min(per_launch, max_levels - done)
        prev = state.nf
        m, f, s = step(cap)
        hll_levels.reads += 1
        last_prev = f[-2] if len(f) > 1 else prev
        mods += m
        nfs += f
        syss += s
        done += len(m)
        if len(m) < cap or _stop(last_prev, f[-1], m[-1], threshold):
            break
    hll_levels.levels += done
    return HllRun(done, torch.tensor(mods, dtype=torch.int64),
                  torch.tensor(nfs, dtype=torch.float64),
                  torch.tensor(syss, dtype=torch.bool))


def hll_levels_plain(offsets, succ, state: HllState, *, max_levels,
                     threshold=-1.0, systolic_threshold=None,
                     discount_functions=(), levels_per_launch=LEVELS):
    """:func:`hll_levels` in plain PyTorch, on any device:
    :func:`hll_pull_plain` iteration by iteration."""
    _check_state(offsets, succ, state, "hll_levels")
    step = _steps_plain(offsets, succ, state, float(threshold),
                        systolic_threshold, list(discount_functions))
    return _drive(step, state, int(max_levels), int(levels_per_launch),
                  float(threshold))


def hll_levels(offsets, succ, state: HllState, *, max_levels, threshold=-1.0,
               systolic_threshold=None, discount_functions=(),
               levels_per_launch=LEVELS, order=None):
    """HyperBall iterations over the out-CSR ``(offsets int64[n+1], succ
    int32[m])`` from ``state`` (updated in place), until one changes no row,
    or with ``threshold >= 0`` the NF rises by a share under it, or
    ``max_levels`` have run.  An iteration runs systolic where
    ``systolic_threshold`` is given and the share of rows the iteration
    before changed is under it.  ``discount_functions``: one a row of
    ``state.discounted``, called on the host for a launch's iterations
    before it starts.  ``order``: :func:`kernels.propagate.pull_order` of
    ``offsets`` (``DeviceCSR.out_pull``), made here when not given.
    Returns an :class:`HllRun`.

    CPU tensors take :func:`hll_levels_plain`.  CUDA tensors launch
    ``hll_pull`` (``csrc/hyperball.cu``) once a ``levels_per_launch``
    iterations, counted in ``hll_pull.launches``, each followed by one host
    read (``hll_levels.reads``); a log2m outside 4..10, or a cooperative
    launch the card refuses, raises."""
    dev = state.registers.device
    if dev.type == "cpu":
        return hll_levels_plain(
            offsets, succ, state, max_levels=max_levels, threshold=threshold,
            systolic_threshold=systolic_threshold,
            discount_functions=discount_functions,
            levels_per_launch=levels_per_launch)
    if dev.type != "cuda":
        raise ValueError(f"hll_levels: unsupported device {dev}")
    _check_state(offsets, succ, state, "hll_levels")
    if order is None:
        order = pull_order(offsets)
    step = _steps_kernel(succ, order, state, float(threshold),
                         systolic_threshold, list(discount_functions))
    return _drive(step, state, int(max_levels), int(levels_per_launch),
                  float(threshold))


hll_levels.reads = 0   # host reads: one a launch (an iteration array)
hll_levels.levels = 0  # iterations run


def hll_pull(offsets, succ, regs, *, modified=None, order=None):
    """One HyperBall iteration of the registers ``regs`` (uint8[n,
    2**log2m], not written) over the out-CSR ``(offsets int64[n+1], succ
    int32[m])``; with ``modified`` (bool[n]) systolic, the successors
    outside it left out.  Returns ``(new uint8[n, 2**log2m], changed
    bool[n])``.  CPU tensors take :func:`hll_pull_plain`; CUDA tensors
    launch ``hll_pull`` (``csrc/hyperball.cu``) once, counted in
    ``hll_pull.launches``, and read nothing back."""
    _check(offsets, succ, regs, modified, "hll_pull")
    if regs.device.type == "cpu":
        new, changed, _ = hll_pull_plain(offsets, succ, regs,
                                         modified=modified)
        return new, changed
    if regs.device.type != "cuda":
        raise ValueError(f"hll_pull: unsupported device {regs.device}")
    n = regs.shape[0]
    flags = modified if modified is not None else torch.ones(
        n, dtype=torch.bool, device=regs.device)
    state = HllState(regs, flags, None, 0.0)
    out = (torch.empty_like(regs), torch.empty_like(flags))
    _launch(succ, order if order is not None else pull_order(offsets), state,
            cap=1, threshold=-1.0,
            systolic_threshold=math.inf if modified is not None else None,
            fns=(), regs_only=True, out=out)
    return out


hll_pull.launches = 0
