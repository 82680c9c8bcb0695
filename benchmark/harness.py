"""One run of one cell: set-up, the measured window, the check and the
metrics, driven by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* ``benchmark/configs/<config>.json`` (the ``file`` of the configuration's
  entry): the graph's sizes, its store parameters and guarantees;
* ``benchmark/traffic/<traffic>.json``: a mix's parameters, among them
  ``op``, the operation kind;
* ``benchmark/ops/<op>.py``: an operation kind (set-up, one timed call and
  the check of what the calls produced), shared by every mix of that kind;
* ``benchmark/metrics/<metric>.py``: the reader of one metric, ``read(run)``
  giving its value or None where it finds nothing to read.

A new configuration, mix or metric is a new file and a new entry; no file
here changes.  :func:`run_cell` takes the device, so the tests can drive a
run on the CPU through the port's plain versions; ``run.py`` takes the
card or refuses to run.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.reference import generator

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
TRACE_SECONDS = 3.0  # the longest traced window
POISON = -1          # written over freed output buffers before a checked call


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module named ``name``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, mix and
    operation kind loaded."""

    name: str
    workload: dict
    config: dict
    mix: dict
    op: object
    spec: dict
    root: str


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` under ``root``, its
    files found by the names the entry gives."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    work = [w for w in spec["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    config = load_json(os.path.join(root, conf["file"]))
    bench = os.path.join(root, "benchmark")
    mix = load_json(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    op = load_module(os.path.join(bench, "ops", mix["op"] + ".py"),
                     "benchmark_op_" + _ident(mix["op"]))
    return Cell(name, w, config, mix, op, spec, root)


def metric_entries(cell: Cell, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    group = cell.spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell.name in m.get("workloads", [cell.name])]


def read_metric(cell: Cell, name: str, run) -> float | None:
    path = os.path.join(cell.root, "benchmark", "metrics", name + ".py")
    return load_module(path, "benchmark_metric_" + _ident(name)).read(run)


@dataclass
class Context:
    """What an operation kind's functions get: the cell's configuration
    and mix, the seed, the device, the generator's CSR (the input and the
    plain reference) and a scratch directory under ``TMPDIR``."""

    cell: Cell
    seed: int
    device: str
    tmp: str
    offsets: np.ndarray
    succ: np.ndarray
    marks: dict = field(default_factory=dict)  # set-up steps, seconds

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def rng(self, stream: int) -> np.random.Generator:
        """A generator of the run's seed for one use (``stream``)."""
        return np.random.default_rng([generator.seed_of(self.seed), stream])

    @contextlib.contextmanager
    def mark(self, name: str):
        """Time a set-up step into :attr:`marks`."""
        t = time.perf_counter()
        yield
        self.marks[name] = time.perf_counter() - t


@dataclass
class Run:
    """What a metric reader gets."""

    op: str                  # the mix's operation kind
    setup_s: float           # from the start of run.py to the first call
    window_s: float          # host clock, first call's start to last's end
    ops: int                 # calls completed in the window
    failed: int              # calls that raised
    units: int               # work done by the completed calls
    latencies_s: list        # host clock, each call to its result
    least_s: float | None    # the least time of one call on one H100
    trace: object = None     # trace.Trace of a traced run
    # the port's host spans (``webgraph_tpu_torch.timing.Span``) that a
    # traced run recorded in its window and in ``op.setup``; None untraced
    spans: list | None = None
    setup_spans: list | None = None
    counters: dict | None = None  # op.counters()' change a call


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _poison(device: str, sizes) -> None:
    """Overwrite freed device blocks of ``sizes`` bytes, so that a checked
    call's outputs cannot hold a former call's answers."""
    if not device.startswith("cuda") or not sizes:
        return
    import torch

    held = [torch.full((s // 4,), POISON, dtype=torch.int32, device=device)
            for s in sizes]
    del held


def window(ctx: Context, state, seconds: float, keep: set, stamps=None):
    """Calls of the operation back to back for ``seconds``, each waited
    for: ``(Run fields, kept outputs)``; the outputs of the calls whose
    index is in ``keep``, and of the last call, are kept for the check.
    ``stamps``: a list that each call's ``(start, end)`` in
    ``time.time_ns()`` is added to (the traced run's host side)."""
    op, dev = ctx.cell.op, ctx.device
    sizes = op.poison_sizes(ctx, state)
    kept, lat, units, failed, last = {}, [], 0, 0, None
    i = 0
    start = time.perf_counter()
    while True:
        if i in keep:
            _poison(dev, sizes)
        ns = time.time_ns()
        a = time.perf_counter()
        try:
            out, done = op.step(ctx, state, i)
            _sync(dev)
        except Exception as e:  # a call that raises counts as failed
            failed += 1
            out, done = None, 0
            print(f"call {i} raised {type(e).__name__}: {e}", flush=True)
        b = time.perf_counter()
        if stamps is not None:
            stamps.append((ns, time.time_ns()))
        if out is not None:
            lat.append(b - a)
            units += done
            if i in keep:
                kept[i] = out
            last = (i, out)
        i += 1
        if b - start >= seconds:
            break
    if last is not None:
        kept[last[0]] = last[1]
    return dict(window_s=b - start, ops=i - failed, failed=failed,
                units=units, latencies_s=lat), kept


def sample(ctx: Context) -> set:
    """The calls whose outputs are checked besides the last: ``sample``
    indices drawn from the seed among the first ``among`` (the mix's
    ``check``)."""
    c = ctx.mix["check"]
    pick = ctx.rng(7).choice(int(c["among"]), size=int(c["sample"]),
                             replace=False)
    return {int(x) for x in pick}


def _quantiles(lat) -> dict:
    """Some quantiles of the calls' latencies, in milliseconds."""
    if not lat:
        return {}
    s = np.sort(np.asarray(lat)) * 1e3
    return {f"p{q}": float(s[int(np.ceil(q / 100 * s.size)) - 1])
            for q in (50, 90, 95, 99, 100)}


def control_checks(cell: Cell, seed: int, device: str) -> dict:
    """The numbers the check compares when the cell's control, the plain
    reference with one guarantee of the configuration broken
    (``op.control``), stands in the program's place for two calls."""
    with tempfile.TemporaryDirectory(prefix="wgt-bench-") as tmp:
        ctx = Context(cell, seed, device, tmp, None, None)
        ctx.offsets, ctx.succ = generator.make_graph(cell.config, seed)
        state = cell.op.setup(ctx)
        kept = {i: cell.op.control(ctx, state, i) for i in (0, 1)}
        return cell.op.check(ctx, state, kept)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
            t0: float):
    """One run of ``cell``: ``(Run, result)``, the :class:`Run` that the
    metric readers got and the result :func:`run_cell` gives.  With
    ``trace`` the port's host spans are recorded in ``op.setup`` and in
    the traced window, and the window's idle gaps inside the calls are
    named by the innermost span open over them; untraced, nothing is
    recorded and the port's spans stay off."""
    import torch

    from webgraph_tpu_torch import timing

    op = cell.op
    label = f"{cell.mix['op']} call"
    record = timing.recording if trace else contextlib.nullcontext
    with tempfile.TemporaryDirectory(prefix="wgt-bench-") as tmp:
        ctx = Context(cell, seed, device, tmp, None, None)
        with ctx.mark("make"):
            ctx.offsets, ctx.succ = generator.make_graph(cell.config, seed)
        with record() as setup_spans:
            state = op.setup(ctx)
        with ctx.mark("warmup"):
            op.warmup(ctx, state)
            _sync(device)
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        before = op.counters()
        gc.collect()
        gc.freeze()  # set-up's objects stay out of the window's collections
        setup_s = time.perf_counter() - t0
        keep = sample(ctx)
        tr = spans = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from benchmark import trace as T

            # device activity alone: the calls' host side is the
            # harness's clock and the port's spans
            acts = ([ProfilerActivity.CUDA] if device.startswith("cuda")
                    else [ProfilerActivity.CPU])
            stamps = []
            # the spans' records are what the window keeps allocating: left
            # on, the collector runs inside the calls, which it does not
            # in an untraced window, and adds to every host time read here
            collecting = gc.isenabled()
            gc.disable()
            try:
                with profile(activities=acts) as prof, record() as spans:
                    fields, kept = window(ctx, state,
                                          min(seconds, TRACE_SECONDS), keep,
                                          stamps)
            finally:
                if collecting:
                    gc.enable()
            tr = T.read(prof, stamps, label)
        else:
            fields, kept = window(ctx, state, seconds, keep)
        gc.unfreeze()
        peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
                else 0)
        after = op.counters()
        checks = op.check(ctx, state, kept)
        least = op.least_s(ctx, state)
    checks["failed_calls"] = (fields["failed"], 0)
    correct = bool(kept) and all(v <= lim for v, lim in checks.values())
    calls = max(fields["ops"] + fields["failed"], 1)
    counters = {k: (after[k] - before.get(k, 0)) / calls for k in after}
    run = Run(cell.mix["op"], setup_s, least_s=least, trace=tr, spans=spans,
              setup_spans=setup_spans, counters=counters, **fields)
    metrics = {}
    for m in metric_entries(cell, trace):
        v = read_metric(cell, m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct,
              "attempted": fields["ops"] + fields["failed"],
              "failed": fields["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": peak}}
    named = None
    if tr is not None:
        gaps = tr.idle_gaps
        if tr.busy_s is not None:
            from benchmark import spans as S

            gaps, named = S.named_gaps(tr, stamps, spans, label)
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": gaps}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    result["info"] = {"setup_steps_s": ctx.marks,
                      "counters_per_call": counters,
                      "checked_calls": sorted(kept),
                      "latency_ms": _quantiles(fields["latencies_s"]),
                      "least_s_per_call": least,
                      "kernels_traced": tr.kernels if tr else None,
                      "device_busy_in_calls": (tr.span_busy_s / tr.busy_s
                                               if tr and tr.busy_s else None),
                      "idle_in_calls_named_by_spans": named}
    return run, result


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float) -> dict:
    """One run of ``cell``: the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, and with ``trace`` ``breakdown``;
    then ``checks``) and, under ``info``, the counters and set-up steps for
    an earlier line (:func:`measure`)."""
    return measure(cell, seed, seconds, trace, device, t0)[1]
