"""Each operation kind at a tiny size on the port's plain PyTorch versions,
called directly rather than through the measured window, and the command
line's refusals (CPU)."""

import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.reference import generator
from benchmark.tests.conftest import make_tiny_root

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_operation_runs_and_checks_on_the_cpu(name, tmp_path, tiny_cell):
    cell = tiny_cell(name)
    ctx = harness.Context(cell, 31, "cpu", str(tmp_path), None, None)
    ctx.offsets, ctx.succ = generator.make_graph(cell.config, 31)
    op = cell.op
    state = op.setup(ctx)
    op.warmup(ctx, state)
    kept = {}
    for i in range(2):
        out, units = op.step(ctx, state, i)
        assert units > 0
        kept[i] = out
    checks = op.check(ctx, state, kept)
    assert checks and all(v == 0 for v, _ in checks.values()), checks
    least = op.least_s(ctx, state)
    assert least is None or 0 < least < 1e-3
    assert all(isinstance(v, int) for v in op.counters().values())


def test_run_py_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_a_checkout_without_the_port_fails(tmp_path):
    """With only ``BENCHMARK.json`` and ``benchmark/`` (its graphs cut to a
    few thousand nodes), a run fails before it prints a result."""
    make_tiny_root(tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); "
            "from benchmark import harness; "
            f"c = harness.find_cell({CELLS[0]!r}, root='.'); "
            "print(harness.run_cell(c, 1, 0.05, False, 'cpu', 0.0))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "webgraph_tpu_torch" in p.stderr


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    sys.path.insert(0, os.path.join(harness.ROOT, "benchmark"))
    try:
        import run
    finally:
        sys.path.pop(0)
    for name in ("jax", "webgraph_tpu", "webgraph_tpu.formats"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "webgraph_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "webgraph_tpu.formats", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "webgraph_tpu"]
