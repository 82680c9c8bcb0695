"""The check that decides ``correct``: the comparisons, each cell's control
and the faults of the timed path a cell can have.

On the CPU the runs are tiny and the port's plain versions stand in for
its kernels.  The ``gpu`` test runs each cell's control at the cell's own
size on the card:

    python -m pytest -m gpu benchmark/tests/test_bench_check.py -s
"""

import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import compare

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def test_one_successor_changed_is_counted():
    off = np.array([0, 2, 3], dtype=np.int64)
    succ = np.array([1, 0, 0], dtype=np.int32)
    assert compare.csr_mismatch(off, succ, off, succ) == 0
    bad = succ.copy()
    bad[1] = 2
    assert compare.csr_mismatch(off, bad, off, succ) == 1
    assert compare.csr_mismatch(off, succ[:2], off, succ) == 1


def test_one_row_changed_is_counted():
    off = np.array([0, 2, 3, 3], dtype=np.int64)
    succ = np.array([1, 2, 0], dtype=np.int32)
    out, counts = compare.rows(off, succ, [0, 2, 1, 0])
    assert out.tolist() == [[1, 2], [0, 0], [0, 0], [1, 2]]
    assert counts.tolist() == [2, 0, 1, 2]
    assert compare.rows_mismatch(out, counts, out, counts) == 0
    bad = out.copy()
    bad[3, 1] = 7
    assert compare.rows_mismatch(bad, counts, out, counts) == 1
    assert compare.rows_mismatch(out[:, :1], counts, out, counts) == 4


def test_one_byte_changed_is_counted():
    ref = (b"\x01\x02\x03", 20, b"\x05", 7)
    assert compare.bytes_mismatch(ref, ref) == 0
    assert compare.bytes_mismatch((b"\x01\x00\x03", 20, b"\x05", 7), ref) == 1
    assert compare.bytes_mismatch((b"\x01\x02", 16, b"\x05", 7), ref) == 5


def _cell(name, monkeypatch, tiny_cell):
    cell = tiny_cell(name)
    # a check of every call, so that a fault in any call shows
    monkeypatch.setitem(cell.mix, "check", {"sample": 2, "among": 2})
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_cpu_run_is_correct(name, monkeypatch, tiny_cell):
    r = harness.run_cell(_cell(name, monkeypatch, tiny_cell), SEEDS[0], 0.05,
                         False, "cpu", 0.0)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tiny_cell):
    checks = harness.control_checks(tiny_cell(name), SEEDS[1], "cpu")
    assert any(v > lim for v, lim in checks.values()), checks


# the faults of the timed path: each replaces what the port's entry returns
def _unchanged(x):
    return torch.zeros_like(x)


def _half(x):
    x = x.clone()
    x.view(-1)[x.numel() // 2:] = 0
    return x


def _altered(x):
    x = x.clone()
    x.view(-1)[x.numel() // 3] += 1
    return x


FAULTS = {"unchanged": _unchanged, "half_left_out": _half,
          "one_answer_altered": _altered}


def _bytes_fault(fault, b):
    t = fault(torch.frombuffer(bytearray(b), dtype=torch.uint8))
    return bytes(t.numpy())


def _break(name, fault, monkeypatch):
    """Break the port's entry that the cell's window drives."""
    op = harness.find_cell(name).mix["op"]
    if op == "decode":
        from webgraph_tpu_torch.formats import bvgraph as B

        real = B.decode_prepared
        monkeypatch.setattr(B, "decode_prepared",
                            lambda prep: (lambda o, s: (o, fault(s)))(
                                *real(prep)))
    elif op == "query":
        from webgraph_tpu_torch.kernels.query2 import QueryPlanner

        real = QueryPlanner.successors_batch
        monkeypatch.setattr(QueryPlanner, "successors_batch",
                            lambda self, nodes: (lambda o, c: (fault(o), c))(
                                *real(self, nodes)))
    elif op == "encode":
        from webgraph_tpu_torch.formats import bvgraph_encode as E

        real = E.encode_device

        def broken(*a, **k):
            gb, gbits, ob, obits, st = real(*a, **k)
            return _bytes_fault(fault, gb), gbits, ob, obits, st

        broken.reads = real.reads  # the entry counts its reads by its name
        monkeypatch.setattr(E, "encode_device", broken)
    else:
        raise AssertionError(f"no fault for operation kind {op!r}")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch,
                                            tiny_cell):
    """The run's own path, with its look for a chip skipped and the port's
    entry broken underneath: ``correct`` comes out false.  (The exchange
    between chips has no fault here: every cell takes one chip.)"""
    cell = _cell(name, monkeypatch, tiny_cell)
    _break(name, FAULTS[fault], monkeypatch)
    r = harness.run_cell(cell, SEEDS[2], 0.05, False, "cpu", 0.0)
    assert not r["correct"], r["checks"]
    assert r["checks"]["failed_calls"]["value"] == 0  # wrong, not raising


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_at_the_cells_size_is_not_correct(name, seed, card):
    """The control at the cell's own size on the card; prints the numbers
    it reads (the upper readings of the limits)."""
    checks = harness.control_checks(harness.find_cell(name), seed, card)
    print(f"control {name} seed {seed}: {checks}")
    assert any(v > lim for v, lim in checks.values()), checks
