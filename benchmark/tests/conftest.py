"""A tiny copy of the benchmark for the CPU tests: ``BENCHMARK.json`` and
``benchmark/`` in a temporary root, each configuration's graph cut to a
few thousand nodes, which ``harness.find_cell`` reads from there."""

import json
import os
import shutil

import pytest

from benchmark import harness

NODES = 3000  # the CPU tests' graphs
HUBS = [40, 90, 150]  # hub lengths that fit such a graph


def make_tiny_root(root) -> str:
    """Write the tiny copy under ``root``; returns ``root``."""
    root = str(root)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    spec = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    for c in spec["configs"]:
        path = os.path.join(root, c["file"])
        conf = harness.load_json(path)
        graph = dict(conf["graph"], nodes=NODES)
        if "hubs" in graph:
            graph["hubs"] = dict(graph["hubs"], lengths=HUBS)
        with open(path, "w") as f:
            json.dump(dict(conf, graph=graph), f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def tiny_cell(tiny_root):
    """``tiny_cell(name)``: the cell ``name`` of the tiny copy."""
    return lambda name: harness.find_cell(name, root=tiny_root)
