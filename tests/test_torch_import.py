"""The PyTorch port imports without JAX, without the JAX package
(webgraph_tpu) and without the CUDA toolkit, and its kernel wrappers launch
nothing for CPU tensors."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_JAX = r"""
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "webgraph_tpu")

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import webgraph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(webgraph_tpu_torch.__path__,
                                               "webgraph_tpu_torch.")]
for name in names:
    __import__(name)
for name in ("algo.bfs", "algo.centralities", "algo.components", "algo.device",
             "algo.nf", "algo.sumsweep", "kernels.propagate", "algo.hll",
             "algo.hyperball", "algo.hyperball_device", "kernels.hyperball",
             "transform.device", "transform.transform",
             "bits.bitstream", "bits.codes", "bits.vcodes", "bits.elias_fano",
             "graph.builders", "graph.csr", "graph.immutable_graph",
             "graph.properties", "formats.bvgraph", "formats.bvgraph_np",
             "kernels._build", "kernels.decode", "kernels.decode2",
             "kernels.levels", "kernels.pcodes", "kernels.plan",
             "kernels.query2", "native", "synth", "tools.speed_test",
             "utils.rng", "probes.winmach", "probes.gamma", "probes.composite",
             "probes.fetch", "probes.onehot", "probes.loops", "probes.timing5",
             "probes.bisect4", "probes.bisect3", "probes.perf", "probes.forms",
             "probes.caps", "probes.bisect", "probes.bisect2", "probes.v6",
             "probes.v6b", "formats.bvgraph_encode", "kernels.encode",
             "timing"):
    assert "webgraph_tpu_torch." + name in names, name
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""


def test_imports_with_jax_blocked():
    """Every module of the port imports with jax, jaxlib and webgraph_tpu
    blocked (webgraph_tpu_torch itself is not)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_module_needs_no_nvcc(tmp_path, monkeypatch):
    from webgraph_tpu_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert set(_build.SOURCES) == {"decode2.cu", "decode.cu", "propagate.cu",
                                   "hyperball.cu", "encode.cu", "probes.cu",
                                   "loops.cu", "forms.cu"}
    paths = [_build.library_path(s) for s in _build.SOURCES]
    assert len(set(paths)) == len(paths)  # one library per source
    for src, path in zip(_build.SOURCES, paths):
        assert os.path.dirname(path) == _build.BUILD_DIR
        assert path == _build.library_path(src)  # keyed by the sources only


def test_cpu_tensors_launch_nothing(tmp_path):
    import webgraph_tpu_torch as wgt
    from webgraph_tpu_torch.bits import codes as C
    from webgraph_tpu_torch.formats.bvgraph import BVGraph
    from webgraph_tpu_torch.graph.builders import MutableGraph
    from webgraph_tpu_torch.kernels import decode as K2
    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.kernels import pcodes as P
    from webgraph_tpu_torch.synth import deep_chain_graph

    from webgraph_tpu_torch.algo import device as AD
    from webgraph_tpu_torch.kernels.propagate import or_pull

    counts = (sum(D2.decode_records.counts.values()), P.probe.launches,
              sum(K2.decode_levels.counts.values()), or_pull.launches)
    for g, kw in ((MutableGraph.erdos_renyi(120, 0.05, seed=3), {}),
                  (deep_chain_graph(1200), dict(max_ref_count=2**31 - 1,
                                                min_interval_length=2))):
        base = os.path.join(tmp_path, "g")
        BVGraph.store(g, base, **kw)
        off, succ = wgt.to_csr(wgt.load(base), device="cpu")
        toff, tsucc = g.to_csr()
        np.testing.assert_array_equal(off, toff)
        np.testing.assert_array_equal(succ, tsucc)
    words = torch.zeros(4, dtype=torch.int64)
    P.probe(words, torch.zeros(3, dtype=torch.int64), C.GAMMA)
    csr = AD.DeviceCSR.from_graph(wgt.load(base), "cpu")
    AD.bfs_distances(csr, 0)
    AD.nf64(csr, [0, 1])
    assert (sum(D2.decode_records.counts.values()), P.probe.launches,
            sum(K2.decode_levels.counts.values()), or_pull.launches) == counts


@pytest.mark.parametrize("entry", ["decode_to_csr", "to_csr", "prepare",
                                   "K2.prepare"])
def test_entry_points_default_to_the_card(entry):
    """With no device argument the entry points target CUDA."""
    import inspect

    from webgraph_tpu_torch.formats import bvgraph as F
    from webgraph_tpu_torch.kernels import decode as K2

    fn = getattr(K2, entry[3:]) if entry.startswith("K2.") \
        else getattr(F, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(F.BVGraph.to_csr).parameters[
        "device"].default == "cuda"


@pytest.mark.parametrize("entry", [
    "transform.device.transpose_device", "transform.device.map_device",
    "transform.device.symmetrize_device", "transform.device.graph_csr",
    "algo.device.DeviceCSR", "algo.device.DeviceCSR.from_graph",
    "algo.centralities.GeometricCentralities",
    "algo.centralities.BetweennessCentrality",
    "algo.sumsweep.SumSweepDirectedDiameterRadius",
    "algo.hyperball_device.HyperBallDevice"])
def test_analytics_entry_points_default_to_the_card(entry):
    import importlib
    import inspect

    parts = entry.split(".")
    obj = importlib.import_module("webgraph_tpu_torch." + ".".join(parts[:2]))
    for a in parts[2:]:
        obj = getattr(obj, a)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


@pytest.mark.parametrize("cuda_present,codings,on_card", [
    (True, "default", True),
    (True, "golomb", False),  # no kernel reads Golomb codes
    (False, "default", False),
])
def test_bvgraph_to_csr_auto_takes_the_card(cuda_present, codings, on_card,
                                            tmp_path, monkeypatch):
    """``BVGraph.to_csr()`` with no arguments decodes on the card when one
    is present and a kernel decodes the graph, else on the host."""
    from webgraph_tpu_torch.bits import codes as C
    from webgraph_tpu_torch.formats import bvgraph as F
    from webgraph_tpu_torch.synth import deep_chain_graph

    s = F.BVGraphSettings(max_ref_count=2**31 - 1, min_interval_length=2)
    if codings == "golomb":
        s.codings["RESIDUALS"] = C.GOLOMB
    g = deep_chain_graph(1200)
    base = os.path.join(tmp_path, "g")
    F.BVGraph.store(g, base, settings=s)
    bv = F.BVGraph.load(base)
    monkeypatch.delenv("WGT_DECODE_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda_present)
    devices = []
    plain_route = F.to_csr

    def device_route(graph, device):
        devices.append(device)
        return plain_route(graph, "cpu")

    monkeypatch.setattr(F, "to_csr", device_route)
    off, succ = bv.to_csr()
    assert devices == (["cuda"] if on_card else [])
    toff, tsucc = g.to_csr()
    np.testing.assert_array_equal(off, toff)
    np.testing.assert_array_equal(succ, tsucc)
