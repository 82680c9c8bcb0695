"""The PyTorch port imports without JAX and without the CUDA toolkit, and its
kernel wrappers launch nothing for CPU tensors."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_JAX = r"""
import sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import webgraph_tpu_torch
import webgraph_tpu_torch.formats.bvgraph
import webgraph_tpu_torch.kernels._build
import webgraph_tpu_torch.kernels.decode2
import webgraph_tpu_torch.kernels.pcodes
import webgraph_tpu_torch.synth
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not leaked, leaked
print("ok")
"""


def test_imports_with_jax_blocked():
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
    path = _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert path == _build.library_path()  # keyed by the sources only


def test_cpu_tensors_launch_nothing(tmp_path):
    import webgraph_tpu_torch as wgt
    from webgraph_tpu.bits import codes as C
    from webgraph_tpu.formats.bvgraph import BVGraph
    from webgraph_tpu.graph.builders import MutableGraph
    from webgraph_tpu_torch.kernels import decode2 as D2
    from webgraph_tpu_torch.kernels import pcodes as P

    k1, k0 = D2.decode_lanes.launches, P.probe.launches
    g = MutableGraph.erdos_renyi(120, 0.05, seed=3)
    base = os.path.join(tmp_path, "g")
    BVGraph.store(g, base)
    off, succ = wgt.to_csr(wgt.load(base))
    toff, tsucc = g.to_csr()
    np.testing.assert_array_equal(off, toff)
    np.testing.assert_array_equal(succ, tsucc)
    words = torch.zeros(4, dtype=torch.int64)
    P.probe(words, torch.zeros(3, dtype=torch.int64), C.GAMMA)
    assert (D2.decode_lanes.launches, P.probe.launches) == (k1, k0)
