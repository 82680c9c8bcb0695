"""webgraph_tpu_torch — the PyTorch / NVIDIA H100 port of webgraph_tpu.

The port shares the JAX-free host modules of ``webgraph_tpu`` (loader and
encoder, structure scan, bit codecs, graph classes) and re-homes what the
device path needs from its JAX modules.  Its hot kernels are hand-written
CUDA C++ for Hopper (``csrc/``), built at first use; each has a plain
PyTorch version that CPU tensors take.  Nothing here imports JAX.

    import webgraph_tpu_torch as wgt
    g = wgt.load(basename)
    offsets, successors = wgt.decode_to_csr(g, device="cuda")
"""

from webgraph_tpu.graph.immutable_graph import load
from webgraph_tpu_torch.formats.bvgraph import decode_to_csr, to_csr

__all__ = ["load", "decode_to_csr", "to_csr"]
