"""webgraph_tpu_torch — the PyTorch / NVIDIA H100 port of webgraph_tpu.

The port stands alone: it keeps its own copies of the host modules it needs
(bit codecs in ``bits/``, graph classes in ``graph/``, the BVGraph format
and its NumPy oracle in ``formats/``, the native host codec in ``native.py``
and ``host/``, the structure scan in ``kernels/plan.py``) and imports
nothing of ``webgraph_tpu`` and nothing of JAX.  Its hot kernels are
hand-written CUDA C++ for Hopper (``csrc/``), built at first use; each has
a plain PyTorch version that CPU tensors take.  The entry points run on the
card unless the caller passes ``device="cpu"``.

    import webgraph_tpu_torch as wgt
    g = wgt.load(basename)
    offsets, successors = wgt.decode_to_csr(g)
"""

from webgraph_tpu_torch.formats.bvgraph import decode_to_csr, to_csr
from webgraph_tpu_torch.graph.immutable_graph import load

__all__ = ["load", "decode_to_csr", "to_csr"]
