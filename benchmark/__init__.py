"""The benchmark of webgraph_tpu_torch (see run.py)."""
