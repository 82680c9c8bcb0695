"""Host utilities, copied from the JAX package's ``webgraph_tpu/utils``."""
