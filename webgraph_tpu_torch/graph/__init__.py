"""Graph classes (copies of the JAX package's host modules)."""
