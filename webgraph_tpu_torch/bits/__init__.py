"""Bit streams and instantaneous codes (copies of the JAX package's host modules)."""
