"""The BVGraph format (a copy of the JAX package's codec and its NumPy
decoder) and its bulk decode on a torch device."""
