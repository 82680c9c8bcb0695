"""BVGraph device decode."""
