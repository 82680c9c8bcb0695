"""Hand-written Hopper kernels, their wrappers and their plain PyTorch versions."""
