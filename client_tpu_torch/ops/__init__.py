"""Hand-written Hopper kernels and their plain PyTorch versions."""
