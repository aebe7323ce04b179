"""Hand-written Hopper kernels, one module each, beside their plain PyTorch versions."""
