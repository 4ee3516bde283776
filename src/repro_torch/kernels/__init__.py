"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""
