"""Hand-written CUDA kernels, built from ``csrc/`` at first use, each with
its plain PyTorch version beside it."""
