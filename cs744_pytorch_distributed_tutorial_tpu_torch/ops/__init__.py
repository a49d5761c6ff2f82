"""Hand-written CUDA kernels (sources in ``csrc/``) with their wrappers
and plain PyTorch versions."""
