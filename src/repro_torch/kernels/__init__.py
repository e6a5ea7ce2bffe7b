"""Hand-written CUDA kernels for Hopper, their builder and plain versions."""
