"""Hand-written CUDA kernels for Hopper, each with its plain torch version."""
