"""Hand-written CUDA kernels (sources in ``csrc/``) with their plain versions."""
