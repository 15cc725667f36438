"""Hand-written CUDA kernels (sources in csrc/), their wrappers and plain versions."""
