"""Hand-written CUDA kernels, their nvcc build step, and the dispatch engine."""
