"""Hand-written CUDA kernels, their plain twins and their build."""
