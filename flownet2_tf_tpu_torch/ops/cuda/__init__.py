"""Hand-written CUDA kernels: Python wrappers and the nvcc build."""
