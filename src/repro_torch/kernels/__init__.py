"""Hand-written CUDA kernels (built with nvcc at first use, bound through
ctypes), each beside its plain PyTorch version."""
