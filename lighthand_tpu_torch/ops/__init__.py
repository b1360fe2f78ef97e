"""Plain PyTorch ops; the CUDA kernels are in ``ops/kernels``."""
