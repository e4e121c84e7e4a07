"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with its
plain PyTorch twin in the same module."""
