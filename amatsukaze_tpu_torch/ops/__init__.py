"""Tensor ops of the filter core and the wrappers of its CUDA kernels."""
