"""Point and segment ops, and the wrappers of the CUDA kernels."""
