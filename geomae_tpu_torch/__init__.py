"""geomae_tpu_torch: the GeoMAE detection serving path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).

The port of ``geomae_tpu`` (JAX on a TPU), which stays the reference.  It
imports ``torch`` and numpy and the JAX-free shared modules
``geomae_tpu.config`` and ``geomae_tpu.data``; never JAX.
"""
