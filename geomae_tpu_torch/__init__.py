"""geomae_tpu_torch: GeoMAE detection serving, the detection fine-tune
train step and the GeoMAE pretrain train step in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).

The port of ``geomae_tpu`` (JAX on a TPU), which stays the reference.  It
imports ``torch`` and numpy and nothing of the JAX package: it keeps its
own copies of the configuration tree (``config.py``) and of the numpy
point preparation (``data/transforms.py``).  Its entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""
