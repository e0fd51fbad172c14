"""geomae_tpu_torch: GeoMAE detection serving (anchor head and
CenterHead), the detection fine-tune and GeoMAE pretrain train steps,
their trainer, detection evaluation, dataset preparation
(``create_data``), ``VoxelNet`` and the PointNet++ ops in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).

The port of ``geomae_tpu`` (JAX on a TPU), which stays the reference.  It
imports ``torch`` and numpy and nothing of the JAX package: it keeps its
own copies of the configuration tree (``config.py``), of the numpy
data layer and converters (``data/``), of the numpy evaluators
(``eval/``) and box tools (``core/box_modes.py``, ``core/visualize.py``).
Its entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
