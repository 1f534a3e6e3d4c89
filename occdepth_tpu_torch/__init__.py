"""occdepth_tpu_torch — the PyTorch/CUDA port of occdepth_tpu for NVIDIA Hopper.

The JAX package `occdepth_tpu` is the reference this package is held to.
Module paths mirror it (`models/efficientnet.py`, `ops/flosp_gather.py`,
...), modules run in PyTorch's NCHW/NCDHW layouts, and the model's public
boundary keeps the JAX package's batch dict and channels-last outputs.

The TPU kernels on the serving and training paths are hand-written CUDA
C++ for sm_90a (`csrc/`), built with nvcc at first CUDA use
(`ops/cuda_lib.py`).  Each has a plain PyTorch version beside it that runs
for CPU tensors.

This package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
