"""gsplatloc_tpu_torch — the PyTorch/CUDA port of gsplatloc_tpu for NVIDIA Hopper.

Mirrors the layout of the JAX reference package, slice by slice: plain
tensor code is PyTorch, and every kernel the reference wrote in Pallas is
a hand-written CUDA kernel under csrc/, built with nvcc at first use and
bound through ctypes (kernels/__init__.py). Nothing is built or loaded at
import, so the package imports on a machine without CUDA.

Layer map:
  ops/      — pose numerics, projection, binning, K-cover and sub-tile renders
  models/   — frozen Gaussian scene + camera pose parameterization
  opt/      — Adam + the eager pose-tracking loop
  data/     — dataset loaders, synthetic scenes, frame-pair parser
  kernels/  — nvcc build + ctypes binding of csrc/*.cu
  parallel/ — tile-row bands over several devices and processes (mesh=)
  convert   — state carried over from the reference package (numpy in)

Precision: float32 everywhere; TF32 is switched off for matmuls and cuDNN
at import (a TF32 product keeps ~3 decimal digits — far below what the
pose gradients need).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
