"""PyTorch/CUDA port of the packed local-SGD system (paper Alg 1).

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``configs``, ``data``, ``models``, ``optim``, ``comm``,
``core``, ``kernels``, ``launch``) and imports nothing of it. The TPU
Pallas kernels on the packed round's path are CUDA C++ kernels for Hopper
under ``kernels/csrc`` (DESIGN.md §6 describes the packed round).

The reference computes in full float32, so TF32 is switched off for
matrix products and convolutions when this package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
