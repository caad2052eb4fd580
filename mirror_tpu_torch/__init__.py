"""MIRROR in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

A port of the JAX package ``mirror_tpu`` (which stays the reference). It
imports torch, numpy, pandas and yaml, never jax, flax or mirror_tpu.

Matmul precision is set explicitly: float32 matrix products and cuDNN
convolutions run in full float32, never TF32, so the plain versions that the
kernels are held against keep float32 accuracy on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
