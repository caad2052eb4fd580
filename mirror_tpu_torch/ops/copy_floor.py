"""The device-memory copy floor: out = in under the TPU probe's launch shapes.

Counterpart of the copy kernels of ``scripts/exp_hbm_floor.py``
(``copy_floor``, ``main.run_flat``, ``main.run_ntile``). On a CUDA tensor
:func:`copy_floor` launches ``csrc/copy_floor.cu``; on a CPU tensor its
plain version :func:`copy_floor_ref`. It moves bytes and computes nothing:
the probe ``mirror_tpu_torch.scripts.exp_hbm_floor`` reads the card's copy
rate from it.
"""

from typing import Optional

import torch

from . import _common

KERNEL = "copy_floor"


def copy_floor_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a copy."""
    return x.clone()


def copy_floor(x: torch.Tensor, gb: int, tile: Optional[int] = None) -> torch.Tensor:
    """A copy of bf16 ``x`` [b, h, n, d] by blocks of ``gb`` batch rows of
    one head and ``tile`` rows of the sequence (all n when None); d a
    multiple of 8. gb need not divide b, nor tile n."""
    if not _common.on_cuda(x):
        return copy_floor_ref(x)
    b, h, n, d = x.shape
    _common.check_kernel_input("x", x, (b, h, n, d))
    if d % 8:
        raise ValueError(f"d = {d}: the kernel copies 16-byte chunks, so d must be a multiple "
                         "of 8")
    out = torch.empty_like(x)
    _common.launch("mirror_copy_floor", x.data_ptr(), out.data_ptr(), b, h, n, d, gb,
                   tile or n)
    _common.count_launch(KERNEL)
    return out
