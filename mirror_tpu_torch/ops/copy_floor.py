"""The device-memory copy floor: out = in under the TPU probe's launch shapes.

Counterpart of the copy kernels of ``scripts/exp_hbm_floor.py``
(``copy_floor``, ``main.run_flat``, ``main.run_ntile``). On a CUDA tensor
:func:`copy_floor` launches ``csrc/copy_floor.cu``; on a CPU tensor its
plain version :func:`copy_floor_ref`. It moves bytes and computes nothing:
the probe ``mirror_tpu_torch.scripts.exp_hbm_floor`` reads the card's copy
rate from it. :func:`copy_plan` is the kernel's walk over its bulk copies,
in Python, for the CPU tests.
"""

from typing import List, Optional, Tuple

import torch

from . import _common

KERNEL = "copy_floor"
STAGE_BYTES = 48 * 1024  # csrc/copy_floor.cu's kStageBytes: the most one bulk copy moves


def copy_floor_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a copy."""
    return x.clone()


def copy_plan(b: int, h: int, n: int, d: int, gb: int,
              tile: Optional[int] = None) -> List[List[Tuple[int, int]]]:
    """The (byte offset, bytes) pieces that each block of the kernel moves,
    in its order, blocks in grid order (batch blocks, then heads, then row
    tiles, the x index fastest): a block's part of each of its gb batch
    rows is one run of rows x d bf16 elements, cut into pieces of
    ``STAGE_BYTES``, the last one ragged. Each piece is one bulk load and
    one bulk store of the same bytes."""
    tile = tile or n
    row_bytes = 2 * d
    blocks = []
    for z in range(-(-n // tile)):
        row0 = z * tile
        run = min(tile, n - row0) * row_bytes
        for head in range(h):
            for x in range(-(-b // gb)):
                pieces = []
                for i in range(x * gb, min(b, x * gb + gb)):
                    base = ((i * h + head) * n + row0) * row_bytes
                    pieces += [(base + j, min(STAGE_BYTES, run - j))
                               for j in range(0, run, STAGE_BYTES)]
                blocks.append(pieces)
    return blocks


def copy_floor(x: torch.Tensor, gb: int, tile: Optional[int] = None) -> torch.Tensor:
    """A copy of bf16 ``x`` [b, h, n, d] by blocks of ``gb`` batch rows of
    one head and ``tile`` rows of the sequence (all n when None); d a
    multiple of 8 and ``x`` 16-byte aligned (the kernel's bulk copies move
    16-byte units). gb need not divide b, nor tile n."""
    if not _common.on_cuda(x):
        return copy_floor_ref(x)
    b, h, n, d = x.shape
    _common.check_kernel_input("x", x, (b, h, n, d))
    if d % 8:
        raise ValueError(f"d = {d}: the kernel copies 16-byte chunks, so d must be a multiple "
                         "of 8")
    out = torch.empty_like(x)
    _common.check_kernel_input("out", out, (b, h, n, d))
    _common.launch("mirror_copy_floor", x.data_ptr(), out.data_ptr(), b, h, n, d, gb,
                   tile or n)
    _common.count_launch(KERNEL)
    return out
