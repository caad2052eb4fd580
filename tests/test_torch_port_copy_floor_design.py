"""The copy floor's bulk-copy walk (``csrc/copy_floor.cu``), on the CPU.

The kernel runs only on the card; :func:`copy_plan` in
``mirror_tpu_torch/ops/copy_floor.py`` is its walk over pieces in Python.
Over ragged batches (gb not dividing b), ragged row tiles (tile not
dividing n), runs shorter than one stage and runs of many stages, the
pieces must cover every byte of the tensor exactly once, stay inside the
block's own (batch rows, head, row tile) cell, and keep the bulk copies'
16-byte rules; replayed as byte copies they give the input back bit for
bit.
"""

import numpy as np
import pytest

from mirror_tpu_torch.ops import copy_floor as cf
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

# (b, h, n, d, gb, tile): the probe's layouts (gb 8 / 4 / 1 / whole batch,
# the 384-row tile) at small sizes, gb not dividing b, tile not dividing n,
# a run of one 16-byte row, runs of many stages, a run of exactly one stage
# (256 rows of 96), one 192 bytes past two stages (513 rows of 96), and row
# tiles of 32 KB
SHAPES = [(5, 3, 77, 96, 2, None), (3, 2, 10, 8, 8, None), (4, 2, 300, 96, 4, None),
          (7, 2, 770, 96, 1, 384), (9, 3, 1000, 128, 8, 384), (6, 2, 50, 96, 6, None),
          (2, 1, 1, 8, 1, None), (64, 2, 2304, 96, 64, None), (3, 2, 513, 48, 2, 256),
          (2, 2, 256, 96, 1, None), (3, 1, 513, 96, 2, None), (4, 3, 384, 128, 3, 128)]


def _cells(b, h, n, gb, tile):
    tile = tile or n
    return [(x, head, z) for z in range(-(-n // tile)) for head in range(h)
            for x in range(-(-b // gb))]


@pytest.mark.parametrize("b,h,n,d,gb,tile", SHAPES)
def test_copy_plan_covers_every_byte_once(b, h, n, d, gb, tile):
    total = b * h * n * d * 2
    plan = cf.copy_plan(b, h, n, d, gb, tile)
    assert len(plan) == len(_cells(b, h, n, gb, tile))
    seen = np.zeros(total, np.int32)
    for pieces in plan:
        for off, nbytes in pieces:
            assert off % 16 == 0 and nbytes % 16 == 0, (off, nbytes)
            assert 0 < nbytes <= cf.STAGE_BYTES
            seen[off:off + nbytes] += 1
    assert seen.min() == 1 and seen.max() == 1


@pytest.mark.parametrize("b,h,n,d,gb,tile", SHAPES)
def test_copy_plan_stays_in_its_cell(b, h, n, d, gb, tile):
    """Block (x, head, z) moves only elements of batch rows [x gb, x gb +
    gb), its head and rows [z tile, z tile + tile); a run that fits one
    stage is one piece."""
    t = tile or n
    row_bytes = 2 * d
    for (x, head, z), pieces in zip(_cells(b, h, n, gb, tile), cf.copy_plan(b, h, n, d, gb, tile)):
        run = min(t, n - z * t) * row_bytes
        runs = min(b, x * gb + gb) - x * gb
        assert len(pieces) == runs * -(-run // cf.STAGE_BYTES)
        for off, nbytes in pieces:
            for byte in (off, off + nbytes - 1):
                row, _ = divmod(byte, row_bytes)
                i, rest = divmod(row, h * n)
                hh, r = divmod(rest, n)
                assert x * gb <= i < x * gb + gb and hh == head and z * t <= r < z * t + t


@pytest.mark.parametrize("b,h,n,d,gb,tile", SHAPES[:4])
def test_copy_plan_replayed_is_the_input(b, h, n, d, gb, tile):
    src = np.random.default_rng(0).integers(0, 256, b * h * n * d * 2, dtype=np.uint8)
    dst = np.zeros_like(src)
    for pieces in cf.copy_plan(b, h, n, d, gb, tile):
        for off, nbytes in pieces:
            dst[off:off + nbytes] = src[off:off + nbytes]
    assert np.array_equal(dst, src)
