"""Moore-Penrose pseudo-inverse iteration of the Nystrom attention.

Counterpart of ``mirror_tpu/ops/pinv_pallas.py::moore_penrose_pinv_pallas``
(forward only). The global scale is reduced by torch here, outside the
kernel, as the TPU package leaves it to XLA. On a CUDA tensor the
iterations run ``csrc/pinv.cu``; on a CPU tensor :func:`pinv_iterations_ref`.
"""

import torch

from . import _common

KERNEL = "moore_penrose_pinv"


def global_scale(x: torch.Tensor) -> torch.Tensor:
    """max(rowsum|x|) * max(colsum|x|) over the WHOLE [b, h, m, m] tensor
    (the reference's quirk), as an fp32 scalar tensor on x's device."""
    abs_x = x.abs()
    col = abs_x.sum(-1)
    row = abs_x.sum(-2)
    return (col.max() * row.max()).float()


def _dot(a, b):
    """a @ b with fp32 accumulation, rounded to a's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def pinv_iterations_ref(x: torch.Tensor, s: torch.Tensor, iters: int = 6):
    """Plain version, with the TPU kernel's rounding points (_iter_body)."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    z = (x.transpose(-1, -2).float() / s).to(x.dtype)
    for _ in range(iters):
        xz = _dot(x, z)
        t1 = 7.0 * eye - xz
        t3 = 15.0 * eye - _dot(xz, t1)
        a = 13.0 * eye - _dot(xz, t3)
        z = (0.25 * _dot(z, a)).to(z.dtype)
    return z


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Iterative pseudo-inverse of [b, h, m, m] matrices:
    z <- 0.25 z (13I - xz (15I - xz (7I - xz))), z0 = x^T / global_scale(x)."""
    s = global_scale(x)
    if not _common.on_cuda(x):
        return pinv_iterations_ref(x, s, iters)
    b, h, m, _ = x.shape
    _common.check_kernel_input("x", x, (b, h, m, m))
    bh = b * h
    z = torch.empty_like(x)
    xz, t1, t3, a = (torch.empty_like(x) for _ in range(4))
    gemm = "mirror_pinv_gemm"
    _common.launch("mirror_pinv_init", x.data_ptr(), s.data_ptr(), z.data_ptr(), bh, m)
    for _ in range(iters):
        # xz = x z, and t1 = 7I - xz from the same epilogue
        _common.launch(gemm, x.data_ptr(), z.data_ptr(), xz.data_ptr(), t1.data_ptr(),
                       bh, m, m, m, 0.0, 1.0, 7.0, -1.0)
        # t3 = 15I - xz t1
        _common.launch(gemm, xz.data_ptr(), t1.data_ptr(), t3.data_ptr(), None,
                       bh, m, m, m, 15.0, -1.0, 0.0, 0.0)
        # a = 13I - xz t3
        _common.launch(gemm, xz.data_ptr(), t3.data_ptr(), a.data_ptr(), None,
                       bh, m, m, m, 13.0, -1.0, 0.0, 0.0)
        # z = 0.25 z a, written to a fresh buffer (z is an operand)
        z_next = t1
        _common.launch(gemm, z.data_ptr(), a.data_ptr(), z_next.data_ptr(), None,
                       bh, m, m, m, 0.0, 0.25, 0.0, 0.0)
        z, t1 = z_next, z
    _common.count_launch(KERNEL)
    return z
