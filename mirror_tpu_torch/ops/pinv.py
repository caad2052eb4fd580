"""Moore-Penrose pseudo-inverse iteration of the Nystrom attention.

Counterpart of ``mirror_tpu/ops/pinv_pallas.py::moore_penrose_pinv_pallas``.
The global scale is reduced by torch here, outside the kernel, as the TPU
package leaves it to XLA. On a CUDA tensor the iterations run
``csrc/pinv.cu``; on a CPU tensor :func:`pinv_iterations_ref`.

Gradients:

- ``grad="implicit"`` (the train step's default): :class:`PinvImplicit`,
  the implicit-function gradient -z^T (g z^T) of the converged inverse, two
  matrix products in the compute dtype; the TPU package computes it outside
  any kernel too (pinv_pallas.py:223-233). The scale gets no gradient.
- ``grad="exact"``: autograd through the iterations. On the CPU the plain
  iterations (and the global scale) are differentiated as the JAX dense
  path does; on the card it needs the exact backward kernel (TPU kernel 2b,
  ``pinv_pallas.py:171``), which is not ported yet, so it raises.
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


def _pinv_kernel(x: torch.Tensor, s: torch.Tensor, iters: int) -> torch.Tensor:
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


class PinvImplicit(torch.autograd.Function):
    """z = pinv(x) by the iterations; dL/dx = -z^T (g z^T)."""

    @staticmethod
    def forward(ctx, x, iters: int):
        s = global_scale(x.detach())
        z = _pinv_kernel(x, s, iters) if _common.on_cuda(x) else pinv_iterations_ref(x, s, iters)
        ctx.save_for_backward(z)
        return z

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        zt = z.transpose(-1, -2)
        return -torch.matmul(zt, torch.matmul(g.to(z.dtype), zt)), None


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6, grad: str = "implicit") -> torch.Tensor:
    """Iterative pseudo-inverse of [b, h, m, m] matrices:
    z <- 0.25 z (13I - xz (15I - xz (7I - xz))), z0 = x^T / global_scale(x)."""
    if grad == "implicit":
        return PinvImplicit.apply(x, iters)
    if grad != "exact":
        raise ValueError(f"pinv grad must be 'exact' or 'implicit', got {grad!r}")
    if not _common.on_cuda(x):
        return pinv_iterations_ref(x, global_scale(x), iters)
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "pinv_grad='exact' on CUDA needs the exact pinv backward kernel "
            "(TPU kernel 2b, mirror_tpu/ops/pinv_pallas.py:171), which is not "
            "ported yet; use pinv_grad='implicit'"
        )
    return _pinv_kernel(x, global_scale(x), iters)
