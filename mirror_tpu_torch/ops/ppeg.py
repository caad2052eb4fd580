"""PPEG's merged 7x7 depthwise conv + identity + bias.

Counterpart of ``mirror_tpu/ops/ppeg_pallas.py::ppeg_fused`` and its custom
VJP. :class:`PPEGFused` is the only caller of the kernels: on CUDA tensors
its forward (through the op ``mirror::ppeg``, :func:`ppeg_op`, which an
exported program also calls) and backward run ``csrc/ppeg.cu``; on CPU
tensors :func:`ppeg_ref` and :func:`ppeg_bwd_ref`.
"""

import torch
import torch.nn.functional as F

from . import _common

KERNEL = "ppeg"
KERNEL_BWD = "ppeg_bwd"
KSIZE = 7


def ppeg_ref(img: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 img + bias + depthwise conv, one rounding."""
    c = img.shape[-1]
    x = img.float().permute(0, 3, 1, 2)  # NCHW view for F.conv2d
    weight = kern.float().permute(2, 0, 1).unsqueeze(1)  # [C, 1, 7, 7]
    conv = F.conv2d(x, weight, padding=KSIZE // 2, groups=c).permute(0, 2, 3, 1)
    return (img.float() + bias.float() + conv).to(img.dtype)


def ppeg_bwd_ref(img, kern, g):
    """(dimg, dk, db) as the TPU backward kernel computes them
    (ppeg_pallas._bwd_kernel): dimg = g + the conv of g with the flipped
    taps, one rounding to img's dtype; dk[dy, dx, c] = sum over batch and
    grid of g * img shifted by the tap, and db = sum of g, both in fp32
    (the caller rounds them to the kernel's and the bias's dtypes)."""
    H, W = img.shape[1:3]
    half = KSIZE // 2
    dimg = ppeg_ref(g, kern.flip(0, 1), torch.zeros_like(kern[0, 0]))
    g32 = g.float()
    imgp = F.pad(img.float(), (0, 0, half, half, half, half))
    dk = torch.stack([
        torch.stack([(g32 * imgp[:, dy:dy + H, dx:dx + W]).sum((0, 1, 2))
                     for dx in range(KSIZE)])
        for dy in range(KSIZE)])
    return dimg, dk, g32.sum((0, 1, 2))


@torch.library.custom_op(f"{_common.OP_NAMESPACE}::ppeg", mutates_args=(), device_types="cpu")
def ppeg_op(img: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``mirror::ppeg``: the forward; on the CPU :func:`ppeg_ref`."""
    return ppeg_ref(img, kern, bias)


@ppeg_op.register_kernel("cuda")
def _ppeg_cuda(img, kern, bias):
    b, H, W, C = img.shape
    _common.check_kernel_input("img", img, (b, H, W, C), img.dtype)
    _common.check_kernel_input("kern", kern, (KSIZE, KSIZE, C), img.dtype)
    _common.check_kernel_input("bias", bias, (C,), img.dtype)
    out = torch.empty_like(img)
    _common.launch("mirror_ppeg", img.data_ptr(), kern.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), b, H, W, C, _common.type_code(img.dtype))
    _common.count_launch(_common.instance(KERNEL, img.dtype))
    return out


@ppeg_op.register_fake
def _ppeg_fake(img, kern, bias):
    return torch.empty_like(img)


class PPEGFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, kern, bias):
        ctx.save_for_backward(img, kern, bias)
        return ppeg_op(img, kern, bias)

    @staticmethod
    def backward(ctx, g):
        img, kern, bias = ctx.saved_tensors
        g = _common.grad_or_zeros(g, img)
        if not _common.on_cuda(img, kern, g):
            dimg, dk, db = ppeg_bwd_ref(img, kern, g)
            return dimg, dk.to(kern.dtype), db.to(bias.dtype)
        b, H, W, C = img.shape
        _common.check_kernel_input("img", img, img.shape, img.dtype)
        _common.check_kernel_input("kern", kern, (KSIZE, KSIZE, C), img.dtype)
        _common.check_kernel_input("g", g, img.shape, img.dtype)
        dimg = torch.empty_like(img)
        dkb = torch.empty(KSIZE * KSIZE + 1, C, dtype=torch.float32, device=img.device)
        elems = _common.scratch_elems("mirror_ppeg_bwd_partial_elems", b, H, C)
        partial = torch.empty(elems, dtype=torch.float32, device=img.device)
        _common.launch("mirror_ppeg_bwd", img.data_ptr(), kern.data_ptr(), g.data_ptr(),
                       dimg.data_ptr(), dkb.data_ptr(), partial.data_ptr(), b, H, W, C,
                       _common.type_code(img.dtype))
        _common.count_launch(_common.instance(KERNEL_BWD, img.dtype))
        dk = dkb[:KSIZE * KSIZE].reshape(KSIZE, KSIZE, C).to(kern.dtype)
        return dimg, dk, dkb[KSIZE * KSIZE].to(bias.dtype)


def ppeg_fused(img: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """out = img + bias + SAME depthwise 7x7 conv of img with per-channel
    taps. img [b, H, W, C] (NHWC); kern [7, 7, C]; bias [C]. Differentiable
    in all three; db takes the bias's dtype and dk the kernel's."""
    return PPEGFused.apply(img, kern, bias)
