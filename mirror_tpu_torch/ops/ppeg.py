"""PPEG's merged 7x7 depthwise conv + identity + bias.

Counterpart of ``mirror_tpu/ops/ppeg_pallas.py::ppeg_fused`` (forward
only). On a CUDA tensor the call runs ``csrc/ppeg.cu``; on a CPU tensor it
runs :func:`ppeg_ref`.
"""

import torch
import torch.nn.functional as F

from . import _common

KERNEL = "ppeg"
KSIZE = 7


def ppeg_ref(img: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 img + bias + depthwise conv, one rounding."""
    c = img.shape[-1]
    x = img.float().permute(0, 3, 1, 2)  # NCHW view for F.conv2d
    weight = kern.float().permute(2, 0, 1).unsqueeze(1)  # [C, 1, 7, 7]
    conv = F.conv2d(x, weight, padding=KSIZE // 2, groups=c).permute(0, 2, 3, 1)
    return (img.float() + bias.float() + conv).to(img.dtype)


def ppeg_fused(img: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """out = img + bias + SAME depthwise 7x7 conv of img with per-channel
    taps. img [b, H, W, C] (NHWC); kern [7, 7, C]; bias [C]."""
    if not _common.on_cuda(img, kern, bias):
        return ppeg_ref(img, kern, bias)
    b, H, W, C = img.shape
    _common.check_kernel_input("img", img, (b, H, W, C))
    _common.check_kernel_input("kern", kern, (KSIZE, KSIZE, C))
    _common.check_kernel_input("bias", bias, (C,))
    out = torch.empty_like(img)
    _common.launch("mirror_ppeg", img.data_ptr(), kern.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), b, H, W, C)
    _common.count_launch(KERNEL)
    return out
