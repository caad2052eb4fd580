"""Landmark means and landmark softmax of the Nystrom attention.

Counterpart of ``mirror_tpu/ops/landmark_pallas.py::landmark_softmax``
(forward only). On a CUDA tensor the call runs ``csrc/landmark.cu``; on a
CPU tensor it runs :func:`landmark_softmax_ref`.
"""

import torch
import torch.nn.functional as F

from . import _common

KERNEL = "landmark_softmax"


def landmark_softmax_ref(q: torch.Tensor, k: torch.Tensor, m: int, pad: int = 0):
    """Plain version, with the TPU kernel's rounding points: fp32 group
    sums scaled by 1/l and rounded to the input dtype, fp32 similarity and
    softmax, attn2 rounded to the input dtype."""
    b, h, n, dh = q.shape
    l = (n + pad) // m

    def group_mean(x):
        xp = F.pad(x.float(), (0, 0, pad, 0))  # the front pad, zeros
        return (xp.reshape(b, h, m, l, dh).sum(3) * (1.0 / l)).to(x.dtype)

    q_l, k_l = group_mean(q), group_mean(k)
    sim = torch.matmul(q_l.float(), k_l.float().transpose(-1, -2))
    return q_l, k_l, torch.softmax(sim, dim=-1).to(q.dtype)


def landmark_softmax(q: torch.Tensor, k: torch.Tensor, m: int, pad: int = 0):
    """(q_l, k_l, attn2) from head-major q, k [b, h, n, dh].

    q_l, k_l [b, h, m, dh]: means over contiguous groups of l = (n + pad) / m
    rows of the sequence front-padded with ``pad`` zero rows, which are
    never built. attn2 [b, h, m, m] = softmax(q_l k_l^T). n + pad must be a
    multiple of m."""
    b, h, n, dh = q.shape
    if (n + pad) % m:
        raise ValueError(f"n + pad = {n + pad} is not a multiple of m = {m}")
    if not _common.on_cuda(q, k):
        return landmark_softmax_ref(q, k, m, pad)
    _common.check_kernel_input("q", q, (b, h, n, dh))
    _common.check_kernel_input("k", k, (b, h, n, dh))
    if dh % 2:
        raise ValueError(f"dh = {dh} must be even")
    q_l = torch.empty(b, h, m, dh, dtype=q.dtype, device=q.device)
    k_l = torch.empty_like(q_l)
    attn2 = torch.empty(b, h, m, m, dtype=q.dtype, device=q.device)
    _common.launch(
        "mirror_landmark_softmax", q.data_ptr(), k.data_ptr(), q_l.data_ptr(),
        k_l.data_ptr(), attn2.data_ptr(), b * h, n, dh, m, (n + pad) // m, pad,
    )
    _common.count_launch(KERNEL)
    return q_l, k_l, attn2
