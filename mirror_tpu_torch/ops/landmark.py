"""Landmark means and landmark softmax of the Nystrom attention.

Counterpart of ``mirror_tpu/ops/landmark_pallas.py::landmark_softmax`` and
its custom VJP. :class:`LandmarkSoftmax` is the only caller of the kernels:
on CUDA tensors its forward runs ``csrc/landmark.cu``'s forward entry and
its backward the ``_bwd`` entry; on CPU tensors they run
:func:`landmark_softmax_ref` and :func:`landmark_softmax_bwd_ref`.
"""

import torch
import torch.nn.functional as F

from . import _common

KERNEL = "landmark_softmax"
KERNEL_BWD = "landmark_softmax_bwd"


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


def landmark_softmax_bwd_ref(q, k, m: int, pad: int, gql, gkl, ga2):
    """(dq, dk) with the TPU backward kernel's rounding points
    (landmark_pallas._bwd_kernel): the softmax is recomputed from the
    rounded means; dsim = p * ga2 - p * rowsum(p * ga2) rounded to the input
    dtype; dq_l = dsim k_l + gql and dk_l = dsim^T q_l + gkl in fp32, times
    1/l and rounded; real row i takes the rounded gradient of its group
    (i + pad) / l, so the groups made only of pad send gradient nowhere."""
    n = q.shape[2]
    l = (n + pad) // m
    q_l, k_l, _ = landmark_softmax_ref(q, k, m, pad)
    p = torch.softmax(torch.matmul(q_l.float(), k_l.float().transpose(-1, -2)), dim=-1)
    tmp = p * ga2.float()
    dsim = (tmp - p * tmp.sum(-1, keepdim=True)).to(q.dtype).float()
    dq_l = torch.matmul(dsim, k_l.float()) + gql.float()
    dk_l = torch.matmul(dsim.transpose(-1, -2), q_l.float()) + gkl.float()
    group = torch.div(torch.arange(n, device=q.device) + pad, l, rounding_mode="floor")
    dq = (dq_l * (1.0 / l)).to(q.dtype)[:, :, group]
    dk = (dk_l * (1.0 / l)).to(k.dtype)[:, :, group]
    return dq, dk


def _check(q, k, m, pad):
    b, h, n, dh = q.shape
    _common.check_kernel_input("q", q, (b, h, n, dh))
    _common.check_kernel_input("k", k, (b, h, n, dh))
    if dh % 16 or dh > 128 or m % 8:
        raise ValueError(f"dh = {dh}, m = {m}: the kernels take dh a multiple of 16 up to "
                         "128 and m a multiple of 8")


class LandmarkSoftmax(torch.autograd.Function):
    """(q_l, k_l, attn2) with the TPU kernel's VJP: only q and k are kept
    for the backward, which recomputes the means and the softmax."""

    @staticmethod
    def forward(ctx, q, k, m: int, pad: int):
        ctx.m, ctx.pad = m, pad
        ctx.save_for_backward(q, k)
        if not _common.on_cuda(q, k):
            return landmark_softmax_ref(q, k, m, pad)
        _check(q, k, m, pad)
        b, h, n, dh = q.shape
        q_l = torch.empty(b, h, m, dh, dtype=q.dtype, device=q.device)
        k_l = torch.empty_like(q_l)
        attn2 = torch.empty(b, h, m, m, dtype=q.dtype, device=q.device)
        _common.launch(
            "mirror_landmark_softmax", q.data_ptr(), k.data_ptr(), q_l.data_ptr(),
            k_l.data_ptr(), attn2.data_ptr(), b * h, n, dh, m, (n + pad) // m, pad,
        )
        _common.count_launch(KERNEL)
        return q_l, k_l, attn2

    @staticmethod
    def backward(ctx, gql, gkl, ga2):
        q, k = ctx.saved_tensors
        m, pad = ctx.m, ctx.pad
        b, h, n, dh = q.shape
        gql = _common.grad_or_zeros(gql, q.new_empty(b, h, m, dh))
        gkl = _common.grad_or_zeros(gkl, k.new_empty(b, h, m, dh))
        ga2 = _common.grad_or_zeros(ga2, q.new_empty(b, h, m, m))
        if not _common.on_cuda(q, k):
            dq, dk = landmark_softmax_bwd_ref(q, k, m, pad, gql, gkl, ga2)
            return dq, dk, None, None
        dq, dk = torch.empty_like(q), torch.empty_like(k)
        q_l, k_l = q.new_empty(b, h, m, dh), k.new_empty(b, h, m, dh)
        dsim = q.new_empty(b, h, m, m)
        _common.launch(
            "mirror_landmark_softmax_bwd", q.data_ptr(), k.data_ptr(), gql.data_ptr(),
            gkl.data_ptr(), ga2.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            q_l.data_ptr(), k_l.data_ptr(), dsim.data_ptr(), b * h, n, dh, m,
            (n + pad) // m, pad,
        )
        _common.count_launch(KERNEL_BWD)
        return dq, dk, None, None


def landmark_softmax(q: torch.Tensor, k: torch.Tensor, m: int, pad: int = 0):
    """(q_l, k_l, attn2) from head-major q, k [b, h, n, dh].

    q_l, k_l [b, h, m, dh]: means over contiguous groups of l = (n + pad) / m
    rows of the sequence front-padded with ``pad`` zero rows, which are
    never built. attn2 [b, h, m, m] = softmax(q_l k_l^T). n + pad must be a
    multiple of m. Differentiable in q and k."""
    n = q.shape[2]
    if (n + pad) % m:
        raise ValueError(f"n + pad = {n + pad} is not a multiple of m = {m}")
    return LandmarkSoftmax.apply(q, k, m, pad)
