"""Landmark means and landmark softmax of the Nystrom attention.

Counterpart of ``mirror_tpu/ops/landmark_pallas.py::landmark_softmax`` and
its custom VJP. :class:`LandmarkSoftmax` is the only caller of the kernels:
on CUDA tensors its forward runs ``csrc/landmark.cu`` (through the op
``mirror::landmark_softmax``, :func:`landmark_softmax_op`, which an
exported program also calls) and its backward ``csrc/landmark_bwd.cu``; on
CPU tensors they run :func:`landmark_softmax_lse_ref` and
:func:`landmark_softmax_bwd_lse_ref`.

Residuals. The TPU kernel's VJP keeps only (q, k) and recomputes the means
and the softmax statistics in its backward. Here the forward keeps q_l and
k_l (its own outputs) and the fp32 row log-sum-exp ``lse`` [b, h, m] of
q_l k_l^T, so the backward rebuilds P = exp(q_l k_l^T - lse) with no
statistics sweep and never reads q and k again. P differs from the TPU
kernel's recomputed softmax only in its last fp32 bits.
:func:`landmark_softmax_ref` and :func:`landmark_softmax_bwd_ref` stay the
JAX-shaped references.
"""

from typing import Tuple

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


def landmark_softmax_lse_ref(q: torch.Tensor, k: torch.Tensor, m: int, pad: int = 0):
    """The forward kernel's plain version with its residual: (q_l, k_l,
    attn2) of :func:`landmark_softmax_ref` and lse, the fp32 row
    log-sum-exp [b, h, m] of q_l k_l^T."""
    q_l, k_l, attn2 = landmark_softmax_ref(q, k, m, pad)
    lse = torch.logsumexp(torch.matmul(q_l.float(), k_l.float().transpose(-1, -2)), dim=-1)
    return q_l, k_l, attn2, lse


def landmark_softmax_bwd_lse_ref(q_l, k_l, lse, n: int, pad: int, gql, gkl, ga2):
    """The backward kernel's plain version: (dq, dk) [b, h, n, dh] in q_l's
    dtype from the forward's residuals. P = exp(q_l k_l^T - lse) in fp32;
    then the rounding points of :func:`landmark_softmax_bwd_ref`: dsim = P
    ga2 - P rowsum(P ga2) rounded to q_l's dtype, dq_l = dsim k_l + gql and
    dk_l = dsim^T q_l + gkl in fp32, times 1/l and rounded, broadcast to
    each group's real rows."""
    m = q_l.shape[2]
    l = (n + pad) // m
    sim = torch.matmul(q_l.float(), k_l.float().transpose(-1, -2))
    p = torch.exp(sim - lse.unsqueeze(-1))
    tmp = p * ga2.float()
    dsim = (tmp - p * tmp.sum(-1, keepdim=True)).to(q_l.dtype).float()
    dq_l = torch.matmul(dsim, k_l.float()) + gql.float()
    dk_l = torch.matmul(dsim.transpose(-1, -2), q_l.float()) + gkl.float()
    group = torch.div(torch.arange(n, device=q_l.device) + pad, l, rounding_mode="floor")
    dq = (dq_l * (1.0 / l)).to(q_l.dtype)[:, :, group]
    dk = (dk_l * (1.0 / l)).to(k_l.dtype)[:, :, group]
    return dq, dk


def bwd_refusal(dh: int, m: int):
    """What of (dh, m) the backward kernel (``csrc/landmark_bwd.cu``, 1b)
    does not take, or None: it takes dh a multiple of 16 up to 128 and m a
    multiple of 8. The forward takes any dh and m."""
    if dh % 16 or dh > 128 or m % 8:
        return (f"dh = {dh}, m = {m}: the landmark softmax's backward kernel (1b) takes dh a "
                "multiple of 16 up to 128 and m a multiple of 8")
    return None


def _launch_fwd(q, k, m: int, pad: int):
    """(q_l, k_l, attn2, lse fp32 [b, h, m]) from csrc/landmark.cu, in q's
    dtype (one of ``_common.KERNEL_DTYPES``)."""
    b, h, n, dh = q.shape
    dt = q.dtype
    _common.check_kernel_input("q", q, (b, h, n, dh), dt)
    _common.check_kernel_input("k", k, (b, h, n, dh), dt)
    q_l = torch.empty(b, h, m, dh, dtype=q.dtype, device=q.device)
    k_l = torch.empty_like(q_l)
    attn2 = torch.empty(b, h, m, m, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, m, dtype=torch.float32, device=q.device)
    _common.launch(
        "mirror_landmark_softmax", q.data_ptr(), k.data_ptr(), q_l.data_ptr(), k_l.data_ptr(),
        attn2.data_ptr(), lse.data_ptr(), b * h, n, dh, m, (n + pad) // m, pad,
        _common.type_code(dt),
    )
    return q_l, k_l, attn2, lse


def _launch_bwd(q_l, k_l, lse, n: int, pad: int, gql, gkl, ga2):
    """(dq, dk) [b, h, n, dh] from csrc/landmark_bwd.cu; a shape beyond it
    raises by name (:func:`bwd_refusal`), never reaching the plain version."""
    b, h, m, dh = q_l.shape
    why = bwd_refusal(dh, m)
    if why:
        raise ValueError(f"{why}; {_common.BWD_HINT}")
    dt = q_l.dtype
    _common.check_kernel_input("q_l", q_l, (b, h, m, dh), dt)
    _common.check_kernel_input("k_l", k_l, (b, h, m, dh), dt)
    _common.check_kernel_input("lse", lse, (b, h, m), torch.float32)
    _common.check_kernel_input("gql", gql, (b, h, m, dh), dt)
    _common.check_kernel_input("gkl", gkl, (b, h, m, dh), dt)
    _common.check_kernel_input("ga2", ga2, (b, h, m, m), dt)
    dq = torch.empty(b, h, n, dh, dtype=q_l.dtype, device=q_l.device)
    dk = torch.empty_like(dq)
    dvec = torch.empty(b * h, m, dtype=torch.float32, device=q_l.device)
    _common.launch(
        "mirror_landmark_softmax_bwd", q_l.data_ptr(), k_l.data_ptr(), lse.data_ptr(),
        gql.data_ptr(), gkl.data_ptr(), ga2.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dvec.data_ptr(), b * h, n, dh, m, (n + pad) // m, pad, _common.type_code(dt),
    )
    return dq, dk


@torch.library.custom_op(f"{_common.OP_NAMESPACE}::landmark_softmax", mutates_args=(),
                         device_types="cpu")
def landmark_softmax_op(q: torch.Tensor, k: torch.Tensor, m: int,
                        pad: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mirror::landmark_softmax``: (q_l, k_l, attn2, lse fp32 [b, h, m]);
    on the CPU :func:`landmark_softmax_lse_ref`."""
    return landmark_softmax_lse_ref(q, k, m, pad)


@landmark_softmax_op.register_kernel("cuda")
def _landmark_softmax_cuda(q, k, m, pad):
    out = _launch_fwd(q, k, m, pad)
    _common.count_launch(_common.instance(KERNEL, q.dtype))
    return out


@landmark_softmax_op.register_fake
def _landmark_softmax_fake(q, k, m, pad):
    b, h, _, dh = q.shape
    return (q.new_empty(b, h, m, dh), q.new_empty(b, h, m, dh), q.new_empty(b, h, m, m),
            q.new_empty(b, h, m, dtype=torch.float32))


class LandmarkSoftmax(torch.autograd.Function):
    """(q_l, k_l, attn2) by :func:`landmark_softmax_op`; saves q_l, k_l and
    the row log-sum-exp for the backward, which neither recomputes the
    means nor reads q and k."""

    @staticmethod
    def forward(ctx, q, k, m: int, pad: int):
        q_l, k_l, attn2, lse = landmark_softmax_op(q, k, m, pad)
        ctx.n, ctx.pad = q.shape[2], pad
        ctx.save_for_backward(q_l, k_l, lse)
        return q_l, k_l, attn2

    @staticmethod
    def backward(ctx, gql, gkl, ga2):
        q_l, k_l, lse = ctx.saved_tensors
        b, h, m, _ = q_l.shape
        gql = _common.grad_or_zeros(gql, q_l)
        gkl = _common.grad_or_zeros(gkl, k_l)
        ga2 = _common.grad_or_zeros(ga2, q_l.new_empty(b, h, m, m))
        if not _common.on_cuda(q_l, k_l):
            dq, dk = landmark_softmax_bwd_lse_ref(q_l, k_l, lse, ctx.n, ctx.pad, gql, gkl, ga2)
            return dq, dk, None, None
        dq, dk = _launch_bwd(q_l, k_l, lse, ctx.n, ctx.pad, gql, gkl, ga2)
        _common.count_launch(_common.instance(KERNEL_BWD, q_l.dtype))
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
