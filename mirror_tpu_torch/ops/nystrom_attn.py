"""Row softmax attention of the Nystrom attention, bare and conv-fused.

Counterpart of ``mirror_tpu/ops/nystrom_pallas.py``:
``softmax_matmul_landmark_kv``, ``softmax_matmul_landmark_q`` and
``fused_softmax_attn_conv`` with their custom VJPs. The two autograd
Functions here are the only callers of the kernels: on CUDA tensors the
forward runs ``csrc/softmax_attn.cu`` and the backward
``csrc/softmax_attn_bwd.cu`` (each with a WITH_CONV variant for the fused
residual conv); on CPU tensors they run :func:`softmax_attn_ref`,
:func:`depthwise_conv_seq_ref` and the plain backward versions.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from . import _common

KERNEL = "softmax_attn"
KERNEL_Q = "softmax_attn_q"
KERNEL_CONV = "softmax_attn_conv"
KERNEL_BWD = "softmax_attn_bwd"
KERNEL_CONV_BWD = "softmax_attn_conv_bwd"


def softmax_pad_ref(sim: torch.Tensor, pad: int) -> torch.Tensor:
    """Row softmax of [zeros(pad) | sim] restricted to the sim columns: the
    `pad` virtual columns have logit 0 (``_softmax_pad`` on the TPU)."""
    if pad == 0:
        return torch.softmax(sim, dim=-1)
    mx = sim.amax(dim=-1, keepdim=True).clamp_min(0.0)
    e = torch.exp(sim - mx)
    return e / (e.sum(dim=-1, keepdim=True) + pad * torch.exp(-mx))


def softmax_attn_ref(q, k, w, pad: int = 0) -> torch.Tensor:
    """softmax_pad(q k^T) w in fp32, before the output rounding: fp32
    statistics, the attention rounded to w's dtype, fp32 accumulation."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = softmax_pad_ref(sim, pad).to(w.dtype)
    return torch.matmul(attn.float(), w.float())


def softmax_attn_bwd_ref(q, k, w, g, pad: int = 0):
    """(dq, dk, dw) in fp32, before their rounding, with the rounding points
    of ``_attn_bwd_math`` (nystrom_pallas.py:73-100): the softmax recomputed
    in fp32; dw = bf16(attn)^T g; dsim = attn * dattn - attn * rowsum(attn *
    dattn) with dattn = g w^T, rounded to q's dtype; dq = dsim k and
    dk = dsim^T q with fp32 accumulation. The pad columns add nothing beyond
    the denominator: their dattn is 0."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = softmax_pad_ref(sim, pad)
    dw = torch.matmul(attn.to(g.dtype).float().transpose(-1, -2), g.float())
    dattn = torch.matmul(g.float(), w.float().transpose(-1, -2))
    tmp = attn * dattn
    dsim = (tmp - attn * tmp.sum(-1, keepdim=True)).to(q.dtype).float()
    dq = torch.matmul(dsim, k.float())
    dk = torch.matmul(dsim.transpose(-1, -2), q.float())
    return dq, dk, dw


def depthwise_conv_seq_ref(v: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """fp32 depthwise conv along the sequence of v [b, h, n, d] with one
    K-tap filter per head (kern [h, K]), zero SAME padding, no bias: the
    reference's Conv2d(h, h, (K, 1), groups=h)."""
    h, ksize = kern.shape
    weight = kern.float().reshape(h, 1, ksize, 1)
    return F.conv2d(v.float(), weight, padding=(ksize // 2, 0), groups=h)


def depthwise_conv_seq_bwd_ref(v, kern, g):
    """(dv, dkern) of the residual conv in fp32, before their rounding, as
    the TPU kernel computes them (conv1d_pallas): dv is the conv of g with
    the flipped taps (taps rounded to g's dtype, the banded matrix's);
    dkern[h, t] = sum over batch, rows and features of g[i] v[i + t - K/2]."""
    ksize = kern.shape[1]
    half = ksize // 2
    dv = depthwise_conv_seq_ref(g, kern.to(g.dtype).flip(-1))
    n = v.shape[2]
    g32, vp = g.float(), F.pad(v.float(), (0, 0, half, half))
    dkern = torch.stack([(g32 * vp[:, :, t:t + n]).sum((0, 2, 3)) for t in range(ksize)],
                        dim=1)
    return dv, dkern


def _check(q, k, w, r, c):
    b, h, _, dh = q.shape
    _common.check_kernel_input("q", q, (b, h, r, dh))
    _common.check_kernel_input("k", k, (b, h, c, dh))
    _common.check_kernel_input("w", w, (b, h, c, dh))
    if dh % 16 or dh > 128:
        raise ValueError(f"dh = {dh}: the kernel takes multiples of 16 up to 128")


def _check_conv(v, kern, shape):
    _common.check_kernel_input("v", v, shape)
    _common.check_kernel_input("kern", kern, (shape[1], kern.shape[1]))
    ksize = kern.shape[1]
    if ksize % 2 == 0 or ksize > 65:
        raise ValueError(f"conv taps = {ksize}: the kernel takes odd K up to 65")


def _launch_fwd(q, k, w, v: Optional[torch.Tensor], kern: Optional[torch.Tensor], pad: int):
    b, h, r, dh = q.shape
    c = k.shape[2]
    _check(q, k, w, r, c)
    ksize = 0
    if v is not None:
        _check_conv(v, kern, q.shape)
        ksize = kern.shape[1]
    out = torch.empty_like(q)
    _common.launch(
        "mirror_softmax_attn", q.data_ptr(), k.data_ptr(), w.data_ptr(),
        v.data_ptr() if v is not None else None,
        kern.data_ptr() if kern is not None else None,
        out.data_ptr(), b * h, h, r, c, dh, pad, ksize,
    )
    return out


def _launch_bwd(q, k, w, g, v, kern, pad: int):
    """(dq, dk, dw, dv, dkern fp32) from csrc/softmax_attn_bwd.cu; dv and
    dkern are None without the conv."""
    b, h, r, dh = q.shape
    c = k.shape[2]
    _check(q, k, w, r, c)
    _common.check_kernel_input("g", g, q.shape)
    dq, dk, dw = torch.empty_like(q), torch.empty_like(k), torch.empty_like(w)
    stats = torch.empty(b * h, r, 3, dtype=torch.float32, device=q.device)
    dv = dkern = partial = None
    ksize = 0
    if v is not None:
        _check_conv(v, kern, q.shape)
        ksize = kern.shape[1]
        dv = torch.empty_like(v)
        dkern = torch.empty(h, ksize, dtype=torch.float32, device=q.device)
        elems = _common.scratch_elems("mirror_softmax_attn_bwd_partial_elems", b * h, r, ksize)
        partial = torch.empty(elems, dtype=torch.float32, device=q.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    _common.launch(
        "mirror_softmax_attn_bwd", q.data_ptr(), k.data_ptr(), w.data_ptr(), ptr(v),
        ptr(kern), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dw.data_ptr(), ptr(dv),
        ptr(dkern), stats.data_ptr(), ptr(partial), b * h, h, r, c, dh, pad, ksize,
    )
    return dq, dk, dw, dv, dkern


class SoftmaxAttn(torch.autograd.Function):
    """softmax_pad(q k^T) w with the TPU kernel's VJP (q, k, w kept; the
    softmax recomputed in the backward). ``counter`` names the launch count
    of the forward (the kv and q entry points are counted apart)."""

    @staticmethod
    def forward(ctx, q, k, w, pad: int, counter: str):
        ctx.pad = pad
        ctx.save_for_backward(q, k, w)
        if not _common.on_cuda(q, k, w):
            return softmax_attn_ref(q, k, w, pad).to(q.dtype)
        out = _launch_fwd(q, k, w, None, None, pad)
        _common.count_launch(counter)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, w = ctx.saved_tensors
        g = _common.grad_or_zeros(g, q)
        if not _common.on_cuda(q, k, w, g):
            dq, dk, dw = softmax_attn_bwd_ref(q, k, w, g, ctx.pad)
            return dq.to(q.dtype), dk.to(k.dtype), dw.to(w.dtype), None, None
        dq, dk, dw, _, _ = _launch_bwd(q, k, w, g, None, None, ctx.pad)
        _common.count_launch(KERNEL_BWD)
        return dq, dk, dw, None, None


class SoftmaxAttnConv(torch.autograd.Function):
    """softmax_pad(q k_l^T) w + depthwise_conv_seq(v, kern), one rounding,
    with the TPU kernel's VJP: dq, dk_l, dw of the attention, dv the flipped
    conv of g, dkern reduced over batch and rows (per-block partials, then a
    second pass: deterministic) and rounded to kern's dtype."""

    @staticmethod
    def forward(ctx, q, k_l, w, v, kern, pad: int):
        ctx.pad = pad
        ctx.save_for_backward(q, k_l, w, v, kern)
        if not _common.on_cuda(q, k_l, w, v, kern):
            out = softmax_attn_ref(q, k_l, w, pad) + depthwise_conv_seq_ref(v, kern)
            return out.to(q.dtype)
        out = _launch_fwd(q, k_l, w, v, kern, pad)
        _common.count_launch(KERNEL_CONV)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k_l, w, v, kern = ctx.saved_tensors
        g = _common.grad_or_zeros(g, q)
        if not _common.on_cuda(q, k_l, w, v, kern, g):
            dq, dk, dw = softmax_attn_bwd_ref(q, k_l, w, g, ctx.pad)
            dv, dkern = depthwise_conv_seq_bwd_ref(v, kern, g)
        else:
            dq, dk, dw, dv, dkern = _launch_bwd(q, k_l, w, g, v, kern, ctx.pad)
            _common.count_launch(KERNEL_CONV_BWD)
        return (dq.to(q.dtype), dk.to(k_l.dtype), dw.to(w.dtype), dv.to(v.dtype),
                dkern.to(kern.dtype), None)


def fused_softmax_attn(q, k, w, pad: int = 0) -> torch.Tensor:
    """softmax(q k^T over c + pad columns) w, per (batch, head).

    q [b, h, r, d]; k, w [b, h, c, d] -> [b, h, r, d] in q's dtype. The
    `pad` virtual columns have zero k rows and zero w rows, exactly as the
    reference's front-padded sequence. Differentiable in q, k and w."""
    return SoftmaxAttn.apply(q, k, w, pad, KERNEL)


def softmax_matmul_landmark_kv(q_l, k, v, pad: int = 0) -> torch.Tensor:
    """r3 = softmax(q_l k^T) v : [b, h, m, d], softmax over n + pad tokens."""
    return SoftmaxAttn.apply(q_l, k, v, pad, KERNEL)


def softmax_matmul_landmark_q(q, k_l, w) -> torch.Tensor:
    """out = softmax(q k_l^T) w : [b, h, n, d], softmax over m."""
    return SoftmaxAttn.apply(q, k_l, w, 0, KERNEL_Q)


def fused_softmax_attn_conv(q, k_l, w, v, kern, pad: int = 0) -> torch.Tensor:
    """softmax(q k_l^T) w + depthwise_conv_seq(v, kern), one rounding.

    q, v [b, h, n, d]; k_l, w [b, h, m, d]; kern [h, K] (K odd).
    Differentiable in q, k_l, w, v and kern."""
    return SoftmaxAttnConv.apply(q, k_l, w, v, kern, pad)
