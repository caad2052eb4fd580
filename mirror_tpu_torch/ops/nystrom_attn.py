"""Row softmax attention of the Nystrom attention, bare and conv-fused.

Counterpart of ``mirror_tpu/ops/nystrom_pallas.py``:
``softmax_matmul_landmark_kv``, ``softmax_matmul_landmark_q`` and
``fused_softmax_attn_conv`` with their custom VJPs. The two autograd
Functions here are the only callers of the kernels: on CUDA tensors the
forward runs ``csrc/softmax_attn.cu`` and the backward
``csrc/softmax_attn_bwd.cu`` (each with a WITH_CONV variant for the fused
residual conv); on CPU tensors they run the plain versions
:func:`softmax_attn_fwd_ref` (with :func:`depthwise_conv_seq_ref` of
``conv1d.py``, the plain conv of kernel 9 too) and
:func:`softmax_attn_bwd_lse_ref` (with :func:`depthwise_conv_seq_bwd_ref`).

Residuals. The TPU kernel's VJP keeps only (q, k, w) and recomputes the
softmax statistics in its backward. Here the forward also keeps, when
autograd will need them (grad mode on and an input that requires grad;
never in ``predict``):

- ``lse``, fp32 [b, h, r]: the row log-sum-exp over the c columns and the
  ``pad`` virtual ones, so the backward rebuilds P = exp(q k^T - lse)
  without a statistics sweep;
- ``o``, [b, h, r, d] in q's dtype: the attention output from which the
  backward takes D = rowsum(g o) (FlashAttention-2's preprocess). For the
  bare attention that is the output itself; with the fused conv it is the
  attention part before the conv is added (``o_attn``), one more tensor of
  the output's size.

D = rowsum(g o) equals the TPU kernel's rowsum(attn * (g w^T)) in real
arithmetic; in bf16 it differs by the rounding of P inside o and of o
itself. :func:`softmax_attn_bwd_ref` stays the JAX-shaped reference.
"""

from typing import Optional

import torch

from . import _common
from .conv1d import depthwise_conv_seq_bwd_ref, depthwise_conv_seq_ref

KERNEL = "softmax_attn"
KERNEL_Q = "softmax_attn_q"
KERNEL_CONV = "softmax_attn_conv"
KERNEL_BWD = "softmax_attn_bwd"
KERNEL_CONV_BWD = "softmax_attn_conv_bwd"


def softmax_lse_ref(sim: torch.Tensor, pad: int) -> torch.Tensor:
    """Row log-sum-exp of [zeros(pad) | sim], fp32 [..., r]: the `pad`
    virtual columns have logit 0, so the running max starts at 0 and the
    sum at `pad` (``_softmax_pad``'s closed form on the TPU)."""
    if pad == 0:
        return torch.logsumexp(sim, dim=-1)
    mx = sim.amax(dim=-1, keepdim=True).clamp_min(0.0)
    total = torch.exp(sim - mx).sum(dim=-1, keepdim=True) + pad * torch.exp(-mx)
    return (mx + torch.log(total)).squeeze(-1)


def softmax_pad_ref(sim: torch.Tensor, pad: int) -> torch.Tensor:
    """Row softmax of [zeros(pad) | sim] restricted to the sim columns."""
    return torch.exp(sim - softmax_lse_ref(sim, pad).unsqueeze(-1))


def softmax_attn_lse_ref(q, k, w, pad: int = 0):
    """(softmax_pad(q k^T) w in fp32 before the output rounding, the fp32
    row log-sum-exp): fp32 statistics, the attention rounded to w's dtype,
    fp32 accumulation."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
    lse = softmax_lse_ref(sim, pad)
    attn = torch.exp(sim - lse.unsqueeze(-1)).to(w.dtype)
    return torch.matmul(attn.float(), w.float()), lse


def softmax_attn_ref(q, k, w, pad: int = 0) -> torch.Tensor:
    """softmax_pad(q k^T) w in fp32, before the output rounding."""
    return softmax_attn_lse_ref(q, k, w, pad)[0]


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


def softmax_attn_fwd_ref(q, k, w, pad: int = 0, v=None, kern=None):
    """The forward kernel's plain version with its residuals: (out, lse, o).

    out is :func:`softmax_attn_ref` (plus ``depthwise_conv_seq_ref(v, kern)``
    when ``v`` is given, before the one rounding) in q's dtype; lse the fp32
    row log-sum-exp [b, h, r], the pad's share included; o the attention
    part rounded to q's dtype (out itself without the conv)."""
    o32, lse = softmax_attn_lse_ref(q, k, w, pad)
    if v is None:
        out = o32.to(q.dtype)
        return out, lse, out
    return (o32 + depthwise_conv_seq_ref(v, kern)).to(q.dtype), lse, o32.to(q.dtype)


def softmax_attn_bwd_lse_ref(q, k, w, g, lse, o):
    """The backward kernel's plain version: (dq, dk, dw) in fp32, before
    their rounding, from the forward's residuals. P = exp(q k^T - lse) in
    fp32; dw = bf16(P)^T g; D = rowsum(g o) in fp32; dsim = P (g w^T) - P D
    rounded to q's dtype; dq = dsim k and dk = dsim^T q with fp32
    accumulation. The pad needs no term: it is in lse, and its dattn is 0."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp(sim - lse.unsqueeze(-1))
    dw = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), g.float())
    dattn = torch.matmul(g.float(), w.float().transpose(-1, -2))
    d = (g.float() * o.float()).sum(-1, keepdim=True)
    dsim = (p * dattn - p * d).to(q.dtype).float()
    dq = torch.matmul(dsim, k.float())
    dk = torch.matmul(dsim.transpose(-1, -2), q.float())
    return dq, dk, dw


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


def _needs_residuals(*tensors: torch.Tensor) -> bool:
    """Whether autograd will record the call, so its backward will run."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _launch_fwd(q, k, w, v: Optional[torch.Tensor], kern: Optional[torch.Tensor], pad: int,
                keep: bool):
    """(out, lse, o_attn) from csrc/softmax_attn.cu; lse (fp32 [b, h, r])
    only when ``keep``, o_attn only when ``keep`` and with the conv."""
    b, h, r, dh = q.shape
    c = k.shape[2]
    _check(q, k, w, r, c)
    ksize = 0
    if v is not None:
        _check_conv(v, kern, q.shape)
        ksize = kern.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, r, dtype=torch.float32, device=q.device) if keep else None
    o_attn = torch.empty_like(q) if keep and v is not None else None
    _common.launch(
        "mirror_softmax_attn", q.data_ptr(), k.data_ptr(), w.data_ptr(), _ptr(v), _ptr(kern),
        out.data_ptr(), _ptr(lse), _ptr(o_attn), b * h, h, r, c, dh, pad, ksize,
    )
    return out, lse, o_attn


def _launch_bwd(q, k, w, g, lse, o, v, kern):
    """(dq, dk, dw, dv, dkern fp32) from csrc/softmax_attn_bwd.cu, from the
    forward's residuals lse and o; dv and dkern are None without the conv."""
    b, h, r, dh = q.shape
    c = k.shape[2]
    _check(q, k, w, r, c)
    _common.check_kernel_input("g", g, q.shape)
    _common.check_kernel_input("lse", lse, (b, h, r), torch.float32)
    _common.check_kernel_input("o", o, q.shape)
    dq, dk, dw = torch.empty_like(q), torch.empty_like(k), torch.empty_like(w)
    dvec = torch.empty(b * h, r, dtype=torch.float32, device=q.device)
    dv = dkern = partial = None
    ksize = 0
    if v is not None:
        _check_conv(v, kern, q.shape)
        ksize = kern.shape[1]
        dv = torch.empty_like(v)
        dkern = torch.empty(h, ksize, dtype=torch.float32, device=q.device)
        elems = _common.scratch_elems("mirror_conv1d_bwd_partial_elems", b * h, r, ksize)
        partial = torch.empty(elems, dtype=torch.float32, device=q.device)
    _common.launch(
        "mirror_softmax_attn_bwd", q.data_ptr(), k.data_ptr(), w.data_ptr(), _ptr(v),
        _ptr(kern), g.data_ptr(), lse.data_ptr(), o.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dw.data_ptr(), _ptr(dv), _ptr(dkern), dvec.data_ptr(), _ptr(partial), b * h, h, r, c,
        dh, ksize,
    )
    return dq, dk, dw, dv, dkern


class SoftmaxAttn(torch.autograd.Function):
    """softmax_pad(q k^T) w. Saves (q, k, w) and, as residuals, the row
    log-sum-exp and the output itself (when ``keep``: autograd records the
    call). ``counter`` names the launch count of the forward (the kv and q
    entry points are counted apart)."""

    @staticmethod
    def forward(ctx, q, k, w, pad: int, counter: str, keep: bool):
        if not _common.on_cuda(q, k, w):
            out, lse, _ = softmax_attn_fwd_ref(q, k, w, pad)
        else:
            out, lse, _ = _launch_fwd(q, k, w, None, None, pad, keep)
            _common.count_launch(counter)
        if keep:
            ctx.save_for_backward(q, k, w, lse, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, w, lse, o = ctx.saved_tensors
        g = _common.grad_or_zeros(g, q)
        if not _common.on_cuda(q, k, w, g):
            dq, dk, dw = softmax_attn_bwd_lse_ref(q, k, w, g, lse, o)
            return dq.to(q.dtype), dk.to(k.dtype), dw.to(w.dtype), None, None, None
        dq, dk, dw, _, _ = _launch_bwd(q, k, w, g, lse, o, None, None)
        _common.count_launch(KERNEL_BWD)
        return dq, dk, dw, None, None, None


class SoftmaxAttnConv(torch.autograd.Function):
    """softmax_pad(q k_l^T) w + depthwise_conv_seq(v, kern), one rounding.
    Saves the inputs and, as residuals (when ``keep``), the row
    log-sum-exp and o_attn, the attention part before the conv. Gradients:
    dq, dk_l, dw of the attention, dv the flipped conv of g, dkern reduced
    over batch and rows (per-block partials, then a second pass:
    deterministic) and rounded to kern's dtype."""

    @staticmethod
    def forward(ctx, q, k_l, w, v, kern, pad: int, keep: bool):
        if not _common.on_cuda(q, k_l, w, v, kern):
            out, lse, o_attn = softmax_attn_fwd_ref(q, k_l, w, pad, v, kern)
        else:
            out, lse, o_attn = _launch_fwd(q, k_l, w, v, kern, pad, keep)
            _common.count_launch(KERNEL_CONV)
        if keep:
            ctx.save_for_backward(q, k_l, w, v, kern, lse, o_attn)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k_l, w, v, kern, lse, o_attn = ctx.saved_tensors
        g = _common.grad_or_zeros(g, q)
        if not _common.on_cuda(q, k_l, w, v, kern, g):
            dq, dk, dw = softmax_attn_bwd_lse_ref(q, k_l, w, g, lse, o_attn)
            dv, dkern = depthwise_conv_seq_bwd_ref(v, kern, g)
        else:
            dq, dk, dw, dv, dkern = _launch_bwd(q, k_l, w, g, lse, o_attn, v, kern)
            _common.count_launch(KERNEL_CONV_BWD)
        return (dq.to(q.dtype), dk.to(k_l.dtype), dw.to(w.dtype), dv.to(v.dtype),
                dkern.to(kern.dtype), None, None)


def fused_softmax_attn(q, k, w, pad: int = 0) -> torch.Tensor:
    """softmax(q k^T over c + pad columns) w, per (batch, head).

    q [b, h, r, d]; k, w [b, h, c, d] -> [b, h, r, d] in q's dtype. The
    `pad` virtual columns have zero k rows and zero w rows, exactly as the
    reference's front-padded sequence. Differentiable in q, k and w."""
    return SoftmaxAttn.apply(q, k, w, pad, KERNEL, _needs_residuals(q, k, w))


def softmax_matmul_landmark_kv(q_l, k, v, pad: int = 0) -> torch.Tensor:
    """r3 = softmax(q_l k^T) v : [b, h, m, d], softmax over n + pad tokens."""
    return SoftmaxAttn.apply(q_l, k, v, pad, KERNEL, _needs_residuals(q_l, k, v))


def softmax_matmul_landmark_q(q, k_l, w) -> torch.Tensor:
    """out = softmax(q k_l^T) w : [b, h, n, d], softmax over m."""
    return SoftmaxAttn.apply(q, k_l, w, 0, KERNEL_Q, _needs_residuals(q, k_l, w))


def fused_softmax_attn_conv(q, k_l, w, v, kern, pad: int = 0) -> torch.Tensor:
    """softmax(q k_l^T) w + depthwise_conv_seq(v, kern), one rounding.

    q, v [b, h, n, d]; k_l, w [b, h, m, d]; kern [h, K] (K odd).
    Differentiable in q, k_l, w, v and kern."""
    return SoftmaxAttnConv.apply(q, k_l, w, v, kern, pad,
                                 _needs_residuals(q, k_l, w, v, kern))
