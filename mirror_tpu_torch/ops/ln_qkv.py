"""Fused LayerNorm + head-major q/k/v projection, with its backward.

Counterpart of ``mirror_tpu/ops/ln_qkv_pallas.py::ln_qkv_fused`` and its
custom VJP. As in the JAX package it is library-only: no model of the port
calls it (the JAX package wires it to nothing, ``mirror_tpu/ops/__init__.py``).
:class:`LnQkv` is the only caller of the kernels: on CUDA tensors its
forward and backward run ``csrc/ln_qkv.cu``; on CPU tensors
:func:`ln_qkv_ref` and :func:`ln_qkv_bwd_ref`, with the Pallas kernels'
rounding points: the LN statistics in fp32 with flax's fast variance, y
rounded to x's dtype before the product, each output rounded once; in the
backward, the incoming gradients in x's dtype, gy in fp32 up to the LN
backward, gw summed in fp32 over the whole batch and rounded once.
"""

import torch

from . import _common

KERNEL = "ln_qkv"
KERNEL_BWD = "ln_qkv_bwd"
MAX_DIM = 2048  # the LN backward keeps 16 fp32 partial rows of d in shared memory


def _ln_f32(x, s, b, eps):
    """flax fast-variance LayerNorm in fp32: (y, xhat, rstd)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    return xhat * s.float() + b.float(), xhat, rstd


def _head_dim(w, heads: int) -> int:
    return w.shape[1] // (3 * heads)


def ln_qkv_ref(x, ln_scale, ln_bias, w, heads: int, eps: float = 1e-5):
    """Plain version: (q, k, v), each [b, h, n, dh] in x's dtype."""
    b, n, _ = x.shape
    dh = _head_dim(w, heads)
    y = _ln_f32(x, ln_scale, ln_bias, eps)[0].to(x.dtype)
    qkv = torch.matmul(y.float(), w.float()).to(x.dtype)
    return tuple(t.contiguous() for t in
                 qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0))


def ln_qkv_bwd_ref(x, ln_scale, ln_bias, w, gq, gk, gv, heads: int, eps: float = 1e-5):
    """(gx, gw, gs, gb) in fp32, before the rounding of gx and gw, as
    ``_bwd_kernel`` computes them from gq, gk, gv in x's dtype: G their
    head-major gather [b n, 3 h dh]; gy = G w^T; gw = bf16(y)^T G over all
    rows; gs = sum gy xhat, gb = sum gy; gx = rstd (gxhat - mean(gxhat) -
    xhat mean(gxhat xhat)) with gxhat = gy s."""
    b, n, d = x.shape
    y, xhat, rstd = _ln_f32(x, ln_scale, ln_bias, eps)
    g = torch.stack([gq, gk, gv]).permute(1, 3, 0, 2, 4).reshape(b * n, -1).float()
    gy = (g @ w.float().t()).reshape(b, n, d)
    gw = y.to(x.dtype).float().reshape(b * n, d).t() @ g
    gs = (gy * xhat).sum((0, 1))
    gb = gy.sum((0, 1))
    gxhat = gy * ln_scale.float()
    m1 = gxhat.mean(-1, keepdim=True)
    m2 = (gxhat * xhat).mean(-1, keepdim=True)
    return rstd * (gxhat - m1 - xhat * m2), gw, gs, gb


def _check(x, ln_scale, ln_bias, w, heads):
    b, n, d = x.shape
    dh = _head_dim(w, heads)
    if w.shape[1] != 3 * heads * dh or dh == 0:
        raise ValueError(f"w {tuple(w.shape)} is not [d, 3 * {heads} heads * dh]")
    _common.check_kernel_input("x", x, (b, n, d))
    _common.check_kernel_input("ln_scale", ln_scale, (d,), torch.float32)
    _common.check_kernel_input("ln_bias", ln_bias, (d,), torch.float32)
    _common.check_kernel_input("w", w, (d, 3 * heads * dh))
    if d % 8 or d > MAX_DIM:
        raise ValueError(f"feature dim {d}: the kernel takes multiples of 8 up to {MAX_DIM}")
    if dh % 8:
        raise ValueError(f"head dim {dh}: the kernel takes multiples of 8")
    return b, n, d, dh


class LnQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, heads: int, eps: float):
        ctx.heads, ctx.eps = heads, eps
        ctx.save_for_backward(x, ln_scale, ln_bias, w)
        if not _common.on_cuda(x, ln_scale, ln_bias, w):
            return ln_qkv_ref(x, ln_scale, ln_bias, w, heads, eps)
        b, n, d, dh = _check(x, ln_scale, ln_bias, w, heads)
        q, k, v = (x.new_empty(b, heads, n, dh) for _ in range(3))
        stats = torch.empty(2, b * n, dtype=torch.float32, device=x.device)
        _common.launch("mirror_ln_qkv", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                       w.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       stats.data_ptr(), b, n, d, heads, dh, eps)
        _common.count_launch(KERNEL)
        return q, k, v

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, s, lb, w = ctx.saved_tensors
        heads, eps = ctx.heads, ctx.eps
        b, n, d = x.shape
        like = x.new_empty(b, heads, n, _head_dim(w, heads))
        gq, gk, gv = (_common.grad_or_zeros(g, like) for g in (gq, gk, gv))
        if not _common.on_cuda(x, s, lb, w, gq, gk, gv):
            gx, gw, gs, gb = ln_qkv_bwd_ref(x, s, lb, w, gq, gk, gv, heads, eps)
            gx, gw = gx.to(x.dtype), gw.to(x.dtype)
        else:
            _, _, _, dh = _check(x, s, lb, w, heads)
            for name, g in (("gq", gq), ("gk", gk), ("gv", gv)):
                _common.check_kernel_input(name, g, like.shape)
            gx, gw = torch.empty_like(x), torch.empty_like(w)
            gsb = torch.empty(2, d, dtype=torch.float32, device=x.device)
            elems = _common.scratch_elems("mirror_ln_qkv_bwd_scratch_elems", b, n, d, heads, dh)
            scratch = torch.empty(elems, dtype=torch.float32, device=x.device)
            _common.launch("mirror_ln_qkv_bwd", x.data_ptr(), s.data_ptr(), lb.data_ptr(),
                           w.data_ptr(), gq.data_ptr(), gk.data_ptr(), gv.data_ptr(),
                           gx.data_ptr(), gw.data_ptr(), gsb.data_ptr(), scratch.data_ptr(),
                           b, n, d, heads, dh, eps)
            _common.count_launch(KERNEL_BWD)
            gs, gb = gsb
        return gx, gs.to(s.dtype), gb.to(lb.dtype), gw, None, None


def ln_qkv_fused(x, ln_scale, ln_bias, w, heads: int, eps: float = 1e-5):
    """(q, k, v) head-major [b, h, n, dh] = split(LN(x; scale, bias) @ w).

    x [b, n, d] in the compute dtype; ln_scale, ln_bias [d] fp32; w
    [d, 3 h dh] in ``to_qkv``'s layout (q | k | v blocks, head-major inside
    each) in the compute dtype; dh = w.shape[1] // (3 heads), which need not
    be d // heads. Differentiable in x, the LN parameters and w: gx and gw
    take x's dtype (gw summed in fp32 over the batch), gs and gb fp32."""
    return LnQkv.apply(x, ln_scale, ln_bias, w, heads, eps)
