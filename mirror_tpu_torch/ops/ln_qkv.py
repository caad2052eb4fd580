"""Fused LayerNorm + head-major q/k/v projection, with its backward.

Counterpart of ``mirror_tpu/ops/ln_qkv_pallas.py::ln_qkv_fused`` and its
custom VJP. As in the JAX package it is library-only: no model of the port
calls it (the JAX package wires it to nothing, ``mirror_tpu/ops/__init__.py``).
:class:`LnQkv` is the only caller of the kernels: on CUDA tensors its
forward and backward run the launch sequences :func:`fwd_sequence` and
:func:`bwd_sequence` on ``csrc/ln_qkv.cu``'s entries (a row pass, then
``wgmma`` GEMMs fed by TMA, then the LN backward); on CPU tensors
:func:`ln_qkv_ref` and :func:`ln_qkv_bwd_ref`, with the Pallas kernels'
rounding points: the LN statistics in fp32 with flax's fast variance, y
rounded to x's dtype before the product, each output rounded once; in the
backward, the incoming gradients in x's dtype, gy in fp32 up to the LN
backward, gw summed in fp32 over the whole batch and rounded once.

The CPU tests run the same sequences through :data:`PLAIN_LAUNCHER`, the
plain version of each C entry; :func:`store_plan` is the forward GEMM's
epilogue and :func:`gw_row_ranges` the split of gw's rows, in Python.
"""

from types import SimpleNamespace

import torch

from . import _common

KERNEL = "ln_qkv"
KERNEL_BWD = "ln_qkv_bwd"
MAX_DIM = 2048  # the LN backward keeps 16 fp32 partial rows of d in shared memory
# csrc/ln_qkv.cu's tiling: the forward's 128 x 192 tiles, its store boxes of
# 64 x 64, and gw's K step (a split of gw's rows is whole steps)
TILE_M, TILE_N, BOX, ROW_STEP = 128, 192, 64, 64


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


def head_major_index(b: int, n: int, heads: int, dh: int) -> torch.Tensor:
    """[b n, 3 h dh] int64: where element (row, c) of the q|k|v product lies
    in q, k and v flattened one after the other (each [b, h, n, dh]), as
    ``csrc/ln_qkv.cu::head_major`` computes it: tensor c / (h dh), head
    (c % (h dh)) / dh, feature c % dh, sequence row / n, position row % n."""
    inner = heads * dh
    row = torch.arange(b * n).view(-1, 1)
    c = torch.arange(3 * inner).view(1, -1)
    which, rem = c // inner, c % inner
    bi, i = row // n, row % n
    return which * (b * inner * n) + ((bi * heads + rem // dh) * n + i) * dh + rem % dh


def store_plan(b: int, n: int, heads: int, dh: int):
    """The stores of the forward GEMM's epilogue (``mirror_ln_qkv_gemm``),
    in its order: (row0, rows, col0, cols, which, bh, i0, e0), the block
    [row0:row0 + rows, col0:col0 + cols] of the [b n, 3 h dh] product going
    to q, k or v (which) [bh, i0:i0 + rows, e0:e0 + cols].

    With dh 64, 96 or 192 a 192-column tile holds whole heads: row tiles of
    128 start at each sequence's first row, and each consumer warpgroup's 64
    rows of a head go out as TMA boxes of 64 columns, clipped at n and dh
    (a head of 96 is two boxes). Other dh take flat 128-row tiles and
    16-byte stores, [1, 8] blocks, each within one head."""
    M, N, inner = b * n, 3 * heads * dh, heads * dh
    plan = []
    if dh >= BOX and TILE_N % dh == 0:
        for seq in range(b):
            for i0 in range(0, n, TILE_M):
                for n0 in range(0, N, TILE_N):
                    for ih in (i0, i0 + 64):
                        if ih >= n:
                            continue
                        boxes = []
                        for col in range(n0, min(N, n0 + TILE_N), 8):
                            which, rem = divmod(col, inner)
                            hh, e = divmod(rem, dh)
                            e0 = e - e % BOX
                            box = (col - e + e0, which, seq * heads + hh, e0)
                            if box not in boxes:
                                boxes.append(box)
                        plan += [(seq * n + ih, min(64, n - ih), c0, min(BOX, dh - e0), which,
                                  bh, ih, e0) for c0, which, bh, e0 in boxes]
        return plan
    for m0 in range(0, M, TILE_M):
        for n0 in range(0, N, TILE_N):
            for row in range(m0, min(M, m0 + TILE_M)):
                bi, i = divmod(row, n)
                for col in range(n0, min(N, n0 + TILE_N), 8):
                    which, rem = divmod(col, inner)
                    hh, e = divmod(rem, dh)
                    plan.append((row, 1, col, 8, which, bi * heads + hh, i, e))
    return plan


def gw_row_ranges(rows: int, splits: int):
    """gw's row ranges for ``splits`` (``mirror_ln_qkv_grad_w``): whole K
    steps of ``ROW_STEP`` rows, as equal as they come, none empty (so at
    most ``splits`` of them)."""
    steps = -(-rows // ROW_STEP)
    per = -(-steps // max(1, min(splits, steps))) * ROW_STEP
    return [(r, min(rows, r + per)) for r in range(0, rows, per)]


# --- the C entries of csrc/ln_qkv.cu and their plain versions ------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_rows(x, s, b, eps, y, stats=None, g=None, G=None) -> None:
    """y = LN(x) [b n, d] (``mirror_ln_qkv_rows``); with ``stats`` [2, b n]
    fp32 also each row's mean and rstd, with ``G`` [b n, 3 h dh] also the
    gather of g = (gq, gk, gv)."""
    bsz, n, d = x.shape
    gq, gk, gv = g if g is not None else (None, None, None)
    heads, dh = (gq.shape[1], gq.shape[3]) if g is not None else (0, 0)
    _common.launch("mirror_ln_qkv_rows", x.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(),
                   _ptr(stats), _ptr(gq), _ptr(gk), _ptr(gv), _ptr(G), bsz * n, d, n, heads, dh,
                   eps)


def rows_ref(x, s, b, eps, y, stats=None, g=None, G=None) -> None:
    """Plain ``mirror_ln_qkv_rows``, in place: y = :func:`_ln_f32`'s y in
    y's dtype; stats the fp32 mean and rstd; G gathered through
    :func:`head_major_index`."""
    bsz, n, d = x.shape
    yf, _, rstd = _ln_f32(x, s, b, eps)
    y.copy_(yf.reshape(y.shape))
    if stats is not None:
        stats.copy_(torch.stack([x.float().mean(-1).reshape(-1), rstd.reshape(-1)]))
    if G is not None:
        idx = head_major_index(bsz, n, g[0].shape[1], g[0].shape[3])
        G.copy_(torch.cat([t.reshape(-1) for t in g])[idx.to(G.device)])


def _launch_qkv(y, w, q, k, v) -> None:
    """q|k|v = y w head-major (``mirror_ln_qkv_gemm``)."""
    bsz, heads, n, dh = q.shape
    _common.launch("mirror_ln_qkv_gemm", y.data_ptr(), w.data_ptr(), q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), bsz, n, w.shape[0], heads, dh)


def qkv_ref(y, w, q, k, v) -> None:
    """Plain ``mirror_ln_qkv_gemm``, in place: y w in fp32, rounded once to
    q's dtype, scattered through :func:`head_major_index`."""
    bsz, heads, n, dh = q.shape
    out = torch.empty(3 * q.numel(), dtype=q.dtype, device=q.device)
    out[head_major_index(bsz, n, heads, dh).to(q.device)] = (y.float() @ w.float()).to(q.dtype)
    for t, o in zip((q, k, v), out.view(3, *q.shape)):
        t.copy_(o)


def _launch_grad_y(G, w, gy) -> None:
    """gy = G w^T in fp32 (``mirror_ln_qkv_grad_y``)."""
    _common.launch("mirror_ln_qkv_grad_y", G.data_ptr(), w.data_ptr(), gy.data_ptr(),
                   G.shape[0], w.shape[0], w.shape[1])


def grad_y_ref(G, w, gy) -> None:
    """Plain ``mirror_ln_qkv_grad_y``, in place."""
    gy.copy_(G.float() @ w.float().t())


def _gw_splits(rows: int, d: int, n3: int) -> int:
    """The kernel's own number of gw's row ranges for the card's SMs."""
    return _common.scratch_elems("mirror_ln_qkv_gw_splits", rows, d, n3)


def _launch_grad_w(y, G, gw, splits: int) -> None:
    """gw = y^T G summed in fp32 over :func:`gw_row_ranges`, the ranges'
    partials added in order, rounded once (``mirror_ln_qkv_grad_w``)."""
    rows, d = y.shape
    n3 = G.shape[1]
    part = torch.empty(len(gw_row_ranges(rows, splits)), d, n3, dtype=torch.float32,
                       device=y.device)
    _common.launch("mirror_ln_qkv_grad_w", y.data_ptr(), G.data_ptr(), gw.data_ptr(),
                   part.data_ptr(), rows, d, n3, splits)


def grad_w_ref(y, G, gw, splits: int) -> None:
    """Plain ``mirror_ln_qkv_grad_w``, in place: one fp32 product a range of
    :func:`gw_row_ranges`, added in order, then rounded to gw's dtype."""
    total = None
    for r0, r1 in gw_row_ranges(y.shape[0], splits):
        part = y[r0:r1].float().t() @ G[r0:r1].float()
        total = part if total is None else total + part
    gw.copy_(total)


def _launch_ln_bwd(gy, x, stats, s, gx, gsb) -> None:
    """gx and gsb = (gs, gb) from gy and the row statistics
    (``mirror_ln_qkv_ln_bwd``)."""
    rows, d = gy.shape
    part = torch.empty(_common.scratch_elems("mirror_ln_qkv_ln_bwd_partial_elems", rows, d),
                       dtype=torch.float32, device=gy.device)
    _common.launch("mirror_ln_qkv_ln_bwd", gy.data_ptr(), x.data_ptr(), stats.data_ptr(),
                   s.data_ptr(), gx.data_ptr(), gsb.data_ptr(), part.data_ptr(), rows, d)


def ln_bwd_ref(gy, x, stats, s, gx, gsb) -> None:
    """Plain ``mirror_ln_qkv_ln_bwd``, in place: xhat from the kept mean and
    rstd, gs = sum gy xhat, gb = sum gy over the rows, gx = rstd (gxhat -
    mean(gxhat) - xhat mean(gxhat xhat)) with gxhat = gy s."""
    rows, d = gy.shape
    mu, rstd = stats[0].unsqueeze(1), stats[1].unsqueeze(1)
    xhat = (x.float().reshape(rows, d) - mu) * rstd
    gsb.copy_(torch.stack([(gy * xhat).sum(0), gy.sum(0)]))
    gxhat = gy * s.float()
    m1 = gxhat.mean(-1, keepdim=True)
    m2 = (gxhat * xhat).mean(-1, keepdim=True)
    gx.copy_((rstd * (gxhat - m1 - xhat * m2)).reshape(gx.shape))


# The C entries the sequences below call, and their plain versions: the
# Function passes CUDA_LAUNCHER; the CPU tests pass PLAIN_LAUNCHER to run the
# same sequences through the plain versions.
CUDA_LAUNCHER = SimpleNamespace(rows=_launch_rows, qkv=_launch_qkv, grad_y=_launch_grad_y,
                                grad_w=_launch_grad_w, gw_splits=_gw_splits,
                                ln_bwd=_launch_ln_bwd)
PLAIN_LAUNCHER = SimpleNamespace(rows=rows_ref, qkv=qkv_ref, grad_y=grad_y_ref,
                                 grad_w=grad_w_ref, gw_splits=lambda rows, d, n3: 1,
                                 ln_bwd=ln_bwd_ref)


def fwd_sequence(x, s, b, w, heads: int, eps: float, ops=CUDA_LAUNCHER):
    """Kernel 10 as the card runs it: the row pass writes y = LN(x), then
    one GEMM writes q, k, v head-major, through ``ops``."""
    bsz, n, d = x.shape
    y = x.new_empty(bsz * n, d)
    ops.rows(x, s, b, eps, y)
    q, k, v = (x.new_empty(bsz, heads, n, _head_dim(w, heads)) for _ in range(3))
    ops.qkv(y, w, q, k, v)
    return q, k, v


def bwd_sequence(x, s, b, w, gq, gk, gv, heads: int, eps: float, splits=None,
                 ops=CUDA_LAUNCHER):
    """Kernel 10b as the card runs it, through ``ops``: the row pass writes y
    again, the row statistics and G (the gather of gq, gk, gv); gy = G w^T
    (fp32); gw = y^T G over ``splits`` row ranges (the kernel's own count
    when None); the LN backward. Returns (gx, gw, gs, gb)."""
    bsz, n, d = x.shape
    rows, n3 = bsz * n, w.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    y, G = x.new_empty(rows, d), x.new_empty(rows, n3)
    stats = torch.empty(2, rows, **f32)
    ops.rows(x, s, b, eps, y, stats=stats, g=(gq, gk, gv), G=G)
    gy = torch.empty(rows, d, **f32)
    ops.grad_y(G, w, gy)
    gw = torch.empty_like(w)
    ops.grad_w(y, G, gw, splits or ops.gw_splits(rows, d, n3))
    del y, G
    gx, gsb = torch.empty_like(x), torch.empty(2, d, **f32)
    ops.ln_bwd(gy, x, stats, s, gx, gsb)
    return gx, gw, gsb[0], gsb[1]


def _check(x, ln_scale, ln_bias, w, heads):
    b, n, d = x.shape
    dh = _head_dim(w, heads)
    if w.shape[1] != 3 * heads * dh or dh == 0:
        raise ValueError(f"w {tuple(w.shape)} is not [d, 3 * {heads} heads * dh]")
    _common.check_kernel_input("x", x, (b, n, d), torch.bfloat16)
    _common.check_kernel_input("ln_scale", ln_scale, (d,), torch.float32)
    _common.check_kernel_input("ln_bias", ln_bias, (d,), torch.float32)
    _common.check_kernel_input("w", w, (d, 3 * heads * dh), torch.bfloat16)
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
        _check(x, ln_scale, ln_bias, w, heads)
        out = fwd_sequence(x, ln_scale, ln_bias, w, heads, eps)
        _common.count_launch(KERNEL)
        return out

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
            _check(x, s, lb, w, heads)
            for name, g in (("gq", gq), ("gk", gk), ("gv", gv)):
                _common.check_kernel_input(name, g, like.shape, x.dtype)
            gx, gw, gs, gb = bwd_sequence(x, s, lb, w, gq, gk, gv, heads, eps)
            _common.count_launch(KERNEL_BWD)
        return gx, gs.to(s.dtype), gb.to(lb.dtype), gw, None, None


def ln_qkv_fused(x, ln_scale, ln_bias, w, heads: int, eps: float = 1e-5):
    """(q, k, v) head-major [b, h, n, dh] = split(LN(x; scale, bias) @ w).

    x [b, n, d] in the compute dtype; ln_scale, ln_bias [d] fp32; w
    [d, 3 h dh] in ``to_qkv``'s layout (q | k | v blocks, head-major inside
    each) in the compute dtype; dh = w.shape[1] // (3 heads), which need not
    be d // heads. Differentiable in x, the LN parameters and w: gx and gw
    take x's dtype (gw summed in fp32 over the batch), gs and gb fp32."""
    return LnQkv.apply(x, ln_scale, ln_bias, w, heads, eps)
