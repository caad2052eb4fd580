"""The standalone depthwise conv along the sequence, with its backward.

Counterpart of ``mirror_tpu/ops/conv1d_pallas.py::depthwise_conv1d_seq`` and
its custom VJP. :class:`DepthwiseConv1dSeq` is the only caller of the
kernels: on CUDA tensors its forward and backward run ``csrc/conv1d.cu``; on
CPU tensors :func:`depthwise_conv_seq_ref` and
:func:`depthwise_conv_seq_bwd_ref`, which are also the plain versions of the
conv that kernel 4 (``nystrom_attn.fused_softmax_attn_conv``) carries.

Dtypes, as on the TPU: the taps are rounded to v's dtype before the forward
(the TPU kernel builds its band in ``v.dtype``), the incoming gradient is
cast to v's dtype, dv takes v's dtype and dkern the taps' (fp32 taps with
bf16 v, as ``bench.py --selftest`` passes them, get an fp32 gradient).
"""

from typing import Optional

import torch
import torch.nn.functional as F

from . import _common

KERNEL = "conv1d"
KERNEL_BWD = "conv1d_bwd"
KERNEL_BWD_DV = "conv1d_bwd_dv"
KERNEL_COLUMN_SUM = "column_sum"
MAX_TAPS = 65
MAX_DIM = 128
# csrc/conv1d.cu's tiling: 64-row steps (16 rows a warp), chunks of whole
# steps, as many as keep b h chunks within one wave of the backward
STEP_ROWS, WAVE_BLOCKS = 64, 264
# common.cuh's column sum: 256 threads a block, at most 64 part groups of
# at least 4 parts, grown until the blocks reach 264
COLUMN_SUM_THREADS, COLUMN_SUM_MAX_GROUPS = 256, 64
COLUMN_SUM_MIN_PARTS, COLUMN_SUM_TARGET_BLOCKS = 4, 264


def conv_plan(bh: int, n: int):
    """(steps a chunk, chunks) of ``csrc/conv1d.cu::conv_plan``: the rows of
    one (batch, head) in chunks of whole 64-row steps, the most chunks that
    keep b h chunks within WAVE_BLOCKS (at least one, at most one a step),
    the last one shorter. The backward writes one dkern partial a chunk."""
    steps = -(-n // STEP_ROWS)
    chunks = min(max(WAVE_BLOCKS // bh, 1), steps)
    per = -(-steps // chunks)
    return per, -(-steps // per)


def band_width(ksize: int) -> int:
    """W, the band's columns (16 + K - 1 rounded up to 16): the window rows
    a warp's 16 outputs read, and the Toeplitz product's columns s."""
    return (ksize + 30) // 16 * 16


def depthwise_conv_seq_ref(v: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """fp32 depthwise conv along the sequence of v [b, h, n, d] with one
    K-tap filter per head (kern [h, K]), zero SAME padding, no bias: the
    reference's Conv2d(h, h, (K, 1), groups=h)."""
    h, ksize = kern.shape
    weight = kern.float().reshape(h, 1, ksize, 1)
    return F.conv2d(v.float(), weight, padding=(ksize // 2, 0), groups=h)


def depthwise_conv_seq_bwd_ref(v, kern, g):
    """(dv, dkern) of the conv in fp32, before their rounding, as the TPU
    kernel computes them (conv1d_pallas): dv is the conv of g with the
    flipped taps (taps rounded to g's dtype, the banded matrix's);
    dkern[h, t] = sum over batch, rows and features of g[i] v[i + t - K/2]."""
    ksize = kern.shape[1]
    half = ksize // 2
    dv = depthwise_conv_seq_ref(g, kern.to(g.dtype).flip(-1))
    n = v.shape[2]
    g32, vp = g.float(), F.pad(v.float(), (0, 0, half, half))
    dkern = torch.stack([(g32 * vp[:, :, t:t + n]).sum((0, 2, 3)) for t in range(ksize)],
                        dim=1)
    return dv, dkern


def bwd_refusal(d: int):
    """What of the feature dim the backward kernel (9b) does not take, or
    None: it takes multiples of 8 up to MAX_DIM; the forward takes any."""
    if d % 8 or d > MAX_DIM:
        return f"feature dim {d}: the conv's backward kernel (9b) takes multiples of 8 up to {MAX_DIM}"
    return None


def _check(v, kern, backward: bool = False):
    """The kernels' inputs: v [b, h, n, d] of a compute type
    (``_common.KERNEL_DTYPES``), any d for the forward (parts of at most
    MAX_DIM features a block), what :func:`bwd_refusal` takes for the
    backward; kern [h, K] of v's type, K odd up to 65."""
    why = bwd_refusal(v.shape[-1]) if backward else None
    if why:
        raise ValueError(f"{why}; {_common.BWD_HINT}")
    _common.check_kernel_input("v", v, v.shape, v.dtype)
    b, h, n, d = v.shape
    ksize = kern.shape[-1]
    _common.check_kernel_input("kern", kern, (h, ksize), v.dtype)
    if ksize % 2 == 0 or ksize > MAX_TAPS:
        raise ValueError(f"conv taps = {ksize}: the kernel takes odd K up to {MAX_TAPS}")


def conv1d_fwd_into(v, taps, out) -> None:
    """Launch the forward kernel into ``out`` (CUDA tensors, taps of v's
    dtype)."""
    _check(v, taps)
    b, h, n, d = v.shape
    _common.check_kernel_input("out", out, v.shape, v.dtype)
    _common.launch("mirror_conv1d", v.data_ptr(), taps.data_ptr(), out.data_ptr(), b * h, h, n,
                   d, taps.shape[1], _common.type_code(v.dtype))
    _common.count_launch(_common.instance(KERNEL, v.dtype))


def conv1d_bwd_scratch(v: torch.Tensor, ksize: int) -> torch.Tensor:
    """The fp32 scratch of the backward kernel's dkern partials, as its
    tiling sizes it: [nparts, h K], the rows summed by the second pass."""
    b, h, n, d = v.shape
    elems = _common.scratch_elems("mirror_conv1d_bwd_partial_elems", b * h, n, d, ksize,
                                  _common.type_code(v.dtype))
    return torch.empty(elems // (h * ksize), h * ksize, dtype=torch.float32, device=v.device)


def conv1d_bwd_into(v, taps, g, dv, dkern, partial=None) -> None:
    """Launch the backward kernel (dv and the dkern partials, then their
    column sum) into ``dv``, ``dkern`` (fp32 [h, K]) and ``partial``
    (:func:`conv1d_bwd_scratch`, allocated here when None)."""
    _check(v, taps, backward=True)
    _common.check_kernel_input("g", g, v.shape, v.dtype)
    _common.check_kernel_input("dv", dv, v.shape, v.dtype)
    b, h, n, d = v.shape
    ksize = taps.shape[1]
    _common.check_kernel_input("dkern", dkern, (h, ksize), torch.float32)
    if partial is None:
        partial = conv1d_bwd_scratch(v, ksize)
    elems = _common.scratch_elems("mirror_conv1d_bwd_partial_elems", b * h, n, d, ksize,
                                  _common.type_code(v.dtype))
    if partial.numel() != elems:
        raise ValueError(f"partial: {partial.numel()} elements, the kernel needs {elems}")
    _common.check_kernel_input("partial", partial, partial.shape, torch.float32)
    _common.launch("mirror_conv1d_bwd", v.data_ptr(), taps.data_ptr(), g.data_ptr(),
                   dv.data_ptr(), dkern.data_ptr(), partial.data_ptr(), b * h, h, n, d, ksize,
                   _common.type_code(v.dtype))
    _common.count_launch(_common.instance(KERNEL_BWD, v.dtype))


class DepthwiseConv1dSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, kern):
        ctx.save_for_backward(v, kern)
        taps = kern.to(v.dtype)
        if not _common.on_cuda(v, kern):
            return depthwise_conv_seq_ref(v, taps).to(v.dtype)
        out = torch.empty_like(v)
        conv1d_fwd_into(v, taps.contiguous(), out)
        return out

    @staticmethod
    def backward(ctx, g):
        v, kern = ctx.saved_tensors
        g = _common.grad_or_zeros(g, v)
        taps = kern.to(v.dtype)
        if not _common.on_cuda(v, kern, g):
            dv, dkern = depthwise_conv_seq_bwd_ref(v, taps, g)
            return dv.to(v.dtype), dkern.to(kern.dtype)
        dv = torch.empty_like(v)
        dkern = torch.empty(taps.shape, dtype=torch.float32, device=v.device)
        conv1d_bwd_into(v, taps.contiguous(), g, dv, dkern)
        return dv, dkern.to(kern.dtype)


class PlainConvSeq(torch.autograd.Function):
    """:func:`depthwise_conv_seq_ref` (fp32 out) with the explicit sums of
    :func:`depthwise_conv_seq_bwd_ref` as its backward: autograd through
    torch's CPU fp32 depthwise ``conv2d`` gives a wrong weight gradient at
    some shapes (4e-2 off at v [1, 4, 256, 8], K 33)."""

    @staticmethod
    def forward(ctx, v, kern):
        ctx.save_for_backward(v, kern)
        return depthwise_conv_seq_ref(v, kern)

    @staticmethod
    def backward(ctx, g):
        v, kern = ctx.saved_tensors
        dv, dkern = depthwise_conv_seq_bwd_ref(v, kern, g)
        return dv.to(v.dtype), dkern.to(kern.dtype)


def depthwise_conv_seq_plain(v: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """The plain path's differentiable conv (:class:`PlainConvSeq`): the
    forward of :func:`depthwise_conv_seq_ref`, in fp32, on any device."""
    return PlainConvSeq.apply(v, kern)


def depthwise_conv1d_seq(v: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """SAME zero-padded depthwise conv along axis 2: out[..., i, :] =
    sum_j kern[h, j] * v[..., i + j - K//2, :]. v [b, h, n, d]; kern [h, K]
    (K odd, any n >= 1). Differentiable in v and kern."""
    return DepthwiseConv1dSeq.apply(v, kern)


def conv1d_bwd_dv_ref(g: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward's dv alone: the conv of g with the
    flipped taps (rounded to g's dtype), in fp32, rounded once."""
    return depthwise_conv_seq_ref(g, kern.to(g.dtype).flip(-1)).to(g.dtype)


def conv1d_bwd_dv(g: torch.Tensor, kern: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dv of :func:`depthwise_conv1d_seq` alone, for g [b, h, n, d] and kern
    [h, K], into ``out`` when given: on the card ``conv1d.cu``'s backward
    without its dkern slide (the probe ``exp_conv_parts`` times the two
    halves apart), bit for bit the fused kernel's dv. Not differentiable."""
    taps = kern.to(g.dtype)
    dv = torch.empty_like(g) if out is None else out
    if not _common.on_cuda(g, kern, dv):
        return dv.copy_(conv1d_bwd_dv_ref(g, taps))
    taps = taps.contiguous()
    _check(g, taps)
    _common.check_kernel_input("out", dv, g.shape, g.dtype)
    b, h, n, d = g.shape
    _common.launch("mirror_conv1d_bwd_dv", taps.data_ptr(), g.data_ptr(), dv.data_ptr(), b * h,
                   h, n, d, taps.shape[1], _common.type_code(g.dtype))
    _common.count_launch(_common.instance(KERNEL_BWD_DV, g.dtype))
    return dv


def column_sum_ref(parts: torch.Tensor) -> torch.Tensor:
    return parts.float().sum(0)


def column_sum_groups(nparts: int, count: int) -> int:
    """G, the column sum's number of part groups (``common.cuh::
    column_sum_groups``): doubled from 1 while the grid of 256-thread blocks
    (256 / G column quads each) is under the target, each group would keep
    at least COLUMN_SUM_MIN_PARTS parts and G is under the cap."""
    quads, groups = -(-count // 4), 1
    while (groups < COLUMN_SUM_MAX_GROUPS and 2 * groups * COLUMN_SUM_MIN_PARTS <= nparts
           and -(-quads // (COLUMN_SUM_THREADS // groups)) < COLUMN_SUM_TARGET_BLOCKS):
        groups *= 2
    return groups


def column_sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    """The column sum of fp32 ``parts`` [nparts, count] in the kernel's
    order (``common.cuh``), which the card's result equals bit for bit: G
    contiguous groups of ceil(nparts / G) parts, each summed in part order
    from 0, then the group sums added as a pairwise tree."""
    nparts, count = parts.shape
    groups = column_sum_groups(nparts, count)
    per = -(-nparts // groups)
    sums = torch.zeros(groups, count, dtype=torch.float32, device=parts.device)
    for k in range(per):
        rows = [w * per + k for w in range(groups) if w * per + k < nparts]
        sums[:len(rows)] += parts[rows].float()
    while sums.shape[0] > 1:
        sums = sums[0::2] + sums[1::2]
    return sums[0]


def column_sum(parts: torch.Tensor) -> torch.Tensor:
    """The sum over the rows of fp32 ``parts`` [nparts, count], in a fixed
    order on the card: the second pass of the conv's backward (and of
    PPEG's, 10b's), which turns per-block partials into dkern."""
    if not _common.on_cuda(parts):
        return column_sum_ref(parts)
    _common.check_kernel_input("parts", parts, parts.shape, torch.float32)
    if parts.dim() != 2:
        raise ValueError(f"parts {tuple(parts.shape)}: expected [nparts, count]")
    out = torch.empty(parts.shape[1], dtype=torch.float32, device=parts.device)
    _common.launch("mirror_column_sum", parts.data_ptr(), parts.shape[0], parts.shape[1],
                   out.data_ptr())
    _common.count_launch(KERNEL_COLUMN_SUM)
    return out
