"""Context parallelism: the patch tokens of ONE whole slide split over the ranks.

Counterpart of ``mirror_tpu/parallel/context_parallel.py``, with its names.
The reference encodes at most 2048 sampled patches a slide because one GPU
holds the whole sequence; here every patch of a slide is encoded, the token
axis of each Nystrom attention split over the ranks of the process group
(one process a device, ``distributed.session``), and the softmaxes are
computed exactly across the ranks:

- q/k/v and the output projection are row-wise: local;
- n is a multiple of m and m of the rank count P, so each rank owns m / P
  whole landmark groups: it takes their means, and one all-gather
  (``distributed.gather_along``) gives every rank the [m, dh] landmarks;
- attn2 = softmax(q_l k_l^T) and its pseudo-inverse involve landmarks only:
  every rank computes them alike (replicated). The pinv's scale is this
  rank's (``global_scale(over_ranks=False)``): every rank holds the same
  attn2, and a reduction over the ranks would count it once a rank;
- r3 = softmax(q_l k^T) v is a row softmax over ALL n columns: each rank
  runs the attention on its own columns, keeping its row log-sum-exp, and
  :class:`KvCombine` combines the ranks' parts exactly, flash-decoding
  style (lse_g = logsumexp over the ranks, r3 = sum_r exp(lse_r - lse_g) o_r);
- attn1 @ (pinv @ r3) is a softmax over the m landmarks: row-local;
- the 33-tap depthwise conv of v along the sequence takes a 16-row halo from
  each neighbour (``distributed.halo_exchange``, zeros at the ends of the
  sequence); a block shorter than the halo takes the gather path (the whole
  v, then its own rows of the conv).

On the card the attention core runs the port's kernels on each rank's
rows, unchanged: the pinv (kernel 2, and 2b for ``pinv_grad="exact"``),
the attention over this rank's columns (kernel 3; its backward 3c with the
global lse and r3), the attention over the landmarks (3b; backward 3c) and
the conv on the halo-extended block (9; backward 9b). On CPU tensors the
same wrappers run their plain versions; a module built with
``use_pallas=False`` runs the plain path on any device, as
``NystromAttention`` does. The landmark means and the [m, m] softmax are
plain torch, as they are plain jnp in the JAX code.

:func:`transmil_encode_cp` holds the sequence whole on every rank outside
the attention core (fc1, the LayerNorms, PPEG); only the core is split.

Gradients follow one rule: a tensor that every rank holds alike gets as
gradient the sum of the ranks' partials, summed once, at the collective
that made it. :func:`nystrom_attention_cp` is differentiable with each
rank's loss a function of its own rows (the total loss the sum over the
ranks; a parameter's gradient is then the sum of the ranks' gradients).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.nystrom import NystromAttention
from ..models.transmil import FeatureTransMIL, _square_pad_tokens
from ..ops import _common
from ..ops.conv1d import depthwise_conv1d_seq, depthwise_conv_seq_plain
from ..ops.nystrom_attn import (
    KERNEL,
    KERNEL_BWD,
    _launch_bwd,
    _launch_fwd,
    softmax_attn_bwd_lse_ref,
    softmax_attn_fwd_ref,
    softmax_attn_ref,
    softmax_matmul_landmark_q,
)
from ..ops.pinv import moore_penrose_pinv, moore_penrose_pinv_ref
from . import distributed


def wrap_pad_square(tokens: np.ndarray) -> np.ndarray:
    """Extend [n, D] raw patch features to the next square count side^2
    (side = ceil(sqrt(n))) by repeating the leading rows: the encoder's own
    wrap pad (``models/transmil.py::_square_pad_tokens``) done on the host,
    which fc1 being row-wise makes the same."""
    tokens = np.asarray(tokens)
    n = tokens.shape[0]
    side = int(math.ceil(math.sqrt(n)))
    add = side * side - n
    if add == 0:
        return tokens
    return np.concatenate([tokens, tokens[:add]], axis=0)


def _combine(o: torch.Tensor, lse: torch.Tensor):
    """(lse_g, r3): the row log-sum-exp over every rank's columns and the
    ranks' attention parts o (each normalised by its own lse) combined in
    fp32, rounded to o's dtype."""
    if distributed.world_size() == 1:
        return lse, o
    lse_g = torch.logsumexp(torch.stack(distributed.gather_parts(lse)), dim=0)
    part = torch.exp(lse - lse_g).unsqueeze(-1) * o.float()
    return lse_g, distributed.all_reduce(part, axis="world").to(o.dtype)


class KvCombine(torch.autograd.Function):
    """r3 = softmax(q_l k^T) v over the columns of every rank, for q_l
    [b, h, m, dh] that every rank holds and this rank's k, v [b, h, n_loc,
    dh]. Forward: the attention over this rank's columns with its row
    log-sum-exp (kernel 3, ``_launch_fwd(keep=True)``, on the card), then
    :func:`_combine`. Backward: the incoming gradient (a partial on each
    rank) summed over the ranks, then the attention's backward (kernel 3c)
    given the GLOBAL lse and r3 in place of this rank's residuals, so that
    its P = exp(s - lse) and D = rowsum(g r3) are the global softmax's:
    dk and dv of this rank's columns are exact, dq_l is this rank's
    partial (summed where q_l was gathered). With ``kernels`` False, or on
    CPU tensors, the kernels' plain versions run in their place."""

    @staticmethod
    def forward(ctx, q_l, k, v, kernels: bool):
        ctx.kernels = kernels and _common.on_cuda(q_l, k, v)
        if ctx.kernels:
            o, lse, _ = _launch_fwd(q_l, k, v, None, None, 0, keep=True)
            _common.count_launch(_common.instance(KERNEL, q_l.dtype))
        else:
            o, lse, _ = softmax_attn_fwd_ref(q_l, k, v)
        lse_g, r3 = _combine(o, lse)
        ctx.save_for_backward(q_l, k, v, lse_g, r3)
        return r3

    @staticmethod
    def backward(ctx, g):
        q_l, k, v, lse_g, r3 = ctx.saved_tensors
        g = _common.grad_or_zeros(g, r3)
        if distributed.world_size() > 1:
            g = distributed.all_reduce(g, axis="world").to(r3.dtype)
        if ctx.kernels:
            dq, dk, dv, _, _ = _launch_bwd(q_l, k, v, g, lse_g, r3, None, None)
            _common.count_launch(_common.instance(KERNEL_BWD, q_l.dtype))
            return dq, dk, dv, None
        dq, dk, dv = softmax_attn_bwd_lse_ref(q_l, k, v, g, lse_g, r3)
        return dq.to(q_l.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def _check_split(n: int, m: int, ranks: int) -> None:
    """The JAX code's asserts: n a multiple of m and m of the rank count, so
    that each rank owns whole landmark groups."""
    if n % m or m % ranks:
        raise ValueError(f"context parallelism needs the sequence ({n}) a multiple of the "
                         f"landmarks ({m}) and the landmarks a multiple of the ranks ({ranks})")


def _cp_core(q, k, v, kern, m: int, iters: int, pinv_grad: str, kernels: bool):
    """The attention core of one rank's block: q (scaled), k, v [1, h,
    n_loc, dh] head-major, kern [h, K] or None; returns [1, h, n_loc, dh]."""
    b, h, n_loc, dh = q.shape
    m_loc = m // distributed.world_size()
    l = n_loc // m_loc
    # this rank's landmark means (fp32 group sums times 1/l, rounded: the
    # landmark kernel's rounding points), then every rank's: one gather
    means = torch.stack([q, k]).float().reshape(2, b, h, m_loc, l, dh).sum(4)
    q_l, k_l = distributed.gather_along((means * (1.0 / l)).to(q.dtype), 3).unbind(0)
    sim2 = torch.matmul(q_l.float(), k_l.float().transpose(-1, -2))
    attn2 = torch.softmax(sim2, dim=-1).to(q.dtype)
    pinv = moore_penrose_pinv if kernels else moore_penrose_pinv_ref
    attn2_inv = pinv(attn2, iters, pinv_grad, over_ranks=False)
    r3 = KvCombine.apply(q_l, k, v, kernels)
    w = torch.matmul(attn2_inv, r3).to(q.dtype)
    if kernels:
        out = softmax_matmul_landmark_q(q, k_l.contiguous(), w)
    else:
        out = softmax_attn_ref(q, k_l, w).to(q.dtype)
    if kern is None:
        return out

    def conv(x):
        if kernels:
            return depthwise_conv1d_seq(x, kern)
        return depthwise_conv_seq_plain(x, kern.to(x.dtype)).to(x.dtype)

    halo = kern.shape[1] // 2
    if n_loc >= halo:
        res = conv(distributed.halo_exchange(v, 2, halo)).narrow(2, halo, n_loc)
    else:  # a block shorter than the halo: the whole v, then our rows
        res = conv(distributed.gather_along(v, 2)).narrow(2, distributed.rank() * n_loc, n_loc)
    return out + res


def nystrom_attention_cp(x: torch.Tensor, attn: NystromAttention) -> torch.Tensor:
    """Context-parallel ``attn`` (a NystromAttention, its own weights) on
    ONE sequence: ``x`` [n_loc, dim] is this rank's block of the n = P n_loc
    tokens (the blocks in rank order are the sequence); returns this rank's
    [n_loc, dim] of the output. n must be a multiple of the landmarks and
    the landmarks of P (the caller front-pads; :func:`transmil_encode_cp`
    does). The output dropout is live only in training mode."""
    n_loc = x.shape[0]
    h, dh, m = attn.heads, attn.dim_head, attn.num_landmarks
    _check_split(n_loc * distributed.world_size(), m, distributed.world_size())
    cdt = attn.dtype or torch.float32
    qkv = attn.to_qkv(x).reshape(1, n_loc, 3, h, dh).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous() for t in qkv.unbind(0))  # each [1, h, n_loc, dh]
    q = q * dh ** -0.5
    kern = attn._res_kernel(cdt) if attn.res_conv is not None else None
    out = _cp_core(q, k, v, kern, m, attn.pinv_iterations, attn.pinv_grad, attn.use_pallas)
    out = out[0].transpose(0, 1).reshape(n_loc, h * dh)
    return attn.to_out(out.to(x.dtype))


def _attn_block(x: torch.Tensor, layer) -> torch.Tensor:
    """x + attn(norm(x)) of a TransLayer on the whole [seq, D] sequence that
    every rank holds: the normed sequence front-padded with zero rows to a
    multiple of the landmarks (the pad lands on rank 0, or on the first
    ranks when it is longer than a block), this rank's block through
    :func:`nystrom_attention_cp`, the blocks gathered, the pad dropped."""
    y = layer.norm(x)
    m, ranks = layer.attn.num_landmarks, distributed.world_size()
    pad = (-y.shape[0]) % m
    _check_split(y.shape[0] + pad, m, ranks)
    n_loc = (y.shape[0] + pad) // ranks
    start = distributed.rank() * n_loc - pad  # of our block, in y's rows
    lo, hi = max(start, 0), max(start + n_loc, 0)
    y_loc = F.pad(y[lo:hi], (0, 0, n_loc - (hi - lo), 0))
    out = distributed.gather_along(nystrom_attention_cp(y_loc, layer.attn), 0)
    return x + out[pad:]


def transmil_encode_cp(encoder: FeatureTransMIL, tokens: torch.Tensor) -> torch.Tensor:
    """Encode ONE whole slide: tokens [n, input_dim] (every patch, any n, the
    same on every rank) -> the normed sequence [1 + side^2, embed_dim] on
    every rank; row 0 is the slide's cls embedding. ``FeatureTransMIL.encode``
    (the wrap pad to a square grid, cls, TransLayer, PPEG, TransLayer,
    LayerNorm) with each attention core split over the ranks. For
    inference: its output on every rank is a function of every rank's
    rows, so a loss taken on it alike on each rank is not a per-rank loss."""
    cdt = encoder.dtype or torch.float32
    h, side, _ = _square_pad_tokens(encoder._fc1(tokens.to(cdt)).unsqueeze(0))
    cls = encoder.cls_token.to(h.dtype).reshape(1, encoder.embed_dim)
    x = torch.cat([cls, h[0]], dim=0)
    x = _attn_block(x, encoder.layer1)
    x = encoder.pos_layer(x.unsqueeze(0), side, side)[0]
    x = _attn_block(x, encoder.layer2)
    return encoder.norm(x)
