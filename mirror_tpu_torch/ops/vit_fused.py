"""One ViT sub-layer in one kernel launch, inference only.

Counterpart of the TPU probe ``scripts/exp_vit_fused_sublayer.py``'s four
fused kernels, with its argument layout (W_qkv [d, 3d] holds q|k|v column
blocks):

- :func:`fused_attn` (k5): W_o MHA(y W_qkv + b_qkv) + b_o;
- :func:`fused_mlp` (k7): fc2(GELU_erf(fc1(y)));
- :func:`fused_attn_block` (k8): x + k5(LN(x)), the function of kernel 6
  (``vit_attn.attn_block``) with W_qkv whole;
- :func:`fused_mlp_block` (k9): x + k7(LN(x)), the function of kernel 7
  (``vit_attn.mlp_block``).

On CUDA tensors each is one launch of ``csrc/vit_fused.cu`` that keeps
q|k|v, the head outputs and the GELU hidden on chip: the wrapper allocates
only the output. k5 and k8 run one thread-block cluster an image, a CTA
for every head or every two (the kernel's choice by shape,
:func:`heads_per_cta`; so at most 16 heads). k7 and k9 run a quad of CTAs
on each 64-row tile of the flattened [b n, d] rows: two fc1 CTAs keep the
tile y resident and take every second 128-column hidden chunk, and store
each GELU'd chunk into the shared memory of two fc2 CTAs, which sum fc2 in
registers, 384 output columns each (so d is at most
:data:`MAX_MLP_WIDTH`); the two quads of a cluster share each weight box by
TMA multicast. On CPU tensors they run the plain versions ``*_ref``,
which are ``vit_attn``'s plain half-blocks and round at the TPU kernels'
points. ``group`` is the probe's G: the images a cluster (k5, k8) walks in
turn, and for k7 and k9 the rows (G n, in tiles of 64) a quad walks.

Like the TPU kernels, which have no VJP, they are inference-only on every
device: a call that autograd would record (grad mode on and an input that
requires grad) is refused. LN scale and shift and the biases are fp32 of
any shape with the right number of elements.
"""

import functools

import torch

from . import _common
from .vit_attn import (
    _check_attention,
    _check_heads,
    _check_width,
    _refuse_grad,
    _vector,
    attn_block_ref,
    attn_sublayer_ref,
    mlp_block_ref,
    mlp_sublayer_ref,
)

KERNEL_ATTN = "vit_fused_attn"  # k5
KERNEL_MLP = "vit_fused_mlp"  # k7
KERNEL_ATTN_BLOCK = "vit_fused_attn_block"  # k8
KERNEL_MLP_BLOCK = "vit_fused_mlp_block"  # k9
MAX_HEADS = 16  # a cluster is one CTA a head or two, and 16 is the largest cluster
MAX_MLP_WIDTH = 768  # k7/k9's fc2 accumulator: two CTAs of three warpgroups of 128 columns
SMEM_PER_BLOCK = 232448  # bytes of shared memory a Hopper block can have


def fused_attn_ref(y, wqkv, bqkv, wo, bo, heads: int):
    """Plain version of :func:`fused_attn`."""
    wq, wk, wv = wqkv.split(y.shape[-1], dim=1)
    return attn_sublayer_ref(y, wq, wk, wv, bqkv, wo, bo, heads).to(y.dtype)


def fused_mlp_ref(y, w1, b1, w2, b2):
    """Plain version of :func:`fused_mlp`."""
    return mlp_sublayer_ref(y, w1, b1, w2, b2).to(y.dtype)


def fused_attn_block_ref(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int, eps: float = 1e-12):
    """Plain version of :func:`fused_attn_block`: ``attn_block_ref`` with
    W_qkv split."""
    return attn_block_ref(x, ln_s, ln_b, *wqkv.split(x.shape[-1], dim=1), bqkv, wo, bo, heads,
                          eps)


fused_mlp_block_ref = mlp_block_ref  # k9 is kernel 7's function


def heads_per_cta(n: int, dh: int, heads: int) -> int:
    """The heads a CTA of the attention kernel takes at this shape: two
    where they pair up and fit, else one."""
    return _common.scratch_elems("mirror_vit_fused_attn_heads_per_cta", n, dh, heads)


@functools.lru_cache(maxsize=None)
def max_clusters(n: int, dh: int, heads: int, device_index: int) -> int:
    """How many clusters of the attention kernel the card holds at once at
    this shape (``cudaOccupancyMaxActiveClusters``)."""
    with torch.cuda.device(device_index):
        return _common.scratch_elems("mirror_vit_fused_attn_clusters", n, dh, heads)


@functools.lru_cache(maxsize=None)
def mlp_clusters(device_index: int) -> int:
    """How many clusters of the MLP kernel the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    with torch.cuda.device(device_index):
        return _common.scratch_elems("mirror_vit_fused_mlp_clusters")


def _ln_pointers(ln, d: int):
    """The LN scale and shift as the kernels read them, or two nulls (k5,
    k7: no LN)."""
    if ln is None:
        return None, None
    return tuple(_vector(name, t, d).data_ptr() for name, t in zip(("ln_s", "ln_b"), ln))


def _attn(x, ln, wqkv, bqkv, wo, bo, heads, eps, group, kernel):
    b, n, d = x.shape
    _check_heads(kernel, d, heads)
    dh = d // heads
    _check_width("feature dim", d)
    _check_attention(n, dh)
    if heads > MAX_HEADS:
        raise ValueError(f"{heads} heads: the fused attention runs a cluster of one CTA a "
                         f"head or two, and a cluster has at most {MAX_HEADS} CTAs")
    if group < 1:
        raise ValueError(f"group {group}: a cluster walks at least one image")
    _common.check_kernel_input("x", x, (b, n, d))
    _common.check_kernel_input("wqkv", wqkv, (d, 3 * d))
    _common.check_kernel_input("wo", wo, (d, d))
    ln_ptrs = _ln_pointers(ln, d)
    bqkv, bo = _vector("bqkv", bqkv, 3 * d), _vector("bo", bo, d)
    smem = _common.scratch_elems("mirror_vit_fused_attn_smem", n, dh, heads)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{n} tokens, head dim {dh}: a CTA of the fused "
                         f"attention needs {smem} bytes of shared memory, a block has at most "
                         f"{SMEM_PER_BLOCK}")
    clusters = max_clusters(n, dh, heads, x.device.index or 0)
    if clusters <= 0:
        cs = heads // heads_per_cta(n, dh, heads)
        raise RuntimeError(f"{kernel}: a cluster of {cs} CTAs with {smem} bytes of "
                           f"shared memory each cannot be scheduled on this card "
                           f"(cudaOccupancyMaxActiveClusters: {clusters})")
    out = torch.empty_like(x)
    _common.launch("mirror_vit_fused_attn", x.data_ptr(), *ln_ptrs, wqkv.data_ptr(),
                   bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), out.data_ptr(), b, n, heads,
                   dh, group, dh ** -0.5, eps)
    _common.count_launch(kernel)
    return out


def _mlp(x, ln, w1, b1, w2, b2, eps, group, kernel):
    b, n, d = x.shape
    m = w1.shape[-1]
    _check_width("feature dim", d)
    _check_width("MLP width", m)
    if d > MAX_MLP_WIDTH:
        raise ValueError(f"feature dim {d}: the fused MLP keeps a 64-row tile's fc2 "
                         f"accumulator in the registers of two CTAs, 384 columns each, so it "
                         f"takes at most {MAX_MLP_WIDTH}")
    if group < 1:
        raise ValueError(f"group {group}: a quad of CTAs walks at least one image")
    _common.check_kernel_input("x", x, (b, n, d))
    _common.check_kernel_input("w1", w1, (d, m))
    _common.check_kernel_input("w2", w2, (m, d))
    ln_ptrs = _ln_pointers(ln, d)
    b1, b2 = _vector("b1", b1, m), _vector("b2", b2, d)
    out = torch.empty_like(x)
    _common.launch("mirror_vit_fused_mlp", x.data_ptr(), *ln_ptrs, w1.data_ptr(), b1.data_ptr(),
                   w2.data_ptr(), b2.data_ptr(), out.data_ptr(), b * n, group * n, d, m, eps)
    _common.count_launch(kernel)
    return out


def fused_attn(y, wqkv, bqkv, wo, bo, heads: int, group: int = 1):
    """k5: W_o MHA(y W_qkv + b_qkv) + b_o over y [b, n, d]; W_qkv [d, 3d]
    ([in, out], q|k|v), W_o [d, d], b_qkv [3d], b_o [d]."""
    args = (y, wqkv, bqkv, wo, bo)
    _refuse_grad("fused_attn", *args)
    if not _common.on_cuda(*args):
        _check_heads("fused_attn", y.shape[-1], heads)
        return fused_attn_ref(*args, heads)
    return _attn(y, None, wqkv, bqkv, wo, bo, heads, 0.0, group, KERNEL_ATTN)


def fused_mlp(y, w1, b1, w2, b2, group: int = 1):
    """k7: fc2(GELU_erf(fc1(y))) over y [b, n, d]; w1 [d, m], w2 [m, d]."""
    args = (y, w1, b1, w2, b2)
    _refuse_grad("fused_mlp", *args)
    if not _common.on_cuda(*args):
        return fused_mlp_ref(*args)
    return _mlp(y, None, w1, b1, w2, b2, 0.0, group, KERNEL_MLP)


def fused_attn_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int, eps: float = 1e-12,
                     group: int = 1):
    """k8: x + k5(LN(x)), the pre-LN attention half-block in one launch."""
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    _refuse_grad("fused_attn_block", *args)
    if not _common.on_cuda(*args):
        _check_heads("fused_attn_block", x.shape[-1], heads)
        return fused_attn_block_ref(*args, heads, eps)
    return _attn(x, (ln_s, ln_b), wqkv, bqkv, wo, bo, heads, eps, group, KERNEL_ATTN_BLOCK)


def fused_mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, eps: float = 1e-12, group: int = 1):
    """k9: x + k7(LN(x)), the pre-LN MLP half-block in one launch."""
    args = (x, ln_s, ln_b, w1, b1, w2, b2)
    _refuse_grad("fused_mlp_block", *args)
    if not _common.on_cuda(*args):
        return fused_mlp_block_ref(*args, eps)
    return _mlp(x, (ln_s, ln_b), w1, b1, w2, b2, eps, group, KERNEL_MLP_BLOCK)
