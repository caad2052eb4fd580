"""The ViT half-block kernels of feature extraction, inference only.

Counterpart of ``mirror_tpu/ops/vit_attn_pallas.py``, with its entries and
argument order:

- :func:`attn_block`: x + W_o MHA(LN(x) W_qkv + b_qkv) + b_o (K6);
- :func:`mlp_block`: x + fc2(GELU_erf(fc1(LN(x)))) (K7);
- :func:`mha_natural`: softmax(q k^T / sqrt(dh)) v on the natural [b, n, d]
  layout, head h in columns [h dh, (h+1) dh) (K8);
- :func:`mha_headmajor`: the same on head-major [b h, n, dh] pairs, with G
  pairs a block, and :func:`mha_natural` with ``images`` whole images a
  block: the layouts of the probe ``scripts/exp_vit_attn_kernel.py`` (K11c),
  one kernel instance (``vit_attn.cu``) for all of them.

On CUDA tensors they launch ``csrc/vit_gemm.cu`` (the LN pass, and the
projections with the bias, GELU and residual epilogues) and
``csrc/vit_attn.cu`` (the attention); on CPU tensors the plain versions
``*_ref``, which round at the TPU kernels' points: y = LN(x) to x's dtype,
q, k, v after an fp32 bias add, the probabilities before P v, each head's
output, the GELU hidden before fc2, and out-projection + bias + residual
summed in fp32 and rounded once. On the card a half-block is a sequence of
launches (:func:`attn_block_sequence`, :func:`mlp_block_sequence`) that
takes a launcher: :data:`CUDA_LAUNCHER`, or :data:`PLAIN_LAUNCHER`, the
plain versions of the C entries, with which the CPU tests run the same
sequence. :func:`attn_block_qkv` is :func:`attn_block` with W_q | W_k | W_v
already side by side, for a caller that keeps them so (the ViT model).

Like the Pallas kernels, which have no VJP, the kernels are inference-only:
on CUDA, a call that autograd would record (grad mode on and an input that
requires grad) is refused. ``ln_s``, ``ln_b`` and the biases are fp32 of any
shape with d (or 3d, or the MLP width) elements, as ``[1, d]`` or ``[d]``;
``bqkv`` is q|k|v concatenated.
"""

from types import SimpleNamespace
from typing import Optional

import torch

from . import _common

KERNEL_ATTN_BLOCK = "vit_attn_block"
KERNEL_MLP_BLOCK = "vit_mlp_block"
KERNEL_MHA = "vit_mha_natural"
KERNEL_MHA_GROUPED = "vit_mha_natural_grouped"
KERNEL_MHA_HEADMAJOR = "vit_mha_headmajor"
KERNEL_LN = "vit_ln"  # each launch of the LN pass (two a block)
KERNEL_GEMM = "vit_gemm"  # each launch of the projection GEMM (four a block)
MAX_TOKENS = 256  # vit_attn.cu keeps a score row in registers
MAX_LN_WIDTH = 4096  # the LN pass holds a row in registers: 16 chunks of 8 a lane
# the epilogues of mirror_vit_gemm
_EPI_BIAS, _EPI_BIAS_GELU, _EPI_BIAS_RESIDUAL = 0, 1, 2


def _check_heads(name: str, d: int, heads: int) -> None:
    if d % heads:
        raise ValueError(f"{name}: feature dim {d} not divisible by heads={heads}")


def _ln_ref(x, s, b, eps):
    """_ln_f32: fp32 statistics, the result in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * s.float().reshape(-1)
            + b.float().reshape(-1)).to(x.dtype)


def mha_natural_ref(q, k, v, heads: int):
    """Plain version of :func:`mha_natural`: fp32 scores and softmax, the
    probabilities and the output in q's dtype."""
    b, n, d = q.shape
    dh = d // heads

    def split(t):  # [b, heads, n, dh]
        return t.reshape(b, n, heads, dh).transpose(1, 2).float()

    sim = split(q) @ split(k).transpose(-1, -2)
    attn = torch.softmax(sim * dh ** -0.5, dim=-1)
    out = (attn.to(q.dtype).float() @ split(v)).to(q.dtype)
    return out.transpose(1, 2).reshape(b, n, d)


def attn_sublayer_ref(y, wq, wk, wv, bqkv, wo, bo, heads: int):
    """W_o MHA(y W_qkv + b_qkv) + b_o in fp32, not yet rounded: q, k, v
    rounded to y's dtype after the fp32 bias add, then
    :func:`mha_natural_ref`."""
    d = y.shape[-1]
    yf, bqkv = y.float(), bqkv.float().reshape(-1)
    q, k, v = ((yf @ w.float() + bqkv[i * d:(i + 1) * d]).to(y.dtype)
               for i, w in enumerate((wq, wk, wv)))
    att = mha_natural_ref(q, k, v, heads)
    return att.float() @ wo.float() + bo.float().reshape(-1)


def mlp_sublayer_ref(y, w1, b1, w2, b2):
    """fc2(GELU_erf(fc1(y))) in fp32, not yet rounded: the GELU in fp32, the
    hidden rounded to y's dtype before fc2."""
    h = y.float() @ w1.float() + b1.float().reshape(-1)
    h = 0.5 * h * (1.0 + torch.erf(h * 2.0 ** -0.5))  # exact GELU, fp32
    return h.to(y.dtype).float() @ w2.float() + b2.float().reshape(-1)


def attn_block_ref(x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo, heads: int, eps: float = 1e-12):
    o = attn_sublayer_ref(_ln_ref(x, ln_s, ln_b, eps), wq, wk, wv, bqkv, wo, bo, heads)
    return (x.float() + o).to(x.dtype)


def mlp_block_ref(x, ln_s, ln_b, w1, b1, w2, b2, eps: float = 1e-12):
    o = mlp_sublayer_ref(_ln_ref(x, ln_s, ln_b, eps), w1, b1, w2, b2)
    return (x.float() + o).to(x.dtype)


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel is inference-only (no backward, like the "
                           "TPU kernel); call it under torch.no_grad()")


def _vector(name: str, t: torch.Tensor, size: int) -> torch.Tensor:
    """An fp32 parameter vector of ``size`` elements, checked as the
    kernels read it."""
    t = t.reshape(-1)
    _common.check_kernel_input(name, t, (size,), torch.float32)
    return t


def _check_width(name: str, value: int) -> None:
    if value % 8:
        raise ValueError(f"{name} {value}: the kernels load 8 bf16 values at a time, so it "
                         "must be a multiple of 8")


def _check_attention(n: int, dh: int) -> None:
    if n > MAX_TOKENS:
        raise ValueError(f"{n} tokens: the attention kernel takes at most {MAX_TOKENS}")
    if dh % 16 or dh > 128:
        raise ValueError(f"head dim {dh}: the attention kernel takes a multiple of 16 up "
                         "to 128")


def mha_headmajor_ref(q, k, v):
    """Plain version of :func:`mha_headmajor`, the rounding points of
    :func:`mha_natural_ref`."""
    sim = q.float() @ k.float().transpose(-1, -2)
    attn = torch.softmax(sim * q.shape[-1] ** -0.5, dim=-1)
    return (attn.to(q.dtype).float() @ v.float()).to(q.dtype)


def _attention(q, k, v, images, heads, dh, ld, group, kernel):
    out = torch.empty_like(q)
    _common.launch("mirror_vit_attn", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   images, q.shape[1], heads, dh, ld, ld, group, dh ** -0.5)
    _common.count_launch(kernel)
    return out


def mha_natural(q, k, v, heads: int, images: Optional[int] = None):
    """softmax(q k^T / sqrt(dh)) v over ``heads`` head slices of the last
    dim of q, k, v [b, n, d]; the output in q's dtype. On the card a block
    walks consecutive (image, head) pairs: one block an SM, each taking its
    share (the model's path), or with ``images`` N the heads of N whole
    images a block."""
    _check_heads("mha_natural", q.shape[-1], heads)
    if not _common.on_cuda(q, k, v):
        return mha_natural_ref(q, k, v, heads)
    _refuse_grad("mha_natural", q, k, v)
    b, n, d = q.shape
    _check_width("feature dim", d)
    _check_attention(n, d // heads)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _common.check_kernel_input(name, t, (b, n, d))
    if images is None:
        return _attention(q, k, v, b, heads, d // heads, d, 1, KERNEL_MHA)
    return _attention(q, k, v, b, heads, d // heads, d, images * heads, KERNEL_MHA_GROUPED)


def mha_headmajor(q, k, v, group: int = 1):
    """softmax(q k^T / sqrt(dh)) v for each of the b h pairs of head-major
    q, k, v [b h, n, dh]; the output in q's dtype. On the card a block takes
    ``group`` pairs in turn."""
    if not _common.on_cuda(q, k, v):
        return mha_headmajor_ref(q, k, v)
    _refuse_grad("mha_headmajor", q, k, v)
    z, n, dh = q.shape
    _check_attention(n, dh)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _common.check_kernel_input(name, t, (z, n, dh))
    return _attention(q, k, v, z, 1, dh, dh, group, KERNEL_MHA_HEADMAJOR)


# --- the half-blocks as launch sequences ---------------------------------------


def _launch_ln(x, s, b, eps, y) -> None:
    """y = LN(x) (``mirror_vit_ln``), s and b fp32 vectors of d."""
    d = x.shape[-1]
    _common.launch("mirror_vit_ln", x.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(),
                   x.numel() // d, d, eps)
    _common.count_launch(KERNEL_LN)


def ln_ref(x, s, b, eps, y) -> None:
    """Plain ``mirror_vit_ln``: y = :func:`_ln_ref` (x), in place."""
    y.copy_(_ln_ref(x, s, b, eps))


def _launch_gemm(a, w, bias, out, epilogue, resid=None) -> None:
    """out = epilogue(a w + bias) (``mirror_vit_gemm``), w [K, N]."""
    k, n = w.shape
    _common.launch("mirror_vit_gemm", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                   resid.data_ptr() if resid is not None else None, out.data_ptr(),
                   a.numel() // k, n, k, epilogue)
    _common.count_launch(KERNEL_GEMM)


def gemm_ref(a, w, bias, out, epilogue, resid=None) -> None:
    """Plain ``mirror_vit_gemm``, in place: P = a w in fp32, then + bias;
    with GELU the exact erf GELU of that; with the residual resid + that;
    rounded once to out's dtype."""
    k, n = w.shape
    v = a.float().reshape(-1, k) @ w.float() + bias.float().reshape(-1)
    if epilogue == _EPI_BIAS_GELU:
        v = 0.5 * v * (1.0 + torch.erf(v * 2.0 ** -0.5))
    elif epilogue == _EPI_BIAS_RESIDUAL:
        v = resid.float().reshape(-1, n) + v
    out.copy_(v.to(out.dtype).view(out.shape))


def _launch_attn(qkv, out, heads: int) -> None:
    """out = MHA of the q|k|v buffer [b, n, 3d] (``mirror_vit_attn``, each of
    q, k, v read with leading dimension 3d)."""
    b, n, d = out.shape
    dh, elem = d // heads, qkv.element_size()
    _common.launch("mirror_vit_attn", qkv.data_ptr(), qkv.data_ptr() + d * elem,
                   qkv.data_ptr() + 2 * d * elem, out.data_ptr(), b, n, heads, dh, 3 * d, d, 1,
                   dh ** -0.5)


def attn_ref(qkv, out, heads: int) -> None:
    """Plain version of :func:`_launch_attn`: :func:`mha_natural_ref` on the
    q, k, v views of the buffer, in place."""
    q, k, v = qkv.chunk(3, dim=-1)
    out.copy_(mha_natural_ref(q, k, v, heads))


# The C entries the sequences below call, and their plain versions: the
# wrappers pass CUDA_LAUNCHER; the CPU tests pass PLAIN_LAUNCHER to run the
# same sequences through the plain versions.
CUDA_LAUNCHER = SimpleNamespace(ln=_launch_ln, gemm=_launch_gemm, attn=_launch_attn)
PLAIN_LAUNCHER = SimpleNamespace(ln=ln_ref, gemm=gemm_ref, attn=attn_ref)


def attn_block_sequence(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int, eps: float,
                        ops=CUDA_LAUNCHER):
    """Kernel 6 as the card runs it: the LN pass, one q|k|v product ([d, 3d],
    + bias), the attention on that buffer, the output projection (+ bias,
    + x), through ``ops``."""
    y = torch.empty_like(x)
    ops.ln(x, ln_s, ln_b, eps, y)
    qkv = torch.empty(*x.shape[:-1], wqkv.shape[1], dtype=x.dtype, device=x.device)
    ops.gemm(y, wqkv, bqkv, qkv, _EPI_BIAS)
    del y
    att = torch.empty_like(x)
    ops.attn(qkv, att, heads)
    del qkv
    out = torch.empty_like(x)
    ops.gemm(att, wo, bo, out, _EPI_BIAS_RESIDUAL, resid=x)
    return out


def mlp_block_sequence(x, ln_s, ln_b, w1, b1, w2, b2, eps: float, ops=CUDA_LAUNCHER):
    """Kernel 7 as the card runs it: the LN pass, fc1 (+ bias, GELU), fc2
    (+ bias, + x), through ``ops``."""
    y = torch.empty_like(x)
    ops.ln(x, ln_s, ln_b, eps, y)
    h = torch.empty(*x.shape[:-1], w1.shape[1], dtype=x.dtype, device=x.device)
    ops.gemm(y, w1, b1, h, _EPI_BIAS_GELU)
    del y
    out = torch.empty_like(x)
    ops.gemm(h, w2, b2, out, _EPI_BIAS_RESIDUAL, resid=x)
    return out


def _check_ln_width(d: int) -> None:
    _check_width("feature dim", d)
    if d > MAX_LN_WIDTH:
        raise ValueError(f"feature dim {d}: the LN pass holds a row in registers, at most "
                         f"{MAX_LN_WIDTH}")


def attn_block_qkv(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int, eps: float = 1e-12):
    """:func:`attn_block` with W_q | W_k | W_v side by side: wqkv [d, 3d]."""
    _check_heads("attn_block", x.shape[-1], heads)
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    if not _common.on_cuda(*args):
        wq, wk, wv = wqkv.chunk(3, dim=1)
        return attn_block_ref(x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo, heads, eps)
    _refuse_grad("attn_block", *args)
    b, n, d = x.shape
    _check_ln_width(d)
    _check_attention(n, d // heads)
    _common.check_kernel_input("x", x, (b, n, d))
    _common.check_kernel_input("wqkv", wqkv, (d, 3 * d))
    _common.check_kernel_input("wo", wo, (d, d))
    out = attn_block_sequence(x, _vector("ln_s", ln_s, d), _vector("ln_b", ln_b, d), wqkv,
                              _vector("bqkv", bqkv, 3 * d), wo, _vector("bo", bo, d), heads,
                              eps)
    _common.count_launch(KERNEL_ATTN_BLOCK)
    return out


def attn_block(x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo, heads: int, eps: float = 1e-12):
    """x + out_proj(mha(qkv_proj(layernorm(x)))): the pre-LN attention
    half-block. x [b, n, d]; w* [d, d] ([in, out]); bqkv [3d]."""
    _check_heads("attn_block", x.shape[-1], heads)
    args = (x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo)
    if not _common.on_cuda(*args):
        return attn_block_ref(*args, heads, eps)
    d = x.shape[-1]
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        _common.check_kernel_input(name, w, (d, d))
    _refuse_grad("attn_block", *args)
    wqkv = torch.cat((wq, wk, wv), dim=1)  # [d, 3d]: one product for q|k|v
    return attn_block_qkv(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, eps)


def mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, eps: float = 1e-12):
    """x + fc2(gelu(fc1(layernorm(x)))), exact-erf GELU in fp32. x [b, n, d];
    w1 [d, m]; w2 [m, d]."""
    args = (x, ln_s, ln_b, w1, b1, w2, b2)
    if not _common.on_cuda(*args):
        return mlp_block_ref(*args, eps)
    _refuse_grad("mlp_block", *args)
    b, n, d = x.shape
    m = w1.shape[-1]
    _check_ln_width(d)
    _check_width("MLP width", m)
    _common.check_kernel_input("x", x, (b, n, d))
    _common.check_kernel_input("w1", w1, (d, m))
    _common.check_kernel_input("w2", w2, (m, d))
    out = mlp_block_sequence(x, _vector("ln_s", ln_s, d), _vector("ln_b", ln_b, d), w1,
                             _vector("b1", b1, m), w2, _vector("b2", b2, d), eps)
    _common.count_launch(KERNEL_MLP_BLOCK)
    return out
