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

On CUDA tensors they launch ``csrc/vit_gemm.cu`` (the projections, with the
LN prologue and the bias, GELU and residual epilogues) and
``csrc/vit_attn.cu`` (the attention); on CPU tensors the plain versions
``*_ref``, which round at the TPU kernels' points: y = LN(x) to x's dtype,
q, k, v after an fp32 bias add, the probabilities before P v, each head's
output, the GELU hidden before fc2, and out-projection + bias + residual
summed in fp32 and rounded once.

Like the Pallas kernels, which have no VJP, the kernels are inference-only:
on CUDA, a call that autograd would record (grad mode on and an input that
requires grad) is refused. ``ln_s``, ``ln_b`` and the biases are fp32 of any
shape with d (or 3d, or the MLP width) elements, as ``[1, d]`` or ``[d]``;
``bqkv`` is q|k|v concatenated.
"""

from typing import Optional

import torch

from . import _common

KERNEL_ATTN_BLOCK = "vit_attn_block"
KERNEL_MLP_BLOCK = "vit_mlp_block"
KERNEL_MHA = "vit_mha_natural"
KERNEL_MHA_GROUPED = "vit_mha_natural_grouped"
KERNEL_MHA_HEADMAJOR = "vit_mha_headmajor"
MAX_TOKENS = 256  # vit_attn.cu keeps a score row in registers
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


def attn_block_ref(x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo, heads: int, eps: float = 1e-12):
    d = x.shape[-1]
    y = _ln_ref(x, ln_s, ln_b, eps)
    yf, bqkv = y.float(), bqkv.float().reshape(-1)
    q, k, v = ((yf @ w.float() + bqkv[i * d:(i + 1) * d]).to(y.dtype)
               for i, w in enumerate((wq, wk, wv)))
    att = mha_natural_ref(q, k, v, heads)
    o = att.float() @ wo.float() + bo.float().reshape(-1)
    return (x.float() + o).to(x.dtype)


def mlp_block_ref(x, ln_s, ln_b, w1, b1, w2, b2, eps: float = 1e-12):
    y = _ln_ref(x, ln_s, ln_b, eps)
    h = y.float() @ w1.float() + b1.float().reshape(-1)
    h = 0.5 * h * (1.0 + torch.erf(h * 2.0 ** -0.5))  # exact GELU, fp32
    o = h.to(y.dtype).float() @ w2.float() + b2.float().reshape(-1)
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


def _gemm(a, w, bias, out, epilogue, ln=None, resid=None) -> None:
    """out = epilogue(LN(a) w + bias); ``ln`` = (mu, rstd, s, b)."""
    mu, rstd, s, lb = ln if ln is not None else (None,) * 4
    ptrs = [t.data_ptr() if t is not None else None for t in (mu, rstd, s, lb)]
    k, n = w.shape
    _common.launch("mirror_vit_gemm", a.data_ptr(), *ptrs, w.data_ptr(), bias.data_ptr(),
                   resid.data_ptr() if resid is not None else None, out.data_ptr(),
                   a.numel() // k, n, k, epilogue)


def _ln_stats(x, eps):
    d = x.shape[-1]
    rows = x.numel() // d
    mu = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    _common.launch("mirror_vit_ln_stats", x.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                   rows, d, eps)
    return mu, rstd


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
    owns one (image, head) pair (the model's path), or with ``images`` N
    walks the heads of N whole images in turn."""
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


def attn_block(x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo, heads: int, eps: float = 1e-12):
    """x + out_proj(mha(qkv_proj(layernorm(x)))): the pre-LN attention
    half-block. x [b, n, d]; w* [d, d] ([in, out]); bqkv [3d]."""
    _check_heads("attn_block", x.shape[-1], heads)
    args = (x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo)
    if not _common.on_cuda(*args):
        return attn_block_ref(*args, heads, eps)
    _refuse_grad("attn_block", *args)
    b, n, d = x.shape
    dh = d // heads
    _check_width("feature dim", d)
    _check_attention(n, dh)
    _common.check_kernel_input("x", x, (b, n, d))
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        _common.check_kernel_input(name, w, (d, d))
    ln = (*_ln_stats(x, eps), _vector("ln_s", ln_s, d), _vector("ln_b", ln_b, d))
    qkv = torch.empty(b, n, 3 * d, dtype=x.dtype, device=x.device)
    wqkv = torch.cat((wq, wk, wv), dim=1)  # [d, 3d]: one product for q|k|v
    _gemm(x, wqkv, _vector("bqkv", bqkv, 3 * d), qkv, _EPI_BIAS, ln=ln)
    att = torch.empty_like(x)
    elem = qkv.element_size()
    _common.launch("mirror_vit_attn", qkv.data_ptr(), qkv.data_ptr() + d * elem,
                   qkv.data_ptr() + 2 * d * elem, att.data_ptr(), b, n, heads, dh, 3 * d, d, 1,
                   dh ** -0.5)
    out = torch.empty_like(x)
    _gemm(att, wo, _vector("bo", bo, d), out, _EPI_BIAS_RESIDUAL, resid=x)
    _common.count_launch(KERNEL_ATTN_BLOCK)
    return out


def mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, eps: float = 1e-12):
    """x + fc2(gelu(fc1(layernorm(x)))), exact-erf GELU in fp32. x [b, n, d];
    w1 [d, m]; w2 [m, d]."""
    args = (x, ln_s, ln_b, w1, b1, w2, b2)
    if not _common.on_cuda(*args):
        return mlp_block_ref(*args, eps)
    _refuse_grad("mlp_block", *args)
    b, n, d = x.shape
    m = w1.shape[-1]
    _check_width("feature dim", d)
    _check_width("MLP width", m)
    _common.check_kernel_input("x", x, (b, n, d))
    _common.check_kernel_input("w1", w1, (d, m))
    _common.check_kernel_input("w2", w2, (m, d))
    ln = (*_ln_stats(x, eps), _vector("ln_s", ln_s, d), _vector("ln_b", ln_b, d))
    h = torch.empty(b, n, m, dtype=x.dtype, device=x.device)
    _gemm(x, w1, _vector("b1", b1, m), h, _EPI_BIAS_GELU, ln=ln)
    out = torch.empty_like(x)
    _gemm(h, w2, _vector("b2", b2, d), out, _EPI_BIAS_RESIDUAL, resid=x)
    _common.count_launch(KERNEL_MLP_BLOCK)
    return out
