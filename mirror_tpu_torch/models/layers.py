"""Shared transformer building blocks.

Counterpart of ``mirror_tpu/models/layers.py``. Every module takes a compute
``dtype`` (bf16 on the card) while its parameters stay fp32, as the JAX
modules do: inputs and weights are cast to the compute dtype at the same
points, and LayerNorm and softmax statistics are taken in fp32. Attribute
names give the original reference's ``state_dict`` keys (timm's ``Mlp``,
``Attention``, ``Block`` and ``LayerScale``).

Modules are built without drawing weights; ``registry.init_weights`` draws
them from a generator, following each ``Dense``'s ``init`` scheme and the
initialisers below. Dropout and DropPath draw their masks from the
``torch.Generator`` that :func:`set_generator` hands them (the JAX
package's ``dropout`` rng stream), so a seed fixes a training run.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cdt(dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype or torch.float32


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator,
                  a: float = -2.0, b: float = 2.0) -> torch.Tensor:
    """timm's ``trunc_normal_(std=...)``: N(0, std^2) cut at the ABSOLUTE
    bounds a, b (at std 0.02 the default +-2 is +-100 sigma, in effect
    untruncated). Draws on the CPU, redraws what falls outside."""
    x = torch.empty(t.shape).normal_(0.0, std, generator=generator)
    out = (x < a) | (x > b)
    while out.any():
        x[out] = torch.empty(int(out.sum())).normal_(0.0, std, generator=generator)
        out = (x < a) | (x > b)
    return t.copy_(x)


@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """U(+-sqrt(6 / (fan_in + fan_out))) of a [out, in] Linear weight."""
    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    return w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=generator))


@torch.no_grad()
def orthogonal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torch's orthogonal init of a 2-d weight: the Q of a QR of a normal
    draw, sign-fixed by diag(R); rows or columns orthonormal, whichever are
    fewer (for the [P, D] prototypes, W^T W = I_D)."""
    rows, cols = w.shape
    a = torch.empty(rows, cols).normal_(0.0, 1.0, generator=generator)
    if rows < cols:
        a = a.t()
    q, r = torch.linalg.qr(a)
    q = q * torch.diagonal(r).sign()
    return w.copy_(q.t() if rows < cols else q)


class Dense(nn.Linear):
    """nn.Linear that computes in ``dtype``: input, weight and bias are cast
    to it (flax ``nn.Dense(dtype=...)`` with fp32 params). ``init`` names
    how ``registry.init_weights`` draws it: "torch" (U(+-1/sqrt(fan_in))
    weight and bias), "xavier" (xavier-uniform weight, zero bias) or
    "orthogonal"; ``init_scale`` then scales the weight (the reference's
    1/sqrt(2 * layer_id) rescale of retention blocks)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, init: str = "torch",
                 init_scale: float = 1.0):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype
        self.init = init
        self.init_scale = init_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = _cdt(self.dtype)
        bias = self.bias.to(cdt) if self.bias is not None else None
        return F.linear(x.to(cdt), self.weight.to(cdt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose statistics and affine run in fp32, output in
    ``dtype`` (flax ``nn.LayerNorm(dtype=..., param_dtype=float32)``)."""

    def __init__(self, dim: int, eps: float, dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(_cdt(self.dtype))


def l2_normalize(x: torch.Tensor, eps: Optional[float] = None) -> torch.Tensor:
    """F.normalize(p=2, dim=-1) semantics with the norm taken in fp32; eps
    1e-6 for fp16 inputs and 1e-12 otherwise (the reference's switch)."""
    if eps is None:
        eps = 1e-6 if x.dtype == torch.float16 else 1e-12
    norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return (x / norm.clamp_min(eps).to(x.dtype)).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout in training, the identity in eval. The mask is drawn
    from ``self.generator`` (None: torch's default generator) and applied as
    the JAX package does: where(keep, x / keep_prob, 0) in x's dtype."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.empty(x.shape, device=x.device).bernoulli_(keep_prob,
                                                                generator=self.generator)
        return torch.where(keep > 0, x / keep_prob, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth on a residual branch (timm DropPath): one keep draw
    per sample, from ``self.generator``; the identity in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        keep = torch.empty(shape, device=x.device).bernoulli_(keep_prob,
                                                              generator=self.generator)
        return torch.where(keep > 0, x / keep_prob, torch.zeros_like(x))


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every Dropout and DropPath of ``model``."""
    for mod in model.modules():
        if isinstance(mod, (Dropout, DropPath)):
            mod.generator = generator


class Mlp(nn.Module):
    """timm Mlp: fc1 -> exact-erf GELU -> drop -> [LayerNorm] -> fc2 -> drop.
    The RNA embedding passes ``use_norm`` (its mid LayerNorm)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 use_norm: bool = False, norm_eps: float = 1e-6, drop: float = 0.0,
                 fc2_init_scale: float = 1.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.drop1 = Dropout(drop)
        self.norm = (LayerNorm(hidden_features, norm_eps, dtype) if use_norm
                     else nn.Identity())
        self.fc2 = Dense(hidden_features, out_features, dtype=dtype,
                         init_scale=fc2_init_scale)
        self.drop2 = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(F.gelu(self.fc1(x), approximate="none"))
        return self.drop2(self.fc2(self.norm(x)))


class RnaAttention(nn.Module):
    """Self-attention over ONE vector with the reference's heads-as-sequence
    quirk: qkv reshapes to [B, heads, head_dim], the softmax runs over the
    heads axis, and the output merges as [B, head_dim, heads] before the
    flatten (mirror_tpu/models/layers.py:269-275)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_norm: bool = False, attn_drop: float = 0.0, proj_drop: float = 0.0,
                 norm_eps: float = 1e-6, proj_init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, dtype=dtype)
        self.q_norm = LayerNorm(head_dim, norm_eps, dtype) if qk_norm else nn.Identity()
        self.k_norm = LayerNorm(head_dim, norm_eps, dtype) if qk_norm else nn.Identity()
        self.attn_drop = Dropout(attn_drop)
        self.proj = Dense(dim, dim, dtype=dtype, init_scale=proj_init_scale)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d = x.shape
        qkv = self.qkv(x).reshape(b, 3, self.num_heads, d // self.num_heads)
        q, k, v = self.q_norm(qkv[:, 0]), self.k_norm(qkv[:, 1]), qkv[:, 2]
        attn = torch.einsum("bhd,bgd->bhg", q * self.scale, k)
        attn = torch.softmax(attn.float(), dim=-1).to(attn.dtype)
        out = torch.einsum("bhg,bgd->bhd", self.attn_drop(attn), v)
        out = out.transpose(1, 2).reshape(b, d)
        return self.proj_drop(self.proj(out))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class RnaBlock(nn.Module):
    """Pre-norm transformer block over the single RNA vector (timm Block).
    ``rescale_init`` scales the init of attn.proj and mlp.fc2 (1/sqrt(2 *
    layer_id) in the retention decoders)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_norm: bool = False, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, init_values: Optional[float] = None,
                 drop_path: float = 0.0, norm_eps: float = 1e-6, rescale_init: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, dtype)
        self.attn = RnaAttention(dim, num_heads, qkv_bias, qk_norm, attn_drop,
                                 proj_drop, norm_eps, rescale_init, dtype)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, norm_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=proj_drop,
                       fc2_init_scale=rescale_init, dtype=dtype)
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x))))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))
