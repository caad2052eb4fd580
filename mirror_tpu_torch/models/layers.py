"""Shared transformer building blocks.

Counterpart of ``mirror_tpu/models/layers.py``. Every module takes a compute
``dtype`` (bf16 on the card) while its parameters stay fp32, as the JAX
modules do: inputs and weights are cast to the compute dtype at the same
points, and LayerNorm and softmax statistics are taken in fp32. Attribute
names give the original reference's ``state_dict`` keys (timm's ``Mlp``,
``Attention``, ``Block`` and ``LayerScale``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cdt(dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype or torch.float32


class Dense(nn.Linear):
    """nn.Linear that computes in ``dtype``: input, weight and bias are cast
    to it (flax ``nn.Dense(dtype=...)`` with fp32 params)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

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


class Mlp(nn.Module):
    """timm Mlp: fc1 -> exact-erf GELU -> drop -> [LayerNorm] -> fc2 -> drop.
    The RNA embedding passes ``use_norm`` (its mid LayerNorm)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 use_norm: bool = False, norm_eps: float = 1e-6, drop: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.drop1 = nn.Dropout(drop)
        self.norm = (LayerNorm(hidden_features, norm_eps, dtype) if use_norm
                     else nn.Identity())
        self.fc2 = Dense(hidden_features, out_features, dtype=dtype)
        self.drop2 = nn.Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(F.gelu(self.fc1(x), approximate="none"))
        return self.drop2(self.fc2(self.norm(x)))


class DropPath(nn.Module):
    """Stochastic depth on a residual branch: the identity in eval. Its
    training draws (from an explicit generator) come with the train step."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate > 0.0 and self.training:
            raise NotImplementedError("DropPath in training is not ported yet")
        return x


class RnaAttention(nn.Module):
    """Self-attention over ONE vector with the reference's heads-as-sequence
    quirk: qkv reshapes to [B, heads, head_dim], the softmax runs over the
    heads axis, and the output merges as [B, head_dim, heads] before the
    flatten (mirror_tpu/models/layers.py:269-275)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_norm: bool = False, attn_drop: float = 0.0, proj_drop: float = 0.0,
                 norm_eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, dtype=dtype)
        self.q_norm = LayerNorm(head_dim, norm_eps, dtype) if qk_norm else nn.Identity()
        self.k_norm = LayerNorm(head_dim, norm_eps, dtype) if qk_norm else nn.Identity()
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)

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
    """Pre-norm transformer block over the single RNA vector (timm Block)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_norm: bool = False, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, init_values: Optional[float] = None,
                 drop_path: float = 0.0, norm_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, dtype)
        self.attn = RnaAttention(dim, num_heads, qkv_bias, qk_norm, attn_drop,
                                 proj_drop, norm_eps, dtype)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, norm_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=proj_drop, dtype=dtype)
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x))))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))
