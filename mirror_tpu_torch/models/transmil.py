"""TransMIL WSI encoder.

Counterpart of ``mirror_tpu/models/transmil.py``: ``merge_ppeg_pyramid``,
``PPEG``, ``TransLayer``, ``_square_pad_tokens``, ``FeatureTransMIL``,
``random_token_masking`` and the pretraining ``FeatureTransMILHybrid``.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ppeg import ppeg_fused
from .layers import Dense, LayerNorm, l2_normalize
from .nystrom import NystromAttention


def merge_ppeg_pyramid(k7, k5, k3, b7, b5, b3):
    """Merge the 7/5/3 SAME-centred depthwise pyramid into ONE 7x7 conv:
    k_eff = k7 + pad(k5) + pad(k3), b_eff = b7 + b5 + b3 (conv is linear in
    the kernel, and autograd splits the gradient back to the three).
    Kernels in the reference's [C, 1, k, k] layout."""
    k_eff = k7 + F.pad(k5, (1, 1, 1, 1)) + F.pad(k3, (2, 2, 2, 2))
    return k_eff, b7 + b5 + b3


class PPEG(nn.Module):
    """Pyramid position encoding: depthwise 7/5/3 convs over the token grid
    plus the identity; the cls token bypasses. The pyramid is merged into
    one 7x7 conv, which runs with the identity and bias as one pass
    (``ops.ppeg_fused``) on NHWC."""

    def __init__(self, dim: int = 512, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(dim, dim, 7, 1, 7 // 2, groups=dim)
        self.proj1 = nn.Conv2d(dim, dim, 5, 1, 5 // 2, groups=dim)
        self.proj2 = nn.Conv2d(dim, dim, 3, 1, 3 // 2, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        cls_token, feat = x[:, :1], x[:, 1:]
        cdt = self.dtype or torch.float32
        k_eff, b_eff = merge_ppeg_pyramid(
            self.proj.weight, self.proj1.weight, self.proj2.weight,
            self.proj.bias, self.proj1.bias, self.proj2.bias,
        )
        kern = k_eff[:, 0].permute(1, 2, 0).contiguous().to(cdt)  # [7, 7, C]
        img = feat.reshape(b, h, w, c).to(cdt).contiguous()  # NHWC
        out = ppeg_fused(img, kern, b_eff.to(cdt))
        return torch.cat([cls_token.to(out.dtype), out.reshape(b, h * w, c)], dim=1)


class TransLayer(nn.Module):
    """Pre-norm Nystrom attention residual block: dim_head = dim / 8, 8 heads,
    dim / 2 landmarks, 6 pinv iterations, residual conv, LayerNorm eps 1e-5.
    The reference fixes the attention's output dropout at 0.1; ``dropout``
    lets a test set it to 0."""

    def __init__(self, dim: int = 512, dtype: Optional[torch.dtype] = None,
                 xavier_init: bool = False, dropout: float = 0.1,
                 pinv_grad: str = "implicit"):
        super().__init__()
        self.norm = LayerNorm(dim, 1e-5, dtype)
        self.attn = NystromAttention(
            dim=dim, dim_head=dim // 8, heads=8, num_landmarks=dim // 2,
            pinv_iterations=6, residual=True, dropout=dropout, pinv_grad=pinv_grad,
            xavier_init=xavier_init, dtype=dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.attn(self.norm(x))


def _square_pad_tokens(h: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Wrap-pad [B, n, D] to the next square grid: the first tokens repeat."""
    n = h.shape[1]
    side = int(math.ceil(math.sqrt(n)))
    add_length = side * side - n
    if add_length > 0:
        h = torch.cat([h, h[:, :add_length, :]], dim=1)
    return h, side, add_length


class FeatureTransMIL(nn.Module):
    """TransMIL over precomputed patch features: Linear + ReLU, wrap-pad to a
    square grid, cls token, TransLayer -> PPEG -> TransLayer -> LayerNorm;
    ``forward`` returns the cls vector. ``xavier_init`` and
    ``cls_token_std`` select the init ``registry.init_weights`` draws."""

    def __init__(self, input_dim: int = 1024, embed_dim: int = 512,
                 dtype: Optional[torch.dtype] = None, xavier_init: bool = False,
                 cls_token_std: float = 1.0, dropout: float = 0.1,
                 pinv_grad: str = "implicit"):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.cls_token_std = cls_token_std
        init = "xavier" if xavier_init else "torch"
        self._fc1 = nn.Sequential(Dense(input_dim, embed_dim, dtype=dtype, init=init),
                                  nn.ReLU())
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.layer1 = TransLayer(embed_dim, dtype, xavier_init, dropout, pinv_grad)
        self.layer2 = TransLayer(embed_dim, dtype, xavier_init, dropout, pinv_grad)
        self.pos_layer = PPEG(embed_dim, dtype)
        self.norm = LayerNorm(embed_dim, 1e-5, dtype)

    def encode(self, h: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """[B, n, input_dim] -> ([B, 1 + side^2, embed_dim] normed, add_length)."""
        h = self._fc1(h.to(self.dtype or torch.float32))
        h, side, add_length = _square_pad_tokens(h)
        cls = self.cls_token.to(h.dtype).expand(h.shape[0], 1, self.embed_dim)
        h = torch.cat([cls, h], dim=1)
        h = self.layer1(h)
        h = self.pos_layer(h, side, side)
        h = self.layer2(h)
        return self.norm(h), add_length

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.encode(h)[0][:, 0]


def random_token_masking(batch: int, num_tokens: int, mask_ratio: float,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         device=None) -> torch.Tensor:
    """MAE-style random mask [B, N], 1 == masked: positions ranked by
    uniform noise through a double argsort, the first
    ``int(N * (1 - mask_ratio))`` ranks kept (transmil.py:241-258 of the JAX
    package). The noise comes from ``generator`` on ``device``, or is
    injected as ``noise`` [B, N]."""
    len_keep = int(num_tokens * (1 - mask_ratio))
    if noise is None:
        noise = torch.rand(batch, num_tokens, generator=generator, device=device)
    ranks = torch.argsort(torch.argsort(noise, dim=1), dim=1)
    return (ranks >= len_keep).float()


class FeatureTransMILHybrid(FeatureTransMIL):
    """Pretraining TransMIL: encoder + alignment head + masked-token retention
    decoder (FeatureTransMILHybrid of the JAX package, transmil.py:261-359).
    Reference init: xavier on every Linear with zero bias, cls token and
    mask token ~ N(0, 0.02), retention_gene_embed trunc_normal(0.02).

    The reference gathers the kept tokens, appends mask tokens and
    un-shuffles; that is ``where(mask, mask_token, x)`` with the rank mask,
    as the JAX package computes it."""

    def __init__(self, input_dim: int = 1024, embed_dim: int = 512, num_tokens: int = 2048,
                 retention_decoder_depth: int = 1, dtype: Optional[torch.dtype] = None,
                 xavier_init: bool = True, cls_token_std: float = 0.02,
                 dropout: float = 0.1, pinv_grad: str = "implicit"):
        super().__init__(input_dim, embed_dim, dtype, xavier_init, cls_token_std, dropout,
                         pinv_grad)
        init = "xavier" if xavier_init else "torch"
        self.alignment_head = Dense(embed_dim, embed_dim, dtype=dtype, init=init)
        self.retention_embed = Dense(embed_dim, embed_dim, dtype=dtype, init=init)
        self.mask_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.retention_gene_embed = nn.Parameter(torch.empty(1, num_tokens + 1, embed_dim))
        self.retention_blocks = nn.ModuleList(
            TransLayer(embed_dim, dtype, xavier_init, dropout, pinv_grad)
            for _ in range(retention_decoder_depth)
        )
        self.retention_norm = LayerNorm(embed_dim, 1e-5, dtype)
        self.retention_head = Dense(embed_dim, embed_dim, dtype=dtype, init=init)

    def forward_encoder(self, h: torch.Tensor) -> torch.Tensor:
        """The normed sequence trimmed back to [B, 1 + n, D]."""
        h, add_length = self.encode(h)
        if add_length > 0:
            h = h[:, : h.shape[1] - add_length]
        return h

    def forward_alignment_head(self, h: torch.Tensor) -> torch.Tensor:
        return self.alignment_head(l2_normalize(h)[:, 0])

    def forward_retention_head(self, h: torch.Tensor, mask_ratio: float,
                               generator: Optional[torch.Generator] = None,
                               noise: Optional[torch.Tensor] = None):
        rh = self.retention_embed(h)
        cls, tokens = rh[:, :1], rh[:, 1:]
        mask = random_token_masking(tokens.shape[0], tokens.shape[1], mask_ratio,
                                    generator, noise, tokens.device)
        tokens = torch.where(mask[..., None] > 0, self.mask_token.to(tokens.dtype), tokens)
        rh = torch.cat([cls, tokens], dim=1) + self.retention_gene_embed.to(tokens.dtype)
        for blk in self.retention_blocks:
            rh = blk(rh)
        rh = self.retention_head(self.retention_norm(rh))
        return rh[:, 1:], mask
