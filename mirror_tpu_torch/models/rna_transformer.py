"""RNA (transcriptomics) transformer.

Counterpart of ``mirror_tpu/models/rna_transformer.py``: ``TransFormer``
(an MLP embedding, in -> 2E -> E with a mid LayerNorm, an additive learned
gene embedding, ``depth`` pre-norm blocks over the single vector, a final
norm), ``random_scalar_masking`` and the pretraining ``TransFormerHybrid``.
"""

import math
from typing import Optional

import torch
from torch import nn

from .layers import Dense, Dropout, LayerNorm, Mlp, RnaBlock, l2_normalize
from .transmil import random_token_masking


class TransFormer(nn.Module):
    def __init__(self, input_dim: int = 10234, embed_dim: int = 768, depth: int = 2,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_norm: bool = False, init_values: Optional[float] = None,
                 gene_embed: str = "learn", pre_norm: bool = False,
                 final_norm: bool = True, embed_drop_rate: float = 0.0,
                 pos_drop_rate: float = 0.0, proj_drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 norm_eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = Mlp(input_dim, embed_dim * 2, embed_dim, use_norm=True,
                             norm_eps=norm_eps, drop=embed_drop_rate, dtype=dtype)
        if gene_embed in ("", "none"):
            self.register_parameter("gene_embed", None)
        else:
            self.gene_embed = nn.Parameter(torch.empty(1, embed_dim))
        self.pos_drop = Dropout(pos_drop_rate)
        self.norm_pre = LayerNorm(embed_dim, norm_eps, dtype) if pre_norm else nn.Identity()
        # stochastic depth rates: linspace(0, drop_path_rate, depth)
        dpr = [drop_path_rate * i / (depth - 1) if depth > 1 else 0.0 for i in range(depth)]
        self.blocks = nn.ModuleList(
            RnaBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_norm,
                     proj_drop_rate, attn_drop_rate, init_values, dpr[i], norm_eps,
                     dtype=dtype)
            for i in range(depth)
        )
        self.norm = LayerNorm(embed_dim, norm_eps, dtype) if final_norm else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.embedding(x.to(self.dtype or torch.float32))
        if self.gene_embed is not None:
            x = self.pos_drop(x + self.gene_embed.to(x.dtype))
        x = self.norm_pre(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


# scalar-level MAE masking over the embedding features (the reference's
# random_masking of the RNA branch) is the WSI token mask's algorithm
random_scalar_masking = random_token_masking


class TransFormerHybrid(TransFormer):
    """Pretraining RNA encoder (TransFormerHybrid of the JAX package,
    rna_transformer.py:123-216): an alignment head on the L2-normed
    encoding and a scalar-level masked retention decoder, whose blocks'
    attn.proj and mlp.fc2 inits are scaled by 1/sqrt(2 * layer_id)."""

    def __init__(self, input_dim: int = 10234, embed_dim: int = 768,
                 retention_decoder_depth: int = 1, **kwargs):
        super().__init__(input_dim, embed_dim, **kwargs)
        dtype = kwargs.get("dtype")
        norm_eps = kwargs.get("norm_eps", 1e-6)
        self.alignment_head = Dense(embed_dim, embed_dim, dtype=dtype)
        self.retention_embed = Dense(embed_dim, embed_dim, dtype=dtype)
        self.mask_token = nn.Parameter(torch.empty(1, 1))
        self.retention_gene_embed = nn.Parameter(torch.empty(1, embed_dim))
        self.retention_blocks = nn.ModuleList(
            RnaBlock(embed_dim, kwargs.get("num_heads", 12), kwargs.get("mlp_ratio", 4.0),
                     kwargs.get("qkv_bias", True), kwargs.get("qk_norm", False),
                     kwargs.get("proj_drop_rate", 0.0), kwargs.get("attn_drop_rate", 0.0),
                     kwargs.get("init_values"), 0.0, norm_eps,
                     rescale_init=1.0 / math.sqrt(2.0 * (i + 1)), dtype=dtype)
            for i in range(retention_decoder_depth)
        )
        self.retention_norm = LayerNorm(embed_dim, norm_eps, dtype)
        self.retention_head = Dense(embed_dim, embed_dim, dtype=dtype)

    def forward_alignment_head(self, x: torch.Tensor) -> torch.Tensor:
        return self.alignment_head(l2_normalize(x))

    def forward_retention_head(self, x: torch.Tensor, mask_ratio: float,
                               generator: Optional[torch.Generator] = None,
                               noise: Optional[torch.Tensor] = None):
        rx = self.retention_embed(x)
        mask = random_scalar_masking(rx.shape[0], rx.shape[1], mask_ratio, generator,
                                     noise, rx.device)
        rx = torch.where(mask > 0, self.mask_token[0, 0].to(rx.dtype), rx)
        rx = rx + self.retention_gene_embed.to(rx.dtype)
        for blk in self.retention_blocks:
            rx = blk(rx)
        return self.retention_head(self.retention_norm(rx)), mask
