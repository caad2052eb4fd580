"""RNA (transcriptomics) transformer.

Counterpart of ``mirror_tpu/models/rna_transformer.py::TransFormer``: an MLP
embedding (in -> 2E -> E with a mid LayerNorm), an additive learned gene
embedding, ``depth`` pre-norm blocks over the single vector, a final norm.
(``TransFormerHybrid`` comes with the train step.)
"""

from typing import Optional

import torch
from torch import nn

from .layers import LayerNorm, Mlp, RnaBlock


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
        self.pos_drop = nn.Dropout(pos_drop_rate)
        self.norm_pre = LayerNorm(embed_dim, norm_eps, dtype) if pre_norm else nn.Identity()
        # stochastic depth rates: linspace(0, drop_path_rate, depth)
        dpr = [drop_path_rate * i / (depth - 1) if depth > 1 else 0.0 for i in range(depth)]
        self.blocks = nn.ModuleList(
            RnaBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, qk_norm,
                     proj_drop_rate, attn_drop_rate, init_values, dpr[i], norm_eps, dtype)
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
