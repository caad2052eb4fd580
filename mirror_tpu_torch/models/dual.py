"""The CLIP baseline's dual encoder.

Counterpart of ``mirror_tpu/models/dual.py::MIRRORDual``, the model of
``train_pretrain``: the FeatureTransMIL cls vector and the TransFormer RNA
vector, each through a linear projection to ``projection_dim`` (default
``embed_dim``); ``forward(wsi, rna) -> (wsi_emb, rna_emb)``, which
``losses.info_nce`` normalises. The state-dict keys (``wsi_encoder.*``,
``rna_encoder.*``, ``wsi_projection.*``, ``rna_projection.*``) are the ones
``convert.state_dict_from_jax`` gives the flax params.

The WSI trunk runs the Nystrom attention and PPEG kernels on the card, as in
the classifier; ``wsi_dropout`` is its TransLayers' attention-output dropout
(0.1 in the reference), ``rna_proj_drop_rate`` the RNA encoder's.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Dense
from .rna_transformer import TransFormer
from .transmil import FeatureTransMIL


class MIRRORDual(nn.Module):
    def __init__(self, wsi_embed_dim: int = 768, rna_embed_dim: int = 10234,
                 embed_dim: int = 768, projection_dim: Optional[int] = None,
                 rna_encoder_depth: int = 2, rna_gene_embed: str = "learn",
                 rna_mlp_ratio: float = 2.572, rna_pos_drop_rate: float = 0.0,
                 rna_proj_drop_rate: float = 0.1, rna_attn_drop_rate: float = 0.0,
                 rna_drop_path_rate: float = 0.0, rna_norm_eps: float = 1e-6,
                 pinv_grad: str = "exact", wsi_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, use_pallas: bool = True,
                 grad_checkpointing: bool = False):
        super().__init__()
        proj_dim = projection_dim or embed_dim
        self.wsi_embed_dim = wsi_embed_dim
        self.wsi_encoder = FeatureTransMIL(wsi_embed_dim, embed_dim, dtype,
                                           dropout=wsi_dropout, pinv_grad=pinv_grad,
                                           use_pallas=use_pallas,
                                           grad_checkpointing=grad_checkpointing)
        self.rna_encoder = TransFormer(
            input_dim=rna_embed_dim, embed_dim=embed_dim, depth=rna_encoder_depth,
            gene_embed=rna_gene_embed, mlp_ratio=rna_mlp_ratio,
            pos_drop_rate=rna_pos_drop_rate, proj_drop_rate=rna_proj_drop_rate,
            attn_drop_rate=rna_attn_drop_rate, drop_path_rate=rna_drop_path_rate,
            norm_eps=rna_norm_eps, dtype=dtype,
        )
        self.wsi_projection = Dense(embed_dim, proj_dim, dtype=dtype)
        self.rna_projection = Dense(embed_dim, proj_dim, dtype=dtype)

    def forward(self, wsi_emb: torch.Tensor,
                rna_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        wsi = self.wsi_projection(self.wsi_encoder(wsi_emb))
        rna = self.rna_projection(self.rna_encoder(rna_emb))
        return wsi, rna
