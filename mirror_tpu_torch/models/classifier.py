"""MIRROR downstream classifier.

Counterpart of ``mirror_tpu/models/classifier.py::MIRRORClassifier``:
FeatureTransMIL (cls vector) + TransFormer (RNA vector), add or concat
fusion, a linear head. The RNA branch is optional at call time (WSI-only).

Training mode (fine-tuning and the linear probe): ``pinv_grad`` picks the
Nystrom pinv's backward ("exact", the JAX default, or "implicit"); the
dropout of the two TransLayers' attention output (``wsi_dropout``, fixed at
0.1 in the reference) and of the RNA encoder (``rna_proj_drop_rate``) draws
from the generator that ``models.layers.set_generator`` hands it.
"""

from typing import Optional

import torch
from torch import nn

from .layers import Dense
from .rna_transformer import TransFormer
from .transmil import FeatureTransMIL


class MIRRORClassifier(nn.Module):
    def __init__(self, wsi_embed_dim: int = 1024, rna_embed_dim: int = 10234,
                 embed_dim: int = 768, num_classes: int = 2, rna_encoder_depth: int = 2,
                 rna_gene_embed: str = "learn", rna_mlp_ratio: float = 2.572,
                 rna_pos_drop_rate: float = 0.0, rna_proj_drop_rate: float = 0.1,
                 rna_attn_drop_rate: float = 0.0, rna_drop_path_rate: float = 0.0,
                 rna_norm_eps: float = 1e-6, fusion: str = "concat",
                 pinv_grad: str = "exact", wsi_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, use_pallas: bool = True,
                 grad_checkpointing: bool = False):
        super().__init__()
        if fusion not in ("add", "concat"):
            raise ValueError(f"fusion must be add or concat, got {fusion!r}")
        self.fusion = fusion
        self.dtype = dtype
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
        head_in = embed_dim * 2 if fusion == "concat" else embed_dim
        self.head = Dense(head_in, num_classes, dtype=dtype)

    def forward(self, wsi_emb: torch.Tensor,
                rna_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head_from_wsi(self.wsi_encoder(wsi_emb), rna_emb)

    def head_from_wsi(self, wsi_emb: torch.Tensor,
                      rna_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Classify from a precomputed WSI cls embedding [B, embed_dim]."""
        if rna_emb is None and self.fusion == "concat":
            raise ValueError(
                "fusion='concat' requires an RNA input; use fusion='add' "
                "(or wsi_feature_only mode) for WSI-only classification"
            )
        if rna_emb is None:
            return self.head(wsi_emb)
        rna_emb = self.rna_encoder(rna_emb)
        if self.fusion == "add":
            return self.head(wsi_emb + rna_emb)
        return self.head(torch.cat([wsi_emb, rna_emb], dim=1))
