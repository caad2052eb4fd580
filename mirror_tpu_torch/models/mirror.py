"""MIRROR pretraining model.

Counterpart of ``mirror_tpu/models/mirror.py``: the dual hybrid encoders,
the learnable logit scale, and the style-clustering VAE (shared MLP ->
mu / logstd -> reparameterised latent -> decoder -> prototype scores) with
orthogonally initialised prototypes.

What the JAX package draws from its ``masking`` and ``style`` rng streams
comes here from one ``torch.Generator`` on the model's device, in a fixed
order (WSI mask noise, RNA mask noise, WSI eps, RNA eps), or is injected
through ``noise``: a dict with any of ``wsi_noise`` [B, n], ``rna_noise``
[B, E], ``wsi_eps`` and ``rna_eps`` [B, latent]. The per-step prototype
renorm and the logit-scale clamp belong to the train step
(``train/steps.py``), as in the JAX package.
"""

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from .layers import Dense, Mlp
from .rna_transformer import TransFormerHybrid
from .transmil import FeatureTransMILHybrid


class MirrorOutput(NamedTuple):
    """The reference 15-tuple, in order."""

    wsi_alignment_emb: torch.Tensor
    wsi_retention_emb: torch.Tensor
    wsi_retention_target: torch.Tensor
    wsi_mask: torch.Tensor
    wsi_score: torch.Tensor
    wsi_mu: torch.Tensor
    wsi_logstd: torch.Tensor
    rna_alignment_emb: torch.Tensor
    rna_retention_emb: torch.Tensor
    rna_retention_target: torch.Tensor
    rna_mask: torch.Tensor
    rna_score: torch.Tensor
    rna_mu: torch.Tensor
    rna_logstd: torch.Tensor
    logit_scale: torch.Tensor


class MIRROR(nn.Module):
    """``wsi_dropout`` is the WSI Nystrom attentions' output dropout, fixed
    at 0.1 in the reference; a test sets it to 0 to compare trajectories."""

    def __init__(self, wsi_embed_dim: int = 768, rna_embed_dim: int = 10234,
                 embed_dim: int = 768, wsi_num_tokens: int = 2048,
                 wsi_retention_decoder_depth: int = 1, rna_encoder_depth: int = 2,
                 rna_gene_embed: str = "learn", rna_mlp_ratio: float = 2.572,
                 rna_pos_drop_rate: float = 0.0, rna_proj_drop_rate: float = 0.1,
                 rna_attn_drop_rate: float = 0.0, rna_drop_path_rate: float = 0.0,
                 rna_norm_eps: float = 1e-6, rna_retention_decoder_depth: int = 1,
                 init_logit_scale: float = math.log(1 / 0.07),
                 style_mlp_hidden_dim: int = 512, style_mlp_out_dim: int = 256,
                 style_latent_dim: int = 128, num_prototypes: int = 3000,
                 pinv_grad: str = "implicit", wsi_dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.wsi_embed_dim = wsi_embed_dim
        self.init_logit_scale = init_logit_scale
        self.dtype = dtype
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.wsi_encoder = FeatureTransMILHybrid(
            wsi_embed_dim, embed_dim, wsi_num_tokens, wsi_retention_decoder_depth, dtype,
            dropout=wsi_dropout, pinv_grad=pinv_grad,
        )
        self.rna_encoder = TransFormerHybrid(
            rna_embed_dim, embed_dim, retention_decoder_depth=rna_retention_decoder_depth,
            depth=rna_encoder_depth, gene_embed=rna_gene_embed, mlp_ratio=rna_mlp_ratio,
            pos_drop_rate=rna_pos_drop_rate, proj_drop_rate=rna_proj_drop_rate,
            attn_drop_rate=rna_attn_drop_rate, drop_path_rate=rna_drop_path_rate,
            norm_eps=rna_norm_eps, dtype=dtype,
        )
        self.style_encoder_mlp = Mlp(embed_dim, style_mlp_hidden_dim, style_mlp_out_dim,
                                     dtype=dtype)
        self.style_mu = Dense(style_mlp_out_dim, style_latent_dim, dtype=dtype)
        self.style_logstd = Dense(style_mlp_out_dim, style_latent_dim, dtype=dtype)
        self.style_decoder = Dense(style_latent_dim, embed_dim, dtype=dtype)
        # Linear(embed_dim -> P, bias=False): the torch weight is [P, D]
        self.prototypes = Dense(embed_dim, num_prototypes, bias=False, dtype=dtype,
                                init="orthogonal")

    def _style(self, emb: torch.Tensor, eps: torch.Tensor):
        emb = self.style_encoder_mlp(emb)
        mu, logstd = self.style_mu(emb), self.style_logstd(emb)
        z = mu + torch.exp(0.5 * logstd) * eps.to(mu.dtype)
        return self.prototypes(self.style_decoder(z)), mu, logstd

    def forward(self, wsi_emb: torch.Tensor, rna_emb: torch.Tensor,
                wsi_mask_ratio: float = 0.75, rna_mask_ratio: float = 0.75,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> MirrorOutput:
        noise = dict(noise or {})
        dev = wsi_emb.device
        b = wsi_emb.shape[0]
        for key, shape in (("wsi_noise", (b, wsi_emb.shape[1])),
                           ("rna_noise", (b, self.rna_encoder.retention_gene_embed.shape[1]))):
            if key not in noise:
                noise[key] = torch.rand(shape, generator=generator, device=dev)

        h = self.wsi_encoder.forward_encoder(wsi_emb)
        wsi_alignment_emb = self.wsi_encoder.forward_alignment_head(h)
        wsi_retention_emb, wsi_mask = self.wsi_encoder.forward_retention_head(
            h, wsi_mask_ratio, noise=noise["wsi_noise"])

        x = self.rna_encoder(rna_emb)
        rna_alignment_emb = self.rna_encoder.forward_alignment_head(x)
        rna_retention_emb, rna_mask = self.rna_encoder.forward_retention_head(
            x, rna_mask_ratio, noise=noise["rna_noise"])

        latent = self.style_mu.out_features
        for key in ("wsi_eps", "rna_eps"):
            if key not in noise:
                noise[key] = torch.randn((b, latent), generator=generator, device=dev)
        wsi_score, wsi_mu, wsi_logstd = self._style(h[:, 0], noise["wsi_eps"])
        rna_score, rna_mu, rna_logstd = self._style(x, noise["rna_eps"])

        return MirrorOutput(
            wsi_alignment_emb, wsi_retention_emb, h[:, 1:], wsi_mask, wsi_score, wsi_mu,
            wsi_logstd, rna_alignment_emb, rna_retention_emb, x, rna_mask, rna_score,
            rna_mu, rna_logstd, torch.exp(self.logit_scale),
        )
