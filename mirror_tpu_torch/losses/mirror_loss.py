"""MIRROR pretraining losses.

Counterpart of ``mirror_tpu/losses/mirror_loss.py`` (the reference's
losses/mirror_loss.py):

- ``clip_loss``: symmetric cross-entropy over ``logit_scale * W R^T`` in
  both directions with arange labels. The negatives are the batch's own:
  the port trains in one process, where the JAX package's local negatives
  (each device's CE over its own shard, the reference's DDP semantics) and
  its global negatives are the same thing.
- ``mirror_loss``: total = w_a align + w_wr wsi_ret + w_rr rna_ret +
  w_s style + w_c cluster, returned as the 6-tuple (total, align, wsi_ret,
  rna_ret, style, cluster).
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F


def clip_loss(wsi_features: torch.Tensor, rna_features: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric CLIP contrastive loss over the batch's own negatives.

    The similarity product runs in the features' dtype (the reference's
    autocast matmul) and is scaled and softmaxed in fp32, as the JAX
    package's type promotion of an fp32 scale does."""
    sim = torch.matmul(wsi_features, rna_features.t()).float()
    logits = logit_scale.float() * sim
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2.0


class MirrorLossWeights(NamedTuple):
    """Loss-term weights; defaults are the reference class's. The shipped
    config uses (0.5, 0.15, 0.15, 0.1, 0.1)."""

    alignment: float = 0.5
    wsi_retention: float = 0.1
    rna_retention: float = 0.1
    style: float = 0.1
    cluster: float = 0.2


def mirror_loss(wsi_alignment_emb, wsi_retention_emb, wsi_retention_target, wsi_mask,
                wsi_score, wsi_mu, wsi_logstd, rna_alignment_emb, rna_retention_emb,
                rna_retention_target, rna_mask, rna_score, rna_mu, rna_logstd,
                logit_scale, weights: MirrorLossWeights = MirrorLossWeights()):
    """Five-term MIRROR loss on the model's 15 outputs; returns (total,
    alignment, wsi_retention, rna_retention, style, cluster).

    Every term but the contrastive one is taken in fp32 (mirror_loss.py:
    176-192 of the JAX package: a bf16 log-softmax over 3000 prototypes or
    bf16 retention sums would drift ~1e-3 from the reference each step).
    The RNA retention term is the elementwise squared error times the mask
    over the mask's sum, with NO feature mean: the reference's quirk
    (mirror_loss.py:207-211), kept on purpose. An all-zero mask gives NaN,
    as in the reference."""
    alignment = clip_loss(wsi_alignment_emb, rna_alignment_emb, logit_scale)
    f32 = [t.float() for t in (wsi_retention_emb, wsi_retention_target, wsi_mask,
                               rna_retention_emb, rna_retention_target, rna_mask,
                               wsi_mu, wsi_logstd, rna_mu, rna_logstd, wsi_score, rna_score)]
    (w_ret, w_tgt, w_mask, r_ret, r_tgt, r_mask, w_mu, w_logstd, r_mu, r_logstd,
     w_score, r_score) = f32
    n = float(wsi_alignment_emb.shape[0])

    wsi_retention = (((w_ret - w_tgt) ** 2).mean(-1) * w_mask).sum() / w_mask.sum()
    rna_retention = (((r_ret - r_tgt) ** 2) * r_mask).sum() / r_mask.sum()

    wsi_kl = (torch.exp(w_logstd) + w_mu ** 2 - 1.0 - w_logstd).sum(1)
    rna_kl = (torch.exp(r_logstd) + r_mu ** 2 - 1.0 - r_logstd).sum(1)
    style = 0.5 * (wsi_kl.sum() + rna_kl.sum()) / n

    w_logp = F.log_softmax(w_score, dim=-1)
    r_logp = F.log_softmax(r_score, dim=-1)
    kl_a = (torch.exp(r_logp) * (r_logp - w_logp)).sum(-1)
    kl_b = (torch.exp(w_logp) * (w_logp - r_logp)).sum(-1)
    cluster = 0.5 * (kl_a.sum() + kl_b.sum()) / n

    total = (weights.alignment * alignment + weights.wsi_retention * wsi_retention
             + weights.rna_retention * rna_retention + weights.style * style
             + weights.cluster * cluster)
    return total, alignment, wsi_retention, rna_retention, style, cluster
