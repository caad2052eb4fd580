"""MIRROR pretraining losses.

Counterpart of ``mirror_tpu/losses/mirror_loss.py`` (the reference's
losses/mirror_loss.py):

- ``clip_loss``: symmetric cross-entropy over ``logit_scale * W R^T`` in
  both directions with arange labels, over the rows ``valid`` keeps (the
  padded rows out of the mean and out of the negatives). Its negatives are
  the rank's own rows (``--contrastive-negatives local``, the default: the
  JAX package's ``local_clip_loss``, the reference's DDP semantics), or
  with ``gather`` the global batch's (``global``: the embeddings all-gathered
  in rank order, the gather's backward summing the ranks' gradients). With
  one process the two are the same thing.
- ``mirror_loss``: total = w_a align + w_wr wsi_ret + w_rr rna_ret +
  w_s style + w_c cluster, returned as the 6-tuple (total, align, wsi_ret,
  rna_ret, style, cluster), each over the rank's rows;
  :func:`reduce_over_ranks` makes the global values of them.
"""

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel import distributed
from .info_nce import _xent


def clip_loss(wsi_features: torch.Tensor, rna_features: torch.Tensor,
              logit_scale: torch.Tensor, gather: bool = False,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric CLIP contrastive loss over the rank's negatives, or with
    ``gather`` over the global batch's (the same thing with one process).

    The similarity product runs in the features' dtype (the reference's
    autocast matmul) and is scaled and softmaxed in fp32, as the JAX
    package's type promotion of an fp32 scale does."""
    if gather:
        wsi_features = distributed.gather_rows(wsi_features)
        rna_features = distributed.gather_rows(rna_features)
        if valid is not None:
            valid = distributed.gather_rows(valid)
    sim = torch.matmul(wsi_features, rna_features.t()).float()
    logits = logit_scale.float() * sim
    labels = torch.arange(logits.shape[0], device=logits.device)
    if valid is not None:  # the padded rows out of the mean and of the negatives
        return (_xent(logits, labels, "mean", valid)
                + _xent(logits.t(), labels, "mean", valid)) / 2.0
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
                logit_scale, weights: MirrorLossWeights = MirrorLossWeights(),
                negatives: str = "local", valid: Optional[torch.Tensor] = None):
    """Five-term MIRROR loss on the model's 15 outputs; returns (total,
    alignment, wsi_retention, rna_retention, style, cluster).

    Every term but the contrastive one is taken in fp32 (mirror_loss.py:
    176-192 of the JAX package: a bf16 log-softmax over 3000 prototypes or
    bf16 retention sums would drift ~1e-3 from the reference each step).
    The RNA retention term is the elementwise squared error times the mask
    over the mask's sum, with NO feature mean: the reference's quirk
    (mirror_loss.py:207-211), kept on purpose. An all-zero mask gives NaN,
    as in the reference. ``negatives`` is :func:`clip_loss`'s (``global``
    gathers); ``valid`` ([B] 0/1) takes padded rows out of every term, as
    the JAX ``mirror_loss`` does for padded eval batches."""
    alignment = clip_loss(wsi_alignment_emb, rna_alignment_emb, logit_scale,
                          gather=negatives == "global", valid=valid)
    f32 = [t.float() for t in (wsi_retention_emb, wsi_retention_target, wsi_mask,
                               rna_retention_emb, rna_retention_target, rna_mask,
                               wsi_mu, wsi_logstd, rna_mu, rna_logstd, wsi_score, rna_score)]
    (w_ret, w_tgt, w_mask, r_ret, r_tgt, r_mask, w_mu, w_logstd, r_mu, r_logstd,
     w_score, r_score) = f32
    if valid is None:
        n = float(wsi_alignment_emb.shape[0])
        wsi_retention = (((w_ret - w_tgt) ** 2).mean(-1) * w_mask).sum() / w_mask.sum()
        rna_retention = (((r_ret - r_tgt) ** 2) * r_mask).sum() / r_mask.sum()
    else:
        row_w = valid.float()
        n = row_w.sum().clamp_min(1.0)
        w_mask, r_mask = w_mask * row_w[:, None], r_mask * row_w[:, None]
        wsi_retention = (((w_ret - w_tgt) ** 2).mean(-1) * w_mask).sum() / \
            w_mask.sum().clamp_min(1.0)
        rna_retention = (((r_ret - r_tgt) ** 2) * r_mask).sum() / r_mask.sum().clamp_min(1.0)

    wsi_kl = (torch.exp(w_logstd) + w_mu ** 2 - 1.0 - w_logstd).sum(1)
    rna_kl = (torch.exp(r_logstd) + r_mu ** 2 - 1.0 - r_logstd).sum(1)

    w_logp = F.log_softmax(w_score, dim=-1)
    r_logp = F.log_softmax(r_score, dim=-1)
    kl_a = (torch.exp(r_logp) * (r_logp - w_logp)).sum(-1)
    kl_b = (torch.exp(w_logp) * (w_logp - r_logp)).sum(-1)
    if valid is not None:
        wsi_kl, rna_kl, kl_a, kl_b = (t * row_w for t in (wsi_kl, rna_kl, kl_a, kl_b))
    style = 0.5 * (wsi_kl.sum() + rna_kl.sum()) / n
    cluster = 0.5 * (kl_a.sum() + kl_b.sum()) / n

    total = (weights.alignment * alignment + weights.wsi_retention * wsi_retention
             + weights.rna_retention * rna_retention + weights.style * style
             + weights.cluster * cluster)
    return total, alignment, wsi_retention, rna_retention, style, cluster


def reduce_over_ranks(losses: Sequence[torch.Tensor], weights: MirrorLossWeights,
                      n_valid, negatives: str = "local") -> tuple:
    """The global values of :func:`mirror_loss`'s six terms from each rank's
    own (detached; the terms themselves with one process): the per-row
    terms as the mean of the ranks' values weighted by their valid rows
    (both retention masks keep a fixed count per row, so this is the
    global masked mean); the local-negatives alignment as the mean over the
    ranks that hold a valid row (the JAX ``local_clip_loss``'s psum pair);
    the global-negatives alignment as it is, every rank's being the global
    one. The total is their weighted sum. One all-reduce. ``n_valid`` is
    the rank's count of valid rows (a number or a tensor)."""
    if not distributed.multi():
        return tuple(t.detach() for t in losses)
    n = torch.as_tensor(n_valid, dtype=torch.float32, device=losses[0].device).reshape(())
    has = (n > 0).float()
    align_w = torch.ones_like(has) if negatives == "global" else has
    parts = [losses[1].detach().float() * align_w, align_w]
    parts += [t.detach().float() * n for t in losses[2:]] + [n]
    sums = distributed.all_reduce(torch.stack(parts))
    align = sums[0] / sums[1].clamp_min(1.0)
    rest = [s / sums[-1].clamp_min(1.0) for s in sums[2:-1]]
    wsi_retention, rna_retention, style, cluster = rest
    total = (weights.alignment * align + weights.wsi_retention * wsi_retention
             + weights.rna_retention * rna_retention + weights.style * style
             + weights.cluster * cluster)
    return total, align, wsi_retention, rna_retention, style, cluster
