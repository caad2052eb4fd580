"""InfoNCE contrastive loss.

Counterpart of ``mirror_tpu/losses/info_nce.py`` (the reference's
losses/info_nce.py), with its three negative modes:

- ``negative_keys=None``: in-batch negatives (the positives on the
  diagonal), optionally ``symmetric``;
- ``unpaired``: negatives [M, D] shared by every query;
- ``paired``: negatives [N, M, D], one set per query.

Every vector is L2-normalised with the norm taken in fp32
(``models.layers.l2_normalize``, eps 1e-12); the similarity products run in
the inputs' dtype and the logits are cast to fp32 after them, as the
reference's ``F.cross_entropy`` promotes its half logits under autocast.

``local_info_nce`` of the JAX package (each data shard's own in-batch loss,
averaged over the shards) is the DDP semantics of several processes; in the
port's one process it is this ``info_nce`` over the whole batch.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.layers import l2_normalize


def _xent(logits: torch.Tensor, labels: torch.Tensor, reduction: str,
          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``valid`` ([B] 0/1) takes padded columns out of the softmax's
    normaliser (-1e9) and padded rows out of the reduction."""
    if valid is not None:
        valid = valid.to(logits.dtype)
        logits = logits + torch.where(valid[None, :] > 0, 0.0, -1e9)
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    if valid is not None:
        nll = nll * valid
        if reduction == "mean":
            return nll.sum() / valid.sum().clamp_min(1.0)
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def info_nce(query: torch.Tensor, positive_key: torch.Tensor,
             negative_keys: Optional[torch.Tensor] = None, temperature: float = 0.1,
             reduction: str = "mean", negative_mode: str = "unpaired",
             symmetric: bool = False, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    if valid is not None and negative_keys is not None:
        raise ValueError("valid mask is only supported with in-batch negatives")
    if query.ndim != 2 or positive_key.ndim != 2:
        raise ValueError("<query>/<positive_key> must have 2 dimensions.")
    if negative_keys is not None:
        if negative_mode == "unpaired" and negative_keys.ndim != 2:
            raise ValueError("unpaired negative_keys must be 2-D")
        if negative_mode == "paired" and negative_keys.ndim != 3:
            raise ValueError("paired negative_keys must be 3-D")

    query = l2_normalize(query, eps=1e-12)
    positive_key = l2_normalize(positive_key, eps=1e-12)
    if negative_keys is not None:
        negative_keys = l2_normalize(negative_keys, eps=1e-12)
        positive_logit = (query * positive_key).sum(dim=1, keepdim=True)
        if negative_mode == "unpaired":
            negative_logits = query @ negative_keys.t()
        else:
            negative_logits = torch.einsum("nd,nmd->nm", query, negative_keys)
        logits = torch.cat([positive_logit, negative_logits], dim=1).float()
        labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
        return _xent(logits / temperature, labels, reduction)

    logits = (query @ positive_key.t()).float()
    labels = torch.arange(logits.shape[0], device=logits.device)
    if symmetric:
        logits2 = (positive_key @ query.t()).float()
        return (0.5 * _xent(logits / temperature, labels, reduction, valid)
                + 0.5 * _xent(logits2 / temperature, labels, reduction, valid))
    return _xent(logits / temperature, labels, reduction, valid)
