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

:func:`contrastive_info_nce` is the CLIP step's in-batch loss over the
rank's own negatives (``--contrastive-negatives local``: the JAX package's
``local_info_nce``, each rank's loss, which DDP averages) or the global
batch's (``global``: the embeddings all-gathered in rank order); with one
process the two are ``info_nce`` over the batch.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.layers import l2_normalize
from ..parallel import distributed


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


def contrastive_info_nce(query: torch.Tensor, positive_key: torch.Tensor,
                         temperature: float = 0.1, negatives: str = "local",
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-batch ``info_nce`` over the rank's rows (``local``) or, with
    ``global``, over every rank's rows gathered in rank order (the gather's
    backward sums the ranks' gradients, so DDP's average is the global
    loss's gradient)."""
    if negatives == "global":
        query = distributed.gather_rows(query)
        positive_key = distributed.gather_rows(positive_key)
        if valid is not None:
            valid = distributed.gather_rows(valid)
    return info_nce(query, positive_key, temperature=temperature, valid=valid)


def reduce_info_nce(loss: torch.Tensor, n_valid, negatives: str = "local") -> torch.Tensor:
    """The global value of :func:`contrastive_info_nce` from each rank's
    (detached; ``n_valid`` the rank's valid rows, a number or a tensor):
    the mean over the ranks that hold a valid row (the JAX
    ``local_info_nce``'s psum pair), or the global loss as it is."""
    loss = loss.detach()
    if not distributed.multi() or negatives == "global":
        return loss
    has = (torch.as_tensor(n_valid, device=loss.device).float().reshape(()) > 0).float()
    sums = distributed.all_reduce(torch.stack([loss.float() * has, has]))
    return sums[0] / sums[1].clamp_min(1.0)
