"""Discrete-time survival losses.

Counterpart of ``mirror_tpu/losses/surv.py`` (the reference's
losses/nll_surv.py and losses/cross_entropy_surv.py):

- ``logits`` [N, M] raw outputs, hazards = sigmoid(logits), clipped to
  [eps, 1 - eps];
- ``event_times`` [N] the discretised interval index;
- ``censoring`` [N]: 1 == the event occurred (the reference derives it
  from "1:DECEASED"), 0 == censored;
- ``valid`` ([N] 0/1, optional) drops loader-padded tail rows from the
  reduction, so a padded tail batch reduces like the small tail batch.
"""

from typing import Optional

import torch


def _reduce(loss: torch.Tensor, reduction: str, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is not None:
        valid = valid.to(loss.dtype)
        loss = loss * valid
        if reduction == "mean":
            return loss.sum() / valid.sum().clamp_min(1.0)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def nll_surv_loss(logits: torch.Tensor, event_times: torch.Tensor, censoring: torch.Tensor,
                  alpha: float = 0.0, eps: float = 1e-7, reduction: str = "mean",
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Negative log-likelihood: an uncensored sample survived the intervals
    before T and had its event at T; a censored one survived up to and
    including T. ``alpha`` weights the uncensored term once more."""
    m = logits.shape[1]
    hazards = torch.sigmoid(logits).clamp(eps, 1.0 - eps)
    log_h, log_1mh = torch.log(hazards), torch.log(1.0 - hazards)
    t = event_times.long()[:, None]
    time_range = torch.arange(m, device=logits.device)[None, :]
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    uncensored_nll = -(torch.where(time_range < t, log_1mh, zero).sum(1)
                       + torch.where(time_range == t, log_h, zero).sum(1))
    censored_nll = -torch.where(time_range <= t, log_1mh, zero).sum(1)
    uncensored_only = torch.where(censoring == 1, uncensored_nll, zero)
    neg_l = uncensored_only + torch.where(censoring == 0, censored_nll, zero)
    return _reduce((1.0 - alpha) * neg_l + alpha * uncensored_only, reduction, valid)


def ce_surv_loss(logits: torch.Tensor, event_times: torch.Tensor, censoring: torch.Tensor,
                 eps: float = 1e-7, reduction: str = "mean",
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the whole event distribution: p(event at t) =
    h_t prod_{j<t} (1 - h_j) for t < M and p(no event) = S_M as class M,
    renormalised; the target is T for an event and M when censored."""
    n, m = logits.shape
    hazards = torch.sigmoid(logits).clamp(eps, 1.0 - eps)
    survival = torch.cumprod(1.0 - hazards, dim=1)
    survival_padded = torch.cat([survival.new_ones(n, 1), survival], dim=1)
    p_dist = torch.cat([hazards * survival_padded[:, :-1], survival[:, -1:]], dim=1)
    p_dist = p_dist / p_dist.sum(1, keepdim=True).clamp_min(eps)
    targets = torch.where(censoring == 1, event_times.long(),
                          torch.full_like(event_times, m, dtype=torch.long))
    chosen = p_dist.gather(1, targets[:, None])[:, 0].clamp_min(eps)
    return _reduce(-torch.log(chosen), reduction, valid)
