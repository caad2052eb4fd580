"""Losses of the port."""

from .info_nce import contrastive_info_nce, info_nce, reduce_info_nce
from .mirror_loss import MirrorLossWeights, clip_loss, mirror_loss, reduce_over_ranks
from .surv import ce_surv_loss, nll_surv_loss

__all__ = ["MirrorLossWeights", "ce_surv_loss", "clip_loss", "contrastive_info_nce",
           "info_nce", "mirror_loss", "nll_surv_loss", "reduce_info_nce", "reduce_over_ranks"]
