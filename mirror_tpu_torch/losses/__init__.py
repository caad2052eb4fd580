"""Losses of the port."""

from .info_nce import info_nce
from .mirror_loss import MirrorLossWeights, clip_loss, mirror_loss
from .surv import ce_surv_loss, nll_surv_loss

__all__ = ["MirrorLossWeights", "ce_surv_loss", "clip_loss", "info_nce", "mirror_loss",
           "nll_surv_loss"]
