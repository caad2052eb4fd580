"""Losses of the port."""

from .mirror_loss import MirrorLossWeights, clip_loss, mirror_loss

__all__ = ["MirrorLossWeights", "clip_loss", "mirror_loss"]
