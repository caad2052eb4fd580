"""Model definitions of the port (eval-time slice: the downstream classifier)."""

from .classifier import MIRRORClassifier
from .nystrom import NystromAttention
from .rna_transformer import TransFormer
from .transmil import PPEG, FeatureTransMIL, TransLayer

__all__ = [
    "PPEG",
    "FeatureTransMIL",
    "MIRRORClassifier",
    "NystromAttention",
    "TransFormer",
    "TransLayer",
]
