"""Model definitions of the port: the downstream classifier and the MIRROR
pretraining model."""

from .classifier import MIRRORClassifier
from .mirror import MIRROR, MirrorOutput
from .nystrom import NystromAttention
from .rna_transformer import TransFormer, TransFormerHybrid
from .transmil import PPEG, FeatureTransMIL, FeatureTransMILHybrid, TransLayer

__all__ = [
    "MIRROR",
    "PPEG",
    "FeatureTransMIL",
    "FeatureTransMILHybrid",
    "MIRRORClassifier",
    "MirrorOutput",
    "NystromAttention",
    "TransFormer",
    "TransFormerHybrid",
    "TransLayer",
]
