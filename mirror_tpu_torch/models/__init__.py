"""Model definitions of the port: the downstream classifier, the MIRROR
pretraining model, and the patch feature extractors."""

from .classifier import MIRRORClassifier
from .feature_extractors import TruncatedResNet50, ViTB16
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
    "TruncatedResNet50",
    "ViTB16",
]
