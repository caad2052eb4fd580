"""Hand-written Hopper kernels of the port, each beside its plain version.

| kernel | source | TPU kernel it replaces (mirror_tpu/ops/) |
| --- | --- | --- |
| landmark_softmax | csrc/landmark.cu | landmark_pallas.py::landmark_softmax |
| moore_penrose_pinv | csrc/pinv.cu | pinv_pallas.py::moore_penrose_pinv_pallas |
| softmax_attn | csrc/softmax_attn.cu | nystrom_pallas.py::softmax_matmul_landmark_kv / _q |
| softmax_attn_conv | csrc/softmax_attn.cu | nystrom_pallas.py::fused_softmax_attn_conv |
| ppeg | csrc/ppeg.cu | ppeg_pallas.py::ppeg_fused |
"""

from ._common import launch_counts, reset_launch_counts
from .landmark import landmark_softmax
from .nystrom_attn import (
    fused_softmax_attn,
    fused_softmax_attn_conv,
    softmax_matmul_landmark_kv,
    softmax_matmul_landmark_q,
)
from .pinv import moore_penrose_pinv
from .ppeg import ppeg_fused

__all__ = [
    "fused_softmax_attn",
    "fused_softmax_attn_conv",
    "landmark_softmax",
    "launch_counts",
    "moore_penrose_pinv",
    "ppeg_fused",
    "reset_launch_counts",
    "softmax_matmul_landmark_kv",
    "softmax_matmul_landmark_q",
]
