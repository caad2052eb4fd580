"""Hand-written Hopper kernels of the port, each beside its plain version.

Every op of the slide model is a ``torch.autograd.Function``; its forward
and backward are kernels on CUDA tensors and plain PyTorch on CPU tensors.
The ViT ops of feature extraction are inference-only functions, as on the
TPU.

| kernel (launch count) | source | TPU kernel it replaces (mirror_tpu/ops/) |
| --- | --- | --- |
| landmark_softmax | csrc/landmark.cu | landmark_pallas.py::landmark_softmax fwd |
| landmark_softmax_bwd | csrc/landmark.cu | the same, bwd (_bwd_call) |
| moore_penrose_pinv | csrc/pinv.cu | pinv_pallas.py::moore_penrose_pinv_pallas fwd |
| softmax_attn | csrc/softmax_attn.cu | nystrom_pallas.py::softmax_matmul_landmark_kv fwd |
| softmax_attn_q | csrc/softmax_attn.cu | nystrom_pallas.py::softmax_matmul_landmark_q fwd |
| softmax_attn_bwd | csrc/softmax_attn_bwd.cu | nystrom_pallas.py::fused_softmax_attn bwd |
| softmax_attn_conv | csrc/softmax_attn.cu | nystrom_pallas.py::fused_softmax_attn_conv fwd |
| softmax_attn_conv_bwd | csrc/softmax_attn_bwd.cu | the same, bwd (_bwd_conv_call) |
| ppeg | csrc/ppeg.cu | ppeg_pallas.py::ppeg_fused fwd |
| ppeg_bwd | csrc/ppeg.cu | the same, bwd (_bwd_call) |
| vit_attn_block | csrc/vit_gemm.cu + csrc/vit_attn.cu | vit_attn_pallas.py::attn_block |
| vit_mlp_block | csrc/vit_gemm.cu | vit_attn_pallas.py::mlp_block |
| vit_mha_natural | csrc/vit_attn.cu | vit_attn_pallas.py::mha_natural |

The pinv's implicit gradient is two matrix products outside any kernel, as
in the JAX package; its exact backward (pinv_pallas.py:171) is not ported.
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
from .vit_attn import attn_block, mha_natural, mlp_block

__all__ = [
    "attn_block",
    "fused_softmax_attn",
    "fused_softmax_attn_conv",
    "landmark_softmax",
    "launch_counts",
    "mha_natural",
    "mlp_block",
    "moore_penrose_pinv",
    "ppeg_fused",
    "reset_launch_counts",
    "softmax_matmul_landmark_kv",
    "softmax_matmul_landmark_q",
]
