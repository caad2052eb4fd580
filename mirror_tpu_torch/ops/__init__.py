"""Hand-written Hopper kernels of the port, each beside its plain version.

Every op of the slide model is a ``torch.autograd.Function``; its forward
and backward are kernels on CUDA tensors and plain PyTorch on CPU tensors.
The ViT ops of feature extraction are inference-only functions, as on the
TPU.

| kernel (launch count) | source | TPU kernel it replaces (mirror_tpu/ops/) |
| --- | --- | --- |
| landmark_softmax | csrc/landmark.cu | landmark_pallas.py::landmark_softmax fwd |
| landmark_softmax_bwd | csrc/landmark_bwd.cu | the same, bwd (_bwd_call) |
| moore_penrose_pinv | csrc/pinv.cu | pinv_pallas.py::moore_penrose_pinv_pallas fwd |
| moore_penrose_pinv_bwd | csrc/pinv.cu | the same, exact bwd (pinv_pallas.py:171) |
| softmax_attn | csrc/softmax_attn.cu | nystrom_pallas.py::softmax_matmul_landmark_kv fwd |
| softmax_attn_q | csrc/softmax_attn.cu | nystrom_pallas.py::softmax_matmul_landmark_q fwd |
| softmax_attn_bwd | csrc/softmax_attn_bwd.cu | nystrom_pallas.py::fused_softmax_attn bwd |
| softmax_attn_conv | csrc/softmax_attn.cu | nystrom_pallas.py::fused_softmax_attn_conv fwd |
| softmax_attn_conv_bwd | csrc/softmax_attn_bwd.cu, its conv conv1d.cu | the same, bwd (_bwd_conv_call) |
| ppeg | csrc/ppeg.cu | ppeg_pallas.py::ppeg_fused fwd |
| ppeg_bwd | csrc/ppeg.cu | the same, bwd (_bwd_call) |
| vit_attn_block | csrc/vit_gemm.cu + csrc/vit_attn.cu | vit_attn_pallas.py::attn_block |
| vit_mlp_block | csrc/vit_gemm.cu | vit_attn_pallas.py::mlp_block |
| vit_mha_natural | csrc/vit_attn.cu | vit_attn_pallas.py::mha_natural |
| vit_ln, vit_gemm (each launch within the two above) | csrc/vit_gemm.cu | their LN (_ln_f32) and products |
| conv1d | csrc/conv1d.cu | conv1d_pallas.py::depthwise_conv1d_seq fwd |
| conv1d_bwd | csrc/conv1d.cu | the same, bwd (_bwd_call) |
| ln_qkv | csrc/ln_qkv.cu | ln_qkv_pallas.py::ln_qkv_fused fwd |
| ln_qkv_bwd | csrc/ln_qkv.cu | the same, bwd (_bwd_call) |

The TPU probes of ``scripts/`` (``mirror_tpu_torch.scripts``) add kernel
instances beside these, each counted under its own name:

| kernel (launch count) | source | TPU probe it replaces (scripts/) |
| --- | --- | --- |
| copy_floor | csrc/copy_floor.cu | exp_hbm_floor.py (copy_floor, run_flat, run_ntile) |
| conv1d_bwd_dv, column_sum | csrc/conv1d.cu | exp_conv_parts.py (9b's parts) |
| vit_mha_headmajor, vit_mha_natural_grouped | csrc/vit_attn.cu | exp_vit_attn_kernel.py (make_headmajor, make_natural) |
| moore_penrose_pinv_bwd_stash1, _stash2 | csrc/pinv.cu | exp_pinv_stash.py (make_variant) |
| vit_fused_attn, vit_fused_mlp, vit_fused_attn_block, vit_fused_mlp_block | csrc/vit_fused.cu (ops/vit_fused.py) | exp_vit_fused_sublayer.py (make_k5, make_k7, make_k8, make_k9) |

The pinv's implicit gradient is two matrix products outside any kernel, as
in the JAX package; ``grad="exact"`` runs its exact backward kernel.
``ln_qkv_fused`` is library-only, as in the JAX package: no model calls it.
"""

from ._common import launch_counts, reset_launch_counts
from .conv1d import depthwise_conv1d_seq
from .landmark import landmark_softmax
from .ln_qkv import ln_qkv_fused
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
    "depthwise_conv1d_seq",
    "fused_softmax_attn",
    "fused_softmax_attn_conv",
    "landmark_softmax",
    "launch_counts",
    "ln_qkv_fused",
    "mha_natural",
    "mlp_block",
    "moore_penrose_pinv",
    "ppeg_fused",
    "reset_launch_counts",
    "softmax_matmul_landmark_kv",
    "softmax_matmul_landmark_q",
]
