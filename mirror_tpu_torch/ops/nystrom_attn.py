"""Row softmax attention of the Nystrom attention, bare and conv-fused.

Counterpart of ``mirror_tpu/ops/nystrom_pallas.py`` (forward only):
``softmax_matmul_landmark_kv``, ``softmax_matmul_landmark_q`` and
``fused_softmax_attn_conv``. All three run one CUDA source,
``csrc/softmax_attn.cu``, on CUDA tensors; on CPU tensors they run
:func:`softmax_attn_ref` (plus :func:`depthwise_conv_seq_ref`).
"""

from typing import Optional

import torch
import torch.nn.functional as F

from . import _common

KERNEL = "softmax_attn"
KERNEL_CONV = "softmax_attn_conv"


def softmax_pad_ref(sim: torch.Tensor, pad: int) -> torch.Tensor:
    """Row softmax of [zeros(pad) | sim] restricted to the sim columns: the
    `pad` virtual columns have logit 0 (``_softmax_pad`` on the TPU)."""
    if pad == 0:
        return torch.softmax(sim, dim=-1)
    mx = sim.amax(dim=-1, keepdim=True).clamp_min(0.0)
    e = torch.exp(sim - mx)
    return e / (e.sum(dim=-1, keepdim=True) + pad * torch.exp(-mx))


def softmax_attn_ref(q, k, w, pad: int = 0) -> torch.Tensor:
    """softmax_pad(q k^T) w in fp32, before the output rounding: fp32
    statistics, the attention rounded to w's dtype, fp32 accumulation."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = softmax_pad_ref(sim, pad).to(w.dtype)
    return torch.matmul(attn.float(), w.float())


def depthwise_conv_seq_ref(v: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """fp32 depthwise conv along the sequence of v [b, h, n, d] with one
    K-tap filter per head (kern [h, K]), zero SAME padding, no bias: the
    reference's Conv2d(h, h, (K, 1), groups=h)."""
    h, ksize = kern.shape
    weight = kern.float().reshape(h, 1, ksize, 1)
    return F.conv2d(v.float(), weight, padding=(ksize // 2, 0), groups=h)


def _check(q, k, w, r, c):
    b, h, _, dh = q.shape
    _common.check_kernel_input("q", q, (b, h, r, dh))
    _common.check_kernel_input("k", k, (b, h, c, dh))
    _common.check_kernel_input("w", w, (b, h, c, dh))
    if dh % 16 or dh > 128:
        raise ValueError(f"dh = {dh}: the kernel takes multiples of 16 up to 128")


def _launch(q, k, w, v: Optional[torch.Tensor], kern: Optional[torch.Tensor], pad: int):
    b, h, r, dh = q.shape
    c = k.shape[2]
    _check(q, k, w, r, c)
    ksize = 0
    if v is not None:
        ksize = kern.shape[1]
        _common.check_kernel_input("v", v, (b, h, r, dh))
        _common.check_kernel_input("kern", kern, (h, ksize))
        if ksize % 2 == 0 or ksize > 65:
            raise ValueError(f"conv taps = {ksize}: the kernel takes odd K up to 65")
    out = torch.empty_like(q)
    _common.launch(
        "mirror_softmax_attn", q.data_ptr(), k.data_ptr(), w.data_ptr(),
        v.data_ptr() if v is not None else None,
        kern.data_ptr() if kern is not None else None,
        out.data_ptr(), b * h, h, r, c, dh, pad, ksize,
    )
    return out


def fused_softmax_attn(q, k, w, pad: int = 0) -> torch.Tensor:
    """softmax(q k^T over c + pad columns) w, per (batch, head).

    q [b, h, r, d]; k, w [b, h, c, d] -> [b, h, r, d] in q's dtype. The
    `pad` virtual columns have zero k rows and zero w rows, exactly as the
    reference's front-padded sequence."""
    if not _common.on_cuda(q, k, w):
        return softmax_attn_ref(q, k, w, pad).to(q.dtype)
    out = _launch(q, k, w, None, None, pad)
    _common.count_launch(KERNEL)
    return out


def softmax_matmul_landmark_kv(q_l, k, v, pad: int = 0) -> torch.Tensor:
    """r3 = softmax(q_l k^T) v : [b, h, m, d], softmax over n + pad tokens."""
    return fused_softmax_attn(q_l, k, v, pad)


def softmax_matmul_landmark_q(q, k_l, w) -> torch.Tensor:
    """out = softmax(q k_l^T) w : [b, h, n, d], softmax over m."""
    return fused_softmax_attn(q, k_l, w)


def fused_softmax_attn_conv(q, k_l, w, v, kern, pad: int = 0) -> torch.Tensor:
    """softmax(q k_l^T) w + depthwise_conv_seq(v, kern), one rounding.

    q, v [b, h, n, d]; k_l, w [b, h, m, d]; kern [h, K] (K odd)."""
    if not _common.on_cuda(q, k_l, w, v, kern):
        out = softmax_attn_ref(q, k_l, w, pad) + depthwise_conv_seq_ref(v, kern)
        return out.to(q.dtype)
    out = _launch(q, k_l, w, v, kern, pad)
    _common.count_launch(KERNEL_CONV)
    return out
