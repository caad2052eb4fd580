"""Nystrom linear-complexity attention.

Counterpart of ``mirror_tpu/models/nystrom.py::NystromAttention``, the
algorithm of the reference's ``nystrom_attention`` package:

1. front-pad the sequence with zeros to a multiple of ``num_landmarks`` m;
2. landmarks = means over contiguous groups of l = (n + pad) / m tokens;
3. three softmax similarities: (q, k_l), (q_l, k_l), (q_l, k);
4. the middle [m, m] matrix is pseudo-inverted by 6 Moore-Penrose
   iterations (z0 scaled by the GLOBAL max row and column sums);
5. out = attn1 pinv(attn2) (attn3 v) + a depthwise 33-tap conv of v along
   the sequence (one filter per head, no bias).

One module, two paths, and the device alone picks between them:

- on CUDA, the pad-aware kernel path of the JAX package's ``use_pallas``
  branch: nothing is padded (the pad's contributions have closed forms
  inside the kernels), head-major q/k/v go through the landmark, pinv,
  landmark-softmax and conv-fused attention kernels of ``ops``;
- on CPU, the plain path of the JAX package's dense branch: the front pad
  is materialised, the attention matrices are built, and the output is
  trimmed to the last n rows.

Both paths are differentiable. The kernel path's gradients are the kernels'
own backward passes (each op is a ``torch.autograd.Function``), and the
pinv takes the implicit gradient by default (``pinv_grad``, as the JAX
train step does). ``xavier_init`` marks to_qkv and to_out for xavier-uniform
init with zero bias (the hybrid WSI encoder's); the output dropout is live
in training.

Parameter names are the reference's: ``to_qkv`` (no bias), ``to_out.0``,
and ``res_conv.weight`` [h, 1, 33, 1] (the JAX param ``res_conv_kernel``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.landmark import landmark_softmax
from ..ops.nystrom_attn import (
    depthwise_conv_seq_ref,
    fused_softmax_attn_conv,
    softmax_matmul_landmark_kv,
    softmax_matmul_landmark_q,
)
from ..ops.pinv import moore_penrose_pinv
from .layers import Dense, Dropout


class NystromAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 num_landmarks: int = 256, pinv_iterations: int = 6,
                 residual: bool = True, residual_conv_kernel: int = 33,
                 dropout: float = 0.0, pinv_grad: str = "implicit",
                 xavier_init: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks = num_landmarks
        self.pinv_iterations = pinv_iterations
        self.pinv_grad = pinv_grad
        self.dtype = dtype
        inner = heads * dim_head
        init = "xavier" if xavier_init else "torch"
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype, init=init)
        self.to_out = nn.Sequential(Dense(inner, dim, dtype=dtype, init=init),
                                    Dropout(dropout))
        self.res_conv = None
        if residual:
            k = residual_conv_kernel
            self.res_conv = nn.Conv2d(heads, heads, (k, 1), padding=(k // 2, 0),
                                      groups=heads, bias=False)

    def _res_kernel(self, cdt: torch.dtype) -> torch.Tensor:
        return self.res_conv.weight.reshape(self.heads, -1).to(cdt)  # [h, K]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            return self._forward_kernels(x)
        return self._forward_plain(x)

    def _forward_kernels(self, x: torch.Tensor) -> torch.Tensor:
        """nystrom.py:221-301 of the JAX package: no pad, head-major tensors,
        the pad riding as virtual rows and columns inside the kernels."""
        b, n, d = x.shape
        h, dh, m = self.heads, self.dim_head, self.num_landmarks
        cdt = self.dtype or torch.float32
        pad = (m - n % m) % m
        # one GEMM for q|k|v, then the head-major relayout
        qkv = self.to_qkv(x).reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv.unbind(0))  # each [b, h, n, dh]
        q = q * dh ** -0.5
        q_l, k_l, attn2 = landmark_softmax(q, k, m, pad)
        attn2_inv = moore_penrose_pinv(attn2, self.pinv_iterations, self.pinv_grad)
        r3 = softmax_matmul_landmark_kv(q_l, k, v, pad)
        w = torch.matmul(attn2_inv, r3).to(q.dtype)
        if self.res_conv is not None:
            out = fused_softmax_attn_conv(q, k_l, w, v, self._res_kernel(cdt))
        else:
            out = softmax_matmul_landmark_q(q, k_l, w)
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        return self.to_out(out.to(x.dtype))

    def _forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """nystrom.py:235-347 of the JAX package: materialised front pad,
        dense attention matrices, then the last n rows."""
        b, n, d = x.shape
        h, dh, m = self.heads, self.dim_head, self.num_landmarks
        cdt = self.dtype or torch.float32
        pad = (m - n % m) % m
        if pad:
            x = F.pad(x, (0, 0, pad, 0))
        n_pad = n + pad
        l = n_pad // m
        qkv = self.to_qkv(x).reshape(b, n_pad, 3, h, dh)
        q, k, v = qkv.unbind(2)  # each [b, n_pad, h, dh]
        q = q * dh ** -0.5
        q_l = q.reshape(b, m, l, h, dh).mean(2)
        k_l = k.reshape(b, m, l, h, dh).mean(2)
        sim2 = torch.einsum("bihd,bjhd->bhij", q_l.float(), k_l.float())
        attn2 = torch.softmax(sim2, dim=-1).to(cdt)
        attn2_inv = moore_penrose_pinv(attn2, self.pinv_iterations, self.pinv_grad)
        sim1 = torch.einsum("bihd,bjhd->bhij", q.float(), k_l.float())
        sim3 = torch.einsum("bihd,bjhd->bhij", q_l.float(), k.float())
        attn1 = torch.softmax(sim1, dim=-1).to(cdt)
        attn3 = torch.softmax(sim3, dim=-1).to(cdt)
        r3 = torch.einsum("bhij,bjhd->bhid", attn3, v)
        w = torch.matmul(attn2_inv, r3)
        out = torch.einsum("bhij,bhjd->bihd", attn1, w).to(x.dtype)  # [b, n_pad, h, dh]
        if self.res_conv is not None:
            res = depthwise_conv_seq_ref(v.transpose(1, 2).to(cdt), self._res_kernel(cdt))
            out = out + res.to(cdt).transpose(1, 2).to(out.dtype)
        out = self.to_out(out.reshape(b, n_pad, h * dh))
        return out[:, -n:]
