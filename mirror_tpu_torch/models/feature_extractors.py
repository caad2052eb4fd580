"""Patch feature-extraction backbones.

Counterpart of ``mirror_tpu/models/feature_extractors.py``:

- :class:`ViTB16`: the Phikon ViT-B/16 (HF ``ViTModel`` architecture, LN eps
  1e-12, learned position embeddings, exact GELU) whose CLS embedding of the
  last hidden state is the 768-d patch feature. Attribute names give the HF
  ``ViTModel`` keys (``embeddings.patch_embeddings.projection.weight``,
  ``encoder.layer.{i}.attention.attention.query.weight``, ...), so a Phikon
  snapshot loads with :func:`load_hf_vit_weights`.
- :class:`TruncatedResNet50`: CLAM's ResNet50 cut after layer3 with global
  average pooling, 1024-d, with torchvision's keys (``layer3.5.bn3.running_var``).

Both compute in ``dtype`` (bf16 on the card) with fp32 parameters;
BatchNorm uses its running statistics. Images come in NHWC, as in the JAX
package. The ViT has one path, the JAX package's ``use_pallas`` one: the
half-block entries of ``ops/vit_attn``, two per block (with
``quant="int8"``, W8A8 projections around the natural-layout attention
entry). On the card they launch the kernels, on the CPU they run their
plain versions: the device alone picks. The kernels are inference-only:
call the models under ``torch.no_grad()``. The convolutions are
``F.conv2d``: the JAX package has no TPU kernel there.

Modules are built with zeroed weights; :func:`init_weights` draws the JAX
package's init (lecun-normal kernels, zero biases, trunc-normal(0.02) CLS
and position embeddings) from a ``torch.Generator``.
"""

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vit_attn import attn_block_qkv, mha_natural, mlp_block
from .layers import Dense, LayerNorm, trunc_normal_

# ---------------------------------------------------------------------------
# ViT-B/16 (Phikon-compatible)
# ---------------------------------------------------------------------------


class QuantDense(nn.Linear):
    """W8A8 dynamically quantized Linear for inference: per-output-channel
    weight scales, per-token activation scales, round-half-even, an exact
    s8 x s8 -> s32 product (``torch._int_mm``; on the card it takes more
    than 16 rows, which one 224-px image already gives), then
    out = y * (x_s * w_s) + bias in fp32. Its parameters are a Linear's
    (weight [out, in] fp32, bias), quantized at every call, so checkpoints
    and converters are the bf16 path's."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.weight.t()  # [in, out]
        w_s = (kernel.abs().amax(0, keepdim=True) / 127.0).clamp_min(1e-12)
        w_q = torch.round(kernel / w_s).to(torch.int8)
        xf = x.float()
        x_s = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
        x_q = torch.round(xf / x_s).to(torch.int8)
        y = torch._int_mm(x_q.reshape(-1, x.shape[-1]), w_q)
        y = y.reshape(*x.shape[:-1], self.out_features)
        out = y.float() * (x_s * w_s) + self.bias
        return out.to(self.dtype or x.dtype)


def _kernel_weight(linear: nn.Linear, cdt: torch.dtype) -> torch.Tensor:
    """A Linear's weight as the kernels take it: [in, out], contiguous."""
    return linear.weight.to(cdt).t().contiguous()


def _cached_kernel_weights(module: nn.Module, params, cdt: torch.dtype, build):
    """``build()``, the kernel-layout weights of ``module``, made once per
    weight load: kept on the module and made again when one of ``params``
    changed (``load_state_dict`` copies into them in place, which bumps their
    version; ``.to()`` gives them new storage), or for another ``cdt``. A
    call that autograd would record builds afresh and keeps nothing."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return build()
    key = (cdt, tuple((p.device, p.data_ptr(), p._version) for p in params))
    cached = getattr(module, "_kernel_weights", None)
    if cached is None or cached[0] != key:
        cached = module._kernel_weights = (key, build())
    return cached[1]


class ViTSelfAttention(nn.Module):
    """HF's ``attention`` of a ViT layer: ``attention.{query,key,value}`` and
    ``output.dense``."""

    def __init__(self, hidden: int, num_heads: int = 12, quant: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads, self.quant, self.dtype = num_heads, quant, dtype

        def proj():
            return QuantDense(hidden, hidden, dtype) if quant == "int8" else Dense(hidden, hidden, dtype=dtype)

        self.attention = nn.ModuleDict({"query": proj(), "key": proj(), "value": proj()})
        self.output = nn.ModuleDict({"dense": proj()})

    def forward(self, x: torch.Tensor, fused_ln=None) -> torch.Tensor:
        """With ``quant="int8"``, ``x`` is the post-LN input and the result the
        attention output: W8A8 projections around one mha_natural call.
        Otherwise fused_ln = (ln_scale, ln_bias, eps), ``x`` is the pre-norm
        residual stream and the whole pre-LN half-block (LN, q|k|v,
        attention, output projection, residual) is one attn_block call."""
        att, out = self.attention, self.output["dense"]
        if self.quant == "int8":
            q, k, v = att["query"](x), att["key"](x), att["value"](x)
            return out(mha_natural(q, k, v, self.num_heads).to(x.dtype))
        ln_s, ln_b, eps = fused_ln
        cdt = self.dtype or torch.float32
        qkv = [att[name] for name in ("query", "key", "value")]

        def build():  # W_q | W_k | W_v side by side [d, 3d], their biases, W_o
            return (torch.cat([_kernel_weight(p, cdt) for p in qkv], dim=1),
                    torch.cat([p.bias for p in qkv]), _kernel_weight(out, cdt))

        wqkv, bqkv, wo = _cached_kernel_weights(self, list(self.parameters()), cdt, build)
        return attn_block_qkv(x.to(cdt), ln_s, ln_b, wqkv, bqkv, wo, out.bias, self.num_heads,
                              eps).to(x.dtype)


class ViTBlock(nn.Module):
    """One HF ViT layer: ``attention``, ``intermediate.dense``,
    ``output.dense``, ``layernorm_before``, ``layernorm_after``."""

    def __init__(self, hidden: int, num_heads: int = 12, mlp_ratio: float = 4.0,
                 norm_eps: float = 1e-12, quant: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_eps, self.quant, self.dtype = norm_eps, quant, dtype
        m = int(hidden * mlp_ratio)

        def dense(i, o):
            return QuantDense(i, o, dtype) if quant == "int8" else Dense(i, o, dtype=dtype)

        self.attention = ViTSelfAttention(hidden, num_heads, quant, dtype)
        self.intermediate = nn.ModuleDict({"dense": dense(hidden, m)})
        self.output = nn.ModuleDict({"dense": dense(m, hidden)})
        self.layernorm_before = LayerNorm(hidden, norm_eps, dtype)
        self.layernorm_after = LayerNorm(hidden, norm_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln1, ln2 = self.layernorm_before, self.layernorm_after
        fc1, fc2 = self.intermediate["dense"], self.output["dense"]
        if self.quant == "int8":  # the MLP unfused, as in the JAX package
            x = x + self.attention(ln1(x))
            return x + fc2(F.gelu(fc1(ln2(x)), approximate="none"))
        # two half-block kernels: between them only the [b, n, d] residual
        # stream goes through device memory
        x = self.attention(x, fused_ln=(ln1.weight, ln1.bias, self.norm_eps))
        cdt = self.dtype or torch.float32
        w1, w2 = _cached_kernel_weights(
            self, [fc1.weight, fc2.weight], cdt,
            lambda: (_kernel_weight(fc1, cdt), _kernel_weight(fc2, cdt)))
        return mlp_block(x.to(cdt), ln2.weight, ln2.bias, w1, fc1.bias, w2, fc2.bias,
                         self.norm_eps).to(x.dtype)


class ViTB16(nn.Module):
    """ViT-B/16 encoder returning the CLS embedding ([B, hidden], fp32)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, hidden_size: int = 768,
                 depth: int = 12, num_heads: int = 12, norm_eps: float = 1e-12,
                 quant: Optional[str] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if quant not in (None, "int8"):
            raise ValueError(f"quant={quant!r}: only None and 'int8'")
        self.patch_size, self.dtype = patch_size, dtype
        n_patches = (image_size // patch_size) ** 2
        self.embeddings = nn.Module()
        self.embeddings.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.embeddings.position_embeddings = nn.Parameter(torch.zeros(1, n_patches + 1, hidden_size))
        self.embeddings.patch_embeddings = nn.ModuleDict(
            {"projection": nn.Conv2d(3, hidden_size, patch_size, stride=patch_size)})
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            ViTBlock(hidden_size, num_heads, norm_eps=norm_eps, quant=quant, dtype=dtype)
            for _ in range(depth))
        self.layernorm = LayerNorm(hidden_size, norm_eps, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] normalized (NHWC)."""
        cdt = self.dtype or torch.float32
        emb = self.embeddings
        conv = emb.patch_embeddings["projection"]
        x = F.conv2d(images.to(cdt).permute(0, 3, 1, 2), conv.weight.to(cdt), conv.bias.to(cdt),
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, n_patches, hidden], row-major patches
        cls = emb.cls_token.to(cdt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embeddings.to(cdt)
        for block in self.encoder.layer:
            x = block(x)
        return self.layernorm(x[:, 0]).float()  # LN is per token: the CLS row only


def _checked_state(model: nn.Module, state: Dict[str, Any], skip=lambda k: False):
    """``state``'s entries for every key of ``model`` (those ``skip`` names
    excepted), as tensors; a missing key raises."""
    want = [k for k in model.state_dict() if not skip(k)]
    missing = [k for k in want if k not in state]
    if missing:
        raise KeyError(f"{len(missing)} weights missing from the checkpoint, e.g. {missing[:5]}")
    return {k: state[k] if torch.is_tensor(state[k]) else torch.from_numpy(np.array(state[k]))
            for k in want}


def load_hf_vit_weights(model: ViTB16, hf_state: Dict[str, Any]) -> ViTB16:
    """Load a HF ``ViTModel`` state_dict (tensors or numpy) into ``model``,
    strictly: every key of the model must be there, and every key there is
    the model's (a pooler, which the CLS feature does not use, excepted)."""
    state = {k: v for k, v in hf_state.items() if not k.startswith("pooler.")}
    extra = sorted(set(state) - set(model.state_dict()))
    if extra:
        raise KeyError(f"{len(extra)} checkpoint keys the ViT does not have, e.g. {extra[:5]}")
    model.load_state_dict(_checked_state(model, state))
    return model


# ---------------------------------------------------------------------------
# Truncated ResNet50 (CLAM-style, 1024-d)
# ---------------------------------------------------------------------------


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference BatchNorm in fp32 (running statistics), result in x's dtype."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        False, 0.0, bn.eps).to(x.dtype)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


class Bottleneck(nn.Module):
    """torchvision's (v1.5) bottleneck: the stride on the 3x3 conv."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=1e-5)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes * 4, eps=1e-5)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_bn(_conv(x, self.conv1), self.bn1))
        y = F.relu(_bn(_conv(y, self.conv2), self.bn2))
        y = _bn(_conv(y, self.conv3), self.bn3)
        residual = x
        if self.downsample is not None:
            residual = _bn(_conv(x, self.downsample[0]), self.downsample[1])
        return F.relu(y + residual)


class TruncatedResNet50(nn.Module):
    """ResNet50 through layer3 + global average pool => [B, 1024] fp32."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(((64, 3, 1), (128, 4, 2), (256, 6, 2)),
                                                      start=1):
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(inplanes, planes, stride if bi == 0 else 1, bi == 0))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] normalized (NHWC)."""
        x = images.to(self.dtype or torch.float32).permute(0, 3, 1, 2)
        x = F.relu(_bn(_conv(x, self.conv1), self.bn1))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer3(self.layer2(self.layer1(x)))
        # the mean in fp32, rounded to the compute dtype as jnp.mean does
        return x.float().mean((2, 3)).to(x.dtype).float()


def load_torch_resnet50_weights(model: TruncatedResNet50,
                                torch_state: Dict[str, Any]) -> TruncatedResNet50:
    """Load a torchvision resnet50 (or CLAM resnet_custom) state_dict into
    ``model``: every key of the model through layer3 must be there (the
    BN counters excepted); layer4 and fc are not used."""
    model.load_state_dict(
        _checked_state(model, torch_state, skip=lambda k: k.endswith("num_batches_tracked")),
        strict=False)
    return model


# ---------------------------------------------------------------------------
# init and image normalisation
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init drawn from ``generator``: flax's lecun-normal
    for every Linear and conv kernel (N(0, 1/fan_in) cut at 2 sigma), zero
    biases, LayerNorm and BatchNorm at identity (running mean 0, var 1), the
    ViT's CLS and position embeddings trunc-normal(0.02). Draws in module
    order."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            std = math.sqrt(1.0 / mod.weight[0].numel()) / 0.87962566103423978
            trunc_normal_(mod.weight, std, generator, -2.0 * std, 2.0 * std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.reset_parameters()
        elif isinstance(mod, ViTB16):
            trunc_normal_(mod.embeddings.cls_token, 0.02, generator)
            trunc_normal_(mod.embeddings.position_embeddings, 0.02, generator)
    return model


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_images(uint8_images: np.ndarray) -> np.ndarray:
    """uint8 [B, H, W, 3] RGB -> ImageNet-normalized float32 (the reference's
    albumentations Normalize)."""
    x = uint8_images.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def device_normalize(uint8_images: torch.Tensor) -> torch.Tensor:
    """The same normalisation on the tensor's device: batches travel to the
    card as uint8 (4x fewer bytes than fp32) and are normalised there."""
    x = uint8_images.float() * (1.0 / 255.0)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std
