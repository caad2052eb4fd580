"""Model registry, counterpart of ``mirror_tpu/registry.py``.

``create_model(name, device=..., **kwargs)`` (``mirror_classifier`` or
``mirror``) filters the accepted kwargs and warns about the others, like the
reference's registry functions. Config conveniences:

- ``rna_norm_layer``: "layernorm" -> LayerNorm eps 1e-5; None/"" -> 1e-6;
- ``rna_act_layer``: only "gelu" is supported;
- ``dtype``: the compute dtype, a torch dtype or its name ("bfloat16").

The model is built on ``device`` (the card by default) without drawing any
weights. With a ``generator`` it gets the reference's init drawn from it;
without one its weights are left for ``load_state_dict``.
"""

import logging
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .models import MIRROR, MIRRORClassifier
from .models.layers import (
    Dense,
    LayerScale,
    orthogonal_,
    trunc_normal_,
    xavier_uniform_,
)

_logger = logging.getLogger(__name__)

_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, device="cuda", generator: Optional[torch.Generator] = None,
                 **kwargs: Any) -> nn.Module:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown model '{name}'; available: {list_models()}")
    with torch.device("meta"):
        model = _REGISTRY[name](**kwargs)
    model = model.to_empty(device=device).eval()
    if generator is not None:
        init_weights(model, generator)
    return model


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's init, every draw from ``generator``: Linear weights
    by their ``Dense.init`` scheme (torch default U(+-1/sqrt(fan_in)) for
    weight and bias, xavier-uniform with zero bias, or orthogonal), times
    ``Dense.init_scale``; Conv2d torch default; LayerNorm ones/zeros; the cls
    token ~ N(0, cls_token_std^2); mask tokens ~ N(0, 0.02^2); gene
    embeddings trunc_normal(0.02); the logit scale ln(1/0.07). Draws run on
    the CPU so a seed gives the same weights on every device."""

    def uniform_(p: torch.Tensor, bound: float) -> None:
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=generator))

    for mod in model.modules():
        if isinstance(mod, Dense) and mod.init != "torch":
            if mod.init == "xavier":
                xavier_uniform_(mod.weight, generator)
            elif mod.init == "orthogonal":
                orthogonal_(mod.weight, generator)
            else:
                raise ValueError(f"unknown Dense init {mod.init!r}")
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            uniform_(mod.weight, bound)
            if mod.bias is not None:
                uniform_(mod.bias, bound)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, LayerScale):
            mod.gamma.fill_(mod.init_values)
        if isinstance(mod, Dense) and mod.init_scale != 1.0:
            mod.weight.mul_(mod.init_scale)
        if isinstance(getattr(mod, "cls_token", None), nn.Parameter):
            normal_(mod.cls_token, mod.cls_token_std)
        if isinstance(getattr(mod, "mask_token", None), nn.Parameter):
            normal_(mod.mask_token, 0.02)
        for leaf in ("gene_embed", "retention_gene_embed"):
            if isinstance(getattr(mod, leaf, None), nn.Parameter):
                trunc_normal_(getattr(mod, leaf), 0.02, generator)
    if isinstance(getattr(model, "logit_scale", None), nn.Parameter):
        model.logit_scale.fill_(model.init_logit_scale)


def _resolve_common(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(kwargs)
    norm_layer = out.pop("rna_norm_layer", None)
    if norm_layer in ("layernorm", "layer_norm"):
        out.setdefault("rna_norm_eps", 1e-5)
    elif norm_layer in (None, ""):
        out.setdefault("rna_norm_eps", 1e-6)
    else:
        raise ValueError(f"Unsupported rna_norm_layer: {norm_layer!r}")
    act_layer = out.pop("rna_act_layer", None)
    if act_layer not in (None, "", "gelu"):
        raise ValueError(f"Unsupported rna_act_layer: {act_layer!r}")
    dtype = out.pop("dtype", None)
    if isinstance(dtype, str):
        out["dtype"] = getattr(torch, dtype, None)
        if not isinstance(out["dtype"], torch.dtype):
            raise ValueError(f"Unknown dtype: {dtype!r}")
    elif dtype is not None:
        out["dtype"] = dtype
    return out


def _filter(kwargs: Dict[str, Any], accepted: set) -> Dict[str, Any]:
    filtered = {k: v for k, v in kwargs.items() if k in accepted}
    dropped = [k for k in kwargs if k not in accepted]
    if dropped:
        _logger.warning("Filtered model kwargs: %s", ", ".join(dropped))
    return filtered


@register_model
def mirror_classifier(**kwargs: Any) -> MIRRORClassifier:
    accepted = {
        "wsi_embed_dim", "rna_embed_dim", "embed_dim", "rna_encoder_depth",
        "rna_gene_embed", "rna_mlp_ratio", "rna_pos_drop_rate",
        "rna_proj_drop_rate", "rna_attn_drop_rate", "rna_drop_path_rate",
        "rna_norm_eps", "num_classes", "fusion", "dtype",
    }
    return MIRRORClassifier(**_filter(_resolve_common(kwargs), accepted))


@register_model
def mirror(**kwargs: Any) -> MIRROR:
    accepted = {
        "wsi_embed_dim", "rna_embed_dim", "embed_dim", "wsi_num_tokens",
        "wsi_retention_decoder_depth", "rna_encoder_depth", "rna_gene_embed",
        "rna_mlp_ratio", "rna_pos_drop_rate", "rna_proj_drop_rate",
        "rna_attn_drop_rate", "rna_drop_path_rate", "rna_norm_eps",
        "rna_retention_decoder_depth", "init_logit_scale", "style_mlp_hidden_dim",
        "style_mlp_out_dim", "style_latent_dim", "num_prototypes", "pinv_grad",
        "wsi_dropout", "dtype",
    }
    return MIRROR(**_filter(_resolve_common(kwargs), accepted))
