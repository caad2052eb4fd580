"""Model registry, counterpart of ``mirror_tpu/registry.py``.

``create_model("mirror_classifier", device=..., **kwargs)`` filters the
accepted kwargs and warns about the others, like the reference's registry
functions. Config conveniences:

- ``rna_norm_layer``: "layernorm" -> LayerNorm eps 1e-5; None/"" -> 1e-6;
- ``rna_act_layer``: only "gelu" is supported;
- ``dtype``: the compute dtype, a torch dtype or its name ("bfloat16").

The model is built without drawing any weights. With a ``generator`` it gets
the reference's torch-default init drawn from it; without one its weights
are left for ``load_state_dict``.
"""

import logging
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .models import MIRRORClassifier
from .models.layers import LayerScale

_logger = logging.getLogger(__name__)

_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def list_models():
    return sorted(_REGISTRY)


def create_model(name: str, device="cpu", generator: Optional[torch.Generator] = None,
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
    """torch-default init (U(+-1/sqrt(fan_in)) for Linear and Conv weights
    and biases, LayerNorm ones/zeros, cls token ~ N(0, 1), gene embedding
    ~ N(0, 0.02)), every draw from ``generator``. Draws run on the CPU so a
    seed gives the same weights on every device."""

    def uniform_(p: torch.Tensor, bound: float) -> None:
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=generator))

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            uniform_(mod.weight, bound)
            if mod.bias is not None:
                uniform_(mod.bias, bound)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, LayerScale):
            mod.gamma.fill_(mod.init_values)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "cls_token":
            normal_(p, 1.0)
        elif leaf == "gene_embed":
            normal_(p, 0.02)


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
