"""JAX package params -> the port's ``state_dict``.

``vit_state_dict_from_jax`` and ``resnet50_state_dict_from_jax`` do the
same for the feature extractors, whose keys are HF ``ViTModel``'s and
torchvision's (see ``models/feature_extractors.py``).

Counterpart of ``mirror_tpu/tools/import_torch_checkpoint.py::
to_torch_state_dict``, with the same keys and values, and numpy only (no jax
in the import chain). The port's modules are named after the original
reference, so the result loads with ``load_state_dict`` once its values are
tensors (``train.checkpoint.to_tensors``). It covers the classifier and
every ``MIRROR`` parameter: the bare leaves (``logit_scale``, mask tokens,
``retention_gene_embed``) keep their names, the prototypes' [D, P] kernel
becomes the [P, D] weight.

Layout conventions (flax -> torch):
- ``kernel`` [in, out] -> ``weight`` [out, in]; 4-d HWIO conv ``kernel``
  -> OIHW ``weight``;
- LayerNorm ``scale`` -> ``weight``;
- NystromAttention ``res_conv_kernel`` [h, 1, K, 1] -> ``res_conv.weight``;
- ``to_out`` -> ``to_out.0``, the WSI encoder's ``fc1`` -> ``_fc1.0``,
  ``block_N`` -> ``blocks.N``, ``retention_block_N`` -> ``retention_blocks.N``.
"""

import re
from typing import Any, Dict, Tuple

import numpy as np


def _contig(a: np.ndarray) -> np.ndarray:
    # keep 0-d scalars 0-d (np.ascontiguousarray would make them (1,))
    return a if a.ndim == 0 else np.ascontiguousarray(a)


def _conv_weight(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1))  # flax HWIO -> torch OIHW


def _module_name(p: str, parent: Tuple[str, ...]) -> str:
    m = re.fullmatch(r"(retention_block|block)_(\d+)", p)
    if m:
        return f"{m.group(1)}s.{m.group(2)}"
    if p == "fc1" and (not parent or parent[-1] == "wsi_encoder"):
        return "_fc1.0"
    if p == "to_out":
        return "to_out.0"
    return p


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested JAX param dict (numpy arrays) -> flat torch-keyed numpy dict."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Dict[str, Any], path: Tuple[str, ...], tpath: Tuple[str, ...]):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,), tpath + (_module_name(k, path),))
                continue
            arr = np.asarray(v)
            if k == "res_conv_kernel":
                flat[".".join(tpath + ("res_conv", "weight"))] = arr
            elif k == "kernel":
                w = _conv_weight(arr) if arr.ndim == 4 else arr.T
                flat[".".join(tpath + ("weight",))] = w
            elif k == "scale":
                flat[".".join(tpath + ("weight",))] = arr
            else:  # bias, gamma, bare params (cls_token, gene_embed, ...)
                flat[".".join(tpath + (k,))] = arr

    walk(params, (), ())
    return {k: _contig(v) for k, v in flat.items()}


def vit_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``ViTB16`` params -> HF ``ViTModel`` keys (the port's
    ``ViTB16``): the inverse of ``mirror_tpu``'s ``load_hf_vit_weights``."""
    p = params
    out = {
        "embeddings.cls_token": p["cls_token"],
        "embeddings.position_embeddings": p["pos_embed"],
        "embeddings.patch_embeddings.projection.weight": _conv_weight(p["patch_embed"]["kernel"]),
        "embeddings.patch_embeddings.projection.bias": p["patch_embed"]["bias"],
        "layernorm.weight": p["layernorm"]["scale"],
        "layernorm.bias": p["layernorm"]["bias"],
    }
    for i in range(sum(1 for k in p if k.startswith("block_"))):
        blk, hb = p[f"block_{i}"], f"encoder.layer.{i}."
        dense = [(blk["attention"][ours], theirs) for ours, theirs in (
            ("query", "attention.attention.query"), ("key", "attention.attention.key"),
            ("value", "attention.attention.value"), ("output", "attention.output.dense"))]
        dense += [(blk["intermediate"], "intermediate.dense"), (blk["output"], "output.dense")]
        for node, name in dense:
            out[hb + name + ".weight"] = np.asarray(node["kernel"]).T
            out[hb + name + ".bias"] = node["bias"]
        for ln in ("layernorm_before", "layernorm_after"):
            out[hb + ln + ".weight"] = blk[ln]["scale"]
            out[hb + ln + ".bias"] = blk[ln]["bias"]
    return {k: _contig(np.asarray(v)) for k, v in out.items()}


def resnet50_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``TruncatedResNet50`` variables (``params`` and
    ``batch_stats``) -> torchvision resnet50 keys through layer3: the inverse
    of ``mirror_tpu``'s ``load_torch_resnet50_weights``."""
    p, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, Any] = {}

    def conv_bn(conv_name, bn_name, conv_p, bn_p, bn_s):
        out[conv_name + ".weight"] = _conv_weight(conv_p["kernel"])
        out[bn_name + ".weight"] = bn_p["scale"]
        out[bn_name + ".bias"] = bn_p["bias"]
        out[bn_name + ".running_mean"] = bn_s["mean"]
        out[bn_name + ".running_var"] = bn_s["var"]

    conv_bn("conv1", "bn1", p["conv1"], p["bn1"], stats["bn1"])
    for li, blocks in ((1, 3), (2, 4), (3, 6)):
        for bi in range(blocks):
            ours_p, ours_s = p[f"layer{li}_block{bi}"], stats[f"layer{li}_block{bi}"]
            theirs = f"layer{li}.{bi}"
            for ci in (1, 2, 3):
                conv_bn(f"{theirs}.conv{ci}", f"{theirs}.bn{ci}", ours_p[f"conv{ci}"],
                        ours_p[f"bn{ci}"], ours_s[f"bn{ci}"])
            if bi == 0:
                conv_bn(f"{theirs}.downsample.0", f"{theirs}.downsample.1",
                        ours_p["downsample_conv"], ours_p["downsample_bn"], ours_s["downsample_bn"])
    return {k: _contig(np.asarray(v)) for k, v in out.items()}
