"""JAX package params -> the port's ``state_dict``.

Counterpart of ``mirror_tpu/tools/import_torch_checkpoint.py::
to_torch_state_dict``, with the same keys and values, and numpy only (no jax
in the import chain). The port's modules are named after the original
reference, so the result loads with ``load_state_dict`` once its values are
tensors (``train.checkpoint.to_tensors``).

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
                w = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr.T
                flat[".".join(tpath + ("weight",))] = w
            elif k == "scale":
                flat[".".join(tpath + ("weight",))] = arr
            else:  # bias, gamma, bare params (cls_token, gene_embed, ...)
                flat[".".join(tpath + (k,))] = arr

    walk(params, (), ())
    return {k: _contig(v) for k, v in flat.items()}
