"""The reference's ``.pth.tar`` checkpoint payload.

Schema (mirror_tpu/tools/import_torch_checkpoint.py:1-13): a dict with
``arch``, ``state_dict``, optionally ``state_dict_ema``, ``args`` (the run's
arguments: a yaml string, a dict, or the reference's argparse Namespace),
``epoch``, ``metric`` and ``version``. The JAX package's flax msgpack files
are not read here: ``convert.state_dict_from_jax`` turns their params into
this payload's ``state_dict``.
"""

import argparse
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
import yaml

# torch state_dict wrapper prefixes (DDP, torch.compile)
_WRAP_PREFIXES = ("module.", "_orig_mod.")


def to_tensors(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Values as CPU tensors, wrapper prefixes stripped."""
    out = {}
    for key, val in state_dict.items():
        for pref in _WRAP_PREFIXES:
            if key.startswith(pref):
                key = key[len(pref):]
        out[key] = val if torch.is_tensor(val) else torch.tensor(np.asarray(val))
    return out


def run_args(payload: Mapping[str, Any]) -> Dict[str, Any]:
    """The run's arguments as a dict, whatever form the payload holds."""
    raw = payload.get("args")
    if raw is None or raw == "":
        return {}
    if isinstance(raw, str):
        return yaml.safe_load(raw) or {}
    if isinstance(raw, argparse.Namespace):
        return vars(raw)
    return dict(raw)


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """Read a reference ``.pth.tar`` payload; ``state_dict`` values become
    tensors. A bare state_dict file is accepted as ``{"state_dict": ...}``."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: expected a dict checkpoint payload")
    if "state_dict" not in payload:
        payload = {"state_dict": payload}
    payload["state_dict"] = to_tensors(payload["state_dict"])
    if payload.get("state_dict_ema"):
        payload["state_dict_ema"] = to_tensors(payload["state_dict_ema"])
    return payload


def save_checkpoint_file(path: str, state_dict: Mapping[str, Any],
                         args: Mapping[str, Any], arch: str = "mirror_classifier") -> None:
    """Write the payload (run ``args`` stored as yaml) with a tmp file and a
    rename."""
    payload = {
        "epoch": 0,
        "arch": arch,
        "state_dict": to_tensors(state_dict),
        "args": yaml.safe_dump(dict(args), default_flow_style=False),
        "metric": None,
        "version": 2,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
