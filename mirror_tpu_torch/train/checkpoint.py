"""The reference's ``.pth.tar`` checkpoint payload.

Schema (mirror_tpu/tools/import_torch_checkpoint.py:1-13): a dict with
``arch``, ``state_dict``, optionally ``state_dict_ema``, ``args`` (the run's
arguments: a yaml string, a dict, or the reference's argparse Namespace),
``epoch``, ``metric`` and ``version``; the port adds the run's state that
``--resume`` restores (:func:`resume_checkpoint`): ``optimizer`` (the
chain's buffers keyed by parameter name, its counts, the accumulated
micro-gradients and the host lr), ``step`` (the update count) and
``rng_state`` (the train step generator's state).

:func:`load_checkpoint_file` detects the format, as the JAX package's
loaders do (``mirror_tpu/train/checkpoint.py:137-145``): a torch zip or
pickle is this payload; a flax msgpack file, the JAX package's checkpoint,
is read by ``jax_checkpoint.py`` into it (weights and EMA weights; the optax
state is dropped, so ``--resume`` refuses one); an Orbax directory is
refused by name.

:func:`load_pretrained` warm-starts a downstream model from a pretrain
checkpoint, non-strict (``mirror_tpu/train/checkpoint.py:318-361``).
"""

import argparse
import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import yaml

from ..parallel.tensor_parallel import load_full_state_dict
from . import jax_checkpoint

_logger = logging.getLogger(__name__)

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


ORBAX_DIRECTORY_REFUSAL = (
    "{path} is a directory, an Orbax checkpoint of the JAX package: reading its OCDBT store "
    "needs tensorstore, which the card's machine lacks. Save it as msgpack with the JAX "
    "package (mirror_tpu.train.checkpoint: save_checkpoint_file(path, "
    "load_checkpoint_file(dir))), which the port reads; `python -m "
    "mirror_tpu.tools.import_torch_checkpoint` goes the other way, from the port's "
    ".pth.tar to the JAX package"
)


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """Read a reference ``.pth.tar`` payload, or the JAX package's msgpack
    checkpoint as one (``jax_checkpoint.load_jax_checkpoint``);
    ``state_dict`` values become tensors. A bare state_dict file is
    accepted as ``{"state_dict": ...}``. An Orbax directory is refused
    (:data:`ORBAX_DIRECTORY_REFUSAL`)."""
    if os.path.isdir(path):
        raise SystemExit(ORBAX_DIRECTORY_REFUSAL.format(path=path))
    if jax_checkpoint.is_msgpack_file(path):
        return jax_checkpoint.load_jax_checkpoint(path)
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
                         args: Mapping[str, Any], arch: str = "mirror_classifier",
                         epoch: int = 0, metric: Any = None,
                         state_dict_ema: Optional[Mapping[str, Any]] = None,
                         run_state: Optional[Mapping[str, Any]] = None) -> None:
    """Write the payload (CPU tensors, run ``args`` stored as yaml, the EMA
    weights as ``state_dict_ema`` when given, and ``run_state``'s keys, the
    run's own state that ``--resume`` restores: ``optimizer``, ``step``,
    ``rng_state``) with a tmp file and a rename."""
    payload = {
        "epoch": epoch,
        "arch": arch,
        "state_dict": {k: v.detach().cpu() for k, v in to_tensors(state_dict).items()},
        "args": yaml.safe_dump(dict(args), default_flow_style=False),
        "metric": metric,
        "version": 2,
    }
    if state_dict_ema is not None:
        payload["state_dict_ema"] = {k: v.detach().cpu()
                                     for k, v in to_tensors(state_dict_ema).items()}
    payload.update(run_state or {})
    save_payload(path, payload)


def save_payload(path: str, payload: Mapping[str, Any]) -> None:
    """``torch.save`` to a tmp file, then a rename: a crash mid-save never
    leaves a partial file under ``path``."""
    tmp = path + ".tmp"
    torch.save(dict(payload), tmp)
    os.replace(tmp, path)


def load_pretrained(model: torch.nn.Module, path: str,
                    use_ema: bool = False) -> Tuple[List[str], List[str]]:
    """Copy into ``model`` every tensor of the checkpoint whose key and shape
    match one of its own; the rest of ``model`` keeps its init (torch's
    ``strict=False`` alone raises on a shape mismatch, so the keys are
    filtered first). ``use_ema`` reads the EMA weights when the payload has
    them (``state_dict_ema``, or the JAX package's ``ema_state_dict``).
    Returns (loaded keys, skipped keys of the model)."""
    payload = load_checkpoint_file(path)
    source = None
    if use_ema:
        source = payload.get("state_dict_ema") or payload.get("ema_state_dict")
    source = to_tensors(source) if source else payload["state_dict"]
    target = model.state_dict()
    matched = {k: v for k, v in source.items()
               if k in target and tuple(v.shape) == tuple(target[k].shape)}
    model.load_state_dict(matched, strict=False)
    loaded = sorted(matched)
    skipped = sorted(k for k in target if k not in matched)
    _logger.info("Loaded %d param tensors from %s (%d target entries kept their init)",
                 len(loaded), path, len(skipped))
    return loaded, skipped


def resume_checkpoint(path: str, model: torch.nn.Module, optimizer=None, ema=None,
                      generator: Optional[torch.Generator] = None,
                      resume_opt: bool = True) -> int:
    """``--resume``: restore the weights, the EMA weights (the live ones
    where the file has none), the EMA's update count from ``step`` (else
    its decay ramp restarts and overwrites the restored EMA), the train
    step generator and, unless ``resume_opt`` is False, the optimizer.
    Returns the start epoch, the saved epoch + 1 (timm's rule; a mid-epoch
    recovery file also starts at the next epoch). The file holds whole
    leaves; a model-sharded model (``parallel/tensor_parallel.py``) takes
    its rank's slices, at whatever model-parallel size the file was
    written. The JAX package's msgpack checkpoint is refused: its optax
    state has no counterpart in the port's optimizer, and
    ``--initial-checkpoint`` carries its weights."""
    if not os.path.isdir(path) and jax_checkpoint.is_msgpack_file(path):
        raise SystemExit(
            f"--resume {path}: a JAX package checkpoint; its optax opt_state has no "
            "counterpart in the port's optimizer layout, so the run cannot resume from it. "
            "--initial-checkpoint starts a run from its weights")
    payload = load_checkpoint_file(path)
    load_full_state_dict(model, payload["state_dict"])
    if ema is not None:
        ema_state = payload.get("state_dict_ema")
        if not ema_state:
            _logger.warning("%s has no state_dict_ema: the EMA restarts from the resumed "
                            "weights", path)
        load_full_state_dict(ema.module, ema_state or payload["state_dict"])
        ema.updates = int(payload.get("step", 0))
    if generator is not None and payload.get("rng_state") is not None:
        try:
            generator.set_state(payload["rng_state"])
        except RuntimeError as e:  # a CPU generator's state on the card, or back
            _logger.warning("the step generator's state in %s does not fit this "
                            "device's generator (%s); it keeps its seed", path, e)
    if optimizer is not None and resume_opt:
        if payload.get("optimizer") is None:
            _logger.warning("%s has no optimizer state: the optimizer starts afresh", path)
        else:
            optimizer.load_state_dict(payload["optimizer"])
    start_epoch = int(payload.get("epoch", -1)) + 1
    _logger.info("Resumed from %s (epoch %d)", path, start_epoch - 1)
    return start_epoch
