#!/usr/bin/env python
"""Split a MIRROR pretrain checkpoint into per-modality weight files.

Counterpart of ``mirror_tpu/tools/split_weights.py``, with its semantics:
load the checkpoint (or, given a run root, the newest run directory's
``model_best*``), keep the ``wsi_encoder.*`` and the ``rna_encoder.*``
weights, the keys with their prefix (as the JAX split keeps the
``{encoder: ...}`` level), drop the encoder's ``mask_token``, and write each
with the payload's ``epoch``, ``arch``, ``metric``, ``args`` and
``version`` as ``wsi_<name>`` and ``rna_<name>`` beside the input:

    python -m mirror_tpu_torch.tools.split_weights runs/pretrain/<run>/model_best.pth.tar

The input may be the JAX package's msgpack checkpoint; the port writes the
reference's ``.pth.tar`` (``wsi_model_best.msgpack`` becomes
``wsi_model_best.pth.tar``).
"""

import argparse
import glob
import os

from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, save_payload

MSGPACK = ".msgpack"


def split_weights(checkpoint_path: str, output_dir: str = "") -> list:
    """Write the two files; returns their paths."""
    payload = load_checkpoint_file(checkpoint_path)
    state_dict = payload["state_dict"]
    out_dir = output_dir or os.path.dirname(checkpoint_path)
    base = os.path.basename(checkpoint_path)
    if base.endswith(MSGPACK):
        base = base[:-len(MSGPACK)] + ".pth.tar"
    paths = []
    for modality in ("wsi", "rna"):
        prefix = f"{modality}_encoder."
        part = {k: v for k, v in state_dict.items()
                if k.startswith(prefix) and k != prefix + "mask_token"}
        if not part:
            raise SystemExit(f"{checkpoint_path}: no {prefix}* weights")
        out_payload = {key: payload.get(key) for key in ("epoch", "arch", "metric", "args")}
        out_payload.update(state_dict=part, version=payload.get("version", 2))
        path = os.path.join(out_dir, f"{modality}_{base}")
        save_payload(path, out_payload)
        print(f"{path}: {len(part)} tensors")
        paths.append(path)
    return paths


def find_latest_checkpoint(run_root: str, pattern: str = "model_best*") -> str:
    """The newest run directory's best checkpoint (the evaluator's
    discovery rule): the last match of ``<run_root>/*/<pattern>`` in name
    order, the run directories being named by their start time."""
    candidates = sorted(glob.glob(os.path.join(run_root, "*", pattern)))
    if not candidates:
        raise SystemExit(f"No checkpoints under {run_root}")
    return candidates[-1]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", help="checkpoint file or run directory")
    p.add_argument("--output-dir", default="")
    a = p.parse_args(argv)
    path = a.checkpoint
    # an Orbax checkpoint is a directory too: load_checkpoint_file refuses it by name
    if os.path.isdir(path) and not path.rstrip("/").endswith(".orbax"):
        path = find_latest_checkpoint(path)
    return split_weights(path, a.output_dir)


if __name__ == "__main__":
    main()
