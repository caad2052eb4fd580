"""Feature-file IO, counterpart of ``mirror_tpu/data/formats.py``.

Per-slide features are ``.npy`` (native, mmap-able), ``.npz``, or the
reference's torch ``.pt`` tensors.
"""

import os
from typing import List

import numpy as np

_FEATURE_EXTS = (".npy", ".pt", ".npz")


def load_feature_file(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[z.files[0]]
    if path.endswith(".pt"):
        import torch

        return torch.load(path, map_location="cpu", weights_only=True).numpy()
    raise ValueError(f"Unsupported feature file: {path}")


def list_feature_files(directory: str) -> List[str]:
    """One file per slide id, sorted; a slide present in several formats is
    listed once, preferring the _FEATURE_EXTS order (.npy first)."""
    by_id: dict = {}
    for f in os.listdir(directory):
        if not f.endswith(_FEATURE_EXTS):
            continue
        sid = f.split(".")[0]
        prev = by_id.get(sid)
        if prev is None or _ext_rank(f) < _ext_rank(prev):
            by_id[sid] = f
    return sorted(by_id.values())


def _ext_rank(fname: str) -> int:
    for i, ext in enumerate(_FEATURE_EXTS):
        if fname.endswith(ext):
            return i
    return len(_FEATURE_EXTS)
