#!/usr/bin/env python
"""Convert per-slide feature files between the reference's torch ``.pt`` and
the native ``.npy``.

Counterpart of ``mirror_tpu/tools/convert_features.py`` (``.pt`` -> ``.npy``),
with ``--to pt`` for the other direction:

    python -m mirror_tpu_torch.tools.convert_features SRC DST [--to npy|pt] [--delete-src]

The directory tree under SRC is kept; every value is written as fp32.
"""

import argparse
import logging
import os

import numpy as np

from mirror_tpu_torch.data.formats import load_feature_file, save_feature_file

_logger = logging.getLogger("convert_features")
_OTHER = {"npy": ".pt", "pt": ".npy"}


def convert_dir(src: str, dst: str, delete_src: bool = False, to: str = "npy") -> int:
    """Convert every ``.pt`` (``to="npy"``) or ``.npy`` (``to="pt"``) file
    under ``src`` into ``dst``; returns the count."""
    ext = _OTHER[to]
    os.makedirs(dst, exist_ok=True)
    n = 0
    for root, _, files in os.walk(src):
        rel = os.path.relpath(root, src)
        out_dir = os.path.join(dst, rel) if rel != "." else dst
        for f in sorted(files):
            if not f.endswith(ext):
                continue
            path = os.path.join(root, f)
            arr = np.asarray(load_feature_file(path), np.float32)
            os.makedirs(out_dir, exist_ok=True)
            save_feature_file(os.path.join(out_dir, f[:-len(ext)] + "." + to), arr)
            if delete_src:
                os.remove(path)
            n += 1
    _logger.info("converted %d files from %s to %s", n, src, dst)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--to", default="npy", choices=sorted(_OTHER))
    p.add_argument("--delete-src", action="store_true")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return convert_dir(a.src, a.dst, a.delete_src, a.to)


if __name__ == "__main__":
    main()
