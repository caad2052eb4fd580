#!/usr/bin/env python
"""Patch feature extraction: streaming image decode -> backbone on the card ->
per-slide feature files.

Counterpart of ``mirror_tpu/tools/gen_patch_feature.py``, with its CLI and a
``--device`` flag (default ``cuda``):

    python -m mirror_tpu_torch.tools.gen_patch_feature PATCH_ROOT OUT_DIR \\
        --model phikon --checkpoint PHIKON_SNAPSHOT_DIR --batch-size 256

- slides are directories of patch images under ``{root}/{class}/{slide}/``
  (gen_patch's layout) or flat ``{root}/{slide}/``;
- host threads decode and resize the patches (cv2, INTER_AREA to 224); the
  batches travel to the card as uint8 and the ImageNet normalisation runs
  there;
- fixed-size batches (the tail padded by repeating its last patch) go
  through one bf16 backbone, which computes while the host decodes the
  next batch;
- per-slide ``[n_patches, D]`` features are written as ``.npy`` or ``.pt``;
- ``--fold/--k`` takes the slides ``[fold::k]``, for several processes;
- under a process group (``torchrun --nproc-per-node R -m
  mirror_tpu_torch.tools.gen_patch_feature ...``, or the ``MIRROR_*`` env
  of ``parallel/distributed.py``) rank r of R extracts every R-th of those
  slides from the r-th, each on its own device: the files are the ones one
  process writes (the JAX tool shards each image batch over its devices
  instead; a patch's features do not depend on its batch).

Backbones: ``phikon`` (ViT-B/16 CLS, 768-d, through the ViT half-block
kernels; ``--quant int8`` for W8A8 projections and the attention kernel)
and ``custom_resnet50`` (truncated ResNet50, 1024-d). Weights load from a
local HF snapshot directory (Phikon) or a torchvision ``.pt`` state_dict
(ResNet50); without one the weights are random, drawn from a seeded
generator. The ViT has one path: the kernels on the card, their plain
versions with ``--device cpu`` (``--no-use-pallas``, the JAX tool's dense
path, is refused). One device per process.
"""

import argparse
import logging
import os
import queue
import threading
import time
from typing import Iterator, List, Tuple

import numpy as np
import torch

from mirror_tpu_torch.utils.platform import default_device

_logger = logging.getLogger("gen_patch_feature")

IMG_EXTS = (".jpeg", ".jpg", ".png")
FEATURE_DIMS = {"phikon": 768, "custom_resnet50": 1024}
SEED = 0  # of the random weights drawn when no checkpoint is given


def list_slides(patch_root: str) -> List[Tuple[str, str]]:
    """(slide_name, slide_dir) pairs; slides may sit in class directories."""
    slides = []
    for entry in sorted(os.listdir(patch_root)):
        p = os.path.join(patch_root, entry)
        if not os.path.isdir(p):
            continue
        files = [f for f in os.listdir(p) if f.lower().endswith(IMG_EXTS)]
        if files:
            slides.append((entry, p))
        else:  # a class directory holding slide directories
            for sub in sorted(os.listdir(p)):
                sp = os.path.join(p, sub)
                if os.path.isdir(sp):
                    slides.append((os.path.join(entry, sub), sp))
    return slides


def decode_patch(path: str, size: int = 224) -> np.ndarray:
    """uint8 RGB [size, size, 3]; an unreadable file raises."""
    import cv2

    img = cv2.imread(path)  # BGR; None when unreadable
    if img is None:
        raise ValueError(f"unreadable patch image: {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.shape[:2] != (size, size):
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    return img


def batched_patch_stream(
    patch_files: List[str],
    batch_size: int,
    size: int = 224,
    num_threads: int = 4,
    prefetch: int = 4,
) -> Iterator[Tuple[np.ndarray, int]]:
    """Yields (uint8 RGB [batch_size, size, size, 3], n_valid). A producer
    thread decodes ahead into a bounded queue. Its contract: a decode error
    is re-raised in the consumer (the sentinel is always delivered, so the
    consumer never waits forever); a consumer that stops early stops the
    producer (timed puts watch ``stop``) and the producer is joined; while
    the consumer is live, the sentinel waits for room and never evicts a
    data batch."""
    from concurrent.futures import ThreadPoolExecutor

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()
    error = []
    stop = threading.Event()

    def producer():
        try:
            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                for i in range(0, len(patch_files), batch_size):
                    if stop.is_set():
                        return
                    chunk = patch_files[i:i + batch_size]
                    arr = np.stack(list(pool.map(lambda f: decode_patch(f, size), chunk)))
                    n_valid = len(chunk)
                    if n_valid < batch_size:
                        pad = np.repeat(arr[-1:], batch_size - n_valid, axis=0)
                        arr = np.concatenate([arr, pad])
                    while not stop.is_set():
                        try:
                            q.put((arr, n_valid), timeout=0.1)
                            break
                        except queue.Full:
                            continue
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            error.append(e)
        finally:
            while True:
                if stop.is_set():  # the consumer is gone: make room if needed
                    try:
                        q.put_nowait(sentinel)
                        break
                    except queue.Full:
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass
                else:
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer waiting in its timed put
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join()
    if error:
        raise error[0]


def build_extractor(model_name: str, checkpoint: str = "", use_pallas: bool = True,
                    quant=None, device="cuda"):
    """(fn, feature_dim): fn(uint8 [B, H, W, 3] array or tensor) -> [B, D]
    fp32 features on ``device``, computed in bf16; ``fn.model`` is the
    backbone."""
    from mirror_tpu_torch.models.feature_extractors import (
        TruncatedResNet50,
        ViTB16,
        device_normalize,
        init_weights,
        load_hf_vit_weights,
        load_torch_resnet50_weights,
    )

    device = torch.device(device)
    if not use_pallas:
        raise SystemExit("--no-use-pallas: the port's ViT has one path, the kernels on the "
                         "card and their plain versions on the CPU")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available; pass --device cpu to "
                         "extract on the CPU with the kernels' plain versions")
    with torch.device(device):
        if model_name == "phikon":
            model = ViTB16(quant=quant, dtype=torch.bfloat16)
        elif model_name == "custom_resnet50":
            model = TruncatedResNet50(dtype=torch.bfloat16)
        else:
            raise SystemExit(f"Unknown model {model_name}")
    model.eval()
    if not checkpoint:
        _logger.warning("No checkpoint given: random %s weights (seed %d)", model_name, SEED)
        init_weights(model, torch.Generator().manual_seed(SEED))
    elif model_name == "phikon":
        load_hf_vit_weights(model, _load_hf_state(checkpoint))
        _logger.info("Loaded Phikon/ViT weights from %s", checkpoint)
    else:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        load_torch_resnet50_weights(model, state)
        _logger.info("Loaded ResNet50 weights from %s", checkpoint)

    @torch.no_grad()
    def fn(images):
        x = torch.as_tensor(images).to(device, non_blocking=True)
        return model(device_normalize(x))

    fn.model = model
    return fn, FEATURE_DIMS[model_name]


def _load_hf_state(path: str):
    """A local HF snapshot directory: model.safetensors or pytorch_model.bin."""
    if not os.path.isdir(path):
        raise SystemExit(f"--checkpoint {path}: a local HF snapshot directory is needed (the "
                         "port never downloads)")
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.torch import load_file

        return load_file(st_path)
    return torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                      weights_only=True)


def extract_features(
    patch_root: str,
    output_dir: str,
    model_name: str = "phikon",
    checkpoint: str = "",
    batch_size: int = 256,
    fold: int = 0,
    k: int = 1,
    num_threads: int = 8,
    fmt: str = "npy",
    skip_existing: bool = True,
    use_pallas: bool = True,
    quant=None,
    extractor=None,
    device="cuda",
) -> dict:
    """Write one ``[n_patches, D]`` feature file per slide; returns counts
    and the host-clock rate. ``extractor``: a prebuilt (fn, dim). Under a
    process group, this rank's share of the slides."""
    from mirror_tpu_torch.data.formats import save_feature_file
    from mirror_tpu_torch.parallel import distributed

    fn, dim = extractor or build_extractor(model_name, checkpoint, use_pallas=use_pallas,
                                           quant=quant, device=device)
    slides = list_slides(patch_root)[fold::k][distributed.rank()::distributed.world_size()]
    _logger.info("%d slides (shard %d/%d, rank %d/%d)", len(slides), fold, k,
                 distributed.rank(), distributed.world_size())
    total_patches = 0
    t_start = time.time()
    for slide_name, slide_dir in slides:
        out_path = os.path.join(output_dir, slide_name.replace(os.sep, "/")) + f".{fmt}"
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        if skip_existing and os.path.exists(out_path):
            _logger.info("skip existing %s", out_path)
            continue
        patch_files = sorted(os.path.join(slide_dir, f) for f in os.listdir(slide_dir)
                             if f.lower().endswith(IMG_EXTS))
        feats = []
        t0 = time.time()
        for batch, n_valid in batched_patch_stream(patch_files, batch_size,
                                                   num_threads=num_threads):
            feats.append(fn(batch)[:n_valid].float().cpu().numpy())
        features = np.concatenate(feats) if feats else np.zeros((0, dim), np.float32)
        save_feature_file(out_path, features)
        dt = time.time() - t0
        total_patches += len(patch_files)
        _logger.info("%s: %d patches -> %s in %.1fs (%.1f patches/s)", slide_name,
                     len(patch_files), out_path, dt, len(patch_files) / max(dt, 1e-9))
    wall = time.time() - t_start
    stats = {"slides": len(slides), "patches": total_patches, "seconds": wall,
             "patches_per_sec": total_patches / max(wall, 1e-9)}
    _logger.info("Done: %s", stats)
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("patch_root", help="root dir of patch images")
    p.add_argument("output_dir")
    p.add_argument("--model", default="phikon", choices=sorted(FEATURE_DIMS))
    p.add_argument("--checkpoint", default="", help="local weights (HF dir or .pt)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--fold", type=int, default=0, help="slide shard index")
    p.add_argument("--k", type=int, default=1, help="total slide shards")
    p.add_argument("--num-threads", type=int, default=8)
    p.add_argument("--format", default="npy", choices=["npy", "pt"])
    p.add_argument("--no-skip-existing", action="store_false", dest="skip_existing")
    p.add_argument("--use-pallas", action="store_true", default=True,
                   help="the ViT half-block kernels (the default and only path; on the "
                   "CPU their plain versions)")
    p.add_argument("--no-use-pallas", action="store_false", dest="use_pallas",
                   help="the JAX tool's dense path: refused, the port has none")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="W8A8 projections with the natural-layout attention kernel")
    p.add_argument("--device", default=default_device(),
                   help="torch device; the kernels run on cuda, cpu runs their plain "
                   "versions")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from mirror_tpu_torch.parallel import distributed

    with distributed.session(None, torch.device(a.device)) as device:
        return extract_features(
            a.patch_root, a.output_dir, a.model, a.checkpoint, a.batch_size, a.fold, a.k,
            a.num_threads, a.format, a.skip_existing, a.use_pallas, a.quant, device=device)


if __name__ == "__main__":
    main()
