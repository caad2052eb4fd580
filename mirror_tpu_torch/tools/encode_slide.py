#!/usr/bin/env python
"""Whole-slide embedding: encode EVERY patch of each slide with the
pretrained TransMIL WSI encoder, no 2048-token subsample.

Counterpart of ``mirror_tpu/tools/encode_slide.py``, with its flags and a
``--device`` (default ``cuda``) and ``--no-use-pallas``:

    python -m mirror_tpu_torch.tools.encode_slide --wsi-feature-dir feats/ \\
        --checkpoint last.pth.tar --output slide_embeddings/ \\
        [--save cls|full] --dtype bfloat16
    torchrun --nproc-per-node R -m mirror_tpu_torch.tools.encode_slide ...

With one process a slide is encoded on one device. Under a process group
(torchrun's env, or ``MIRROR_COORDINATOR`` / ``MIRROR_NUM_PROCESSES`` /
``MIRROR_PROCESS_ID``: ``parallel/distributed.py``) every rank encodes
each slide together, the token axis of each attention split over the
ranks (``parallel/context_parallel.py``), and rank 0 writes the files.

The checkpoint is the port's ``.pth.tar``: a pretrain state dict with
``wsi_encoder.*`` keys, or the encoder's keys at the top level. On the card
the kernels run in either ``--dtype`` (float32, the JAX tool's default, or
bfloat16) at every width (embed 1536: 8 heads of 192, 768 landmarks);
``--no-use-pallas`` runs the plain path.
"""

import argparse
import logging
import os

import numpy as np
import torch

from mirror_tpu_torch.data.formats import list_feature_files, load_feature_file
from mirror_tpu_torch.models.nystrom import kernel_refusal
from mirror_tpu_torch.models.transmil import FeatureTransMIL
from mirror_tpu_torch.parallel import distributed
from mirror_tpu_torch.parallel.context_parallel import transmil_encode_cp, wrap_pad_square
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file
from mirror_tpu_torch.utils.platform import default_device

_logger = logging.getLogger("encode_slide")
HEADS = 8  # the port's TransLayer: 8 heads of embed / 8


def wsi_encoder_state(checkpoint_path: str) -> dict:
    """The WSI encoder's tensors: ``wsi_encoder.*`` of a pretrain or
    downstream state dict (the prefix dropped), or the encoder's keys at
    the top level."""
    state = load_checkpoint_file(checkpoint_path)["state_dict"]
    prefix = "wsi_encoder."
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if "_fc1.0.weight" in state:
        return state
    raise SystemExit(f"checkpoint {checkpoint_path} has no wsi_encoder params "
                     f"(top-level keys: {sorted(state)[:8]})")


def refuse_kernel_path(state: dict, dtype: torch.dtype, use_pallas: bool,
                       device: torch.device) -> None:
    """On the card with the kernels, refuse by name what the forward
    kernels do not take (``models/nystrom.py::kernel_refusal``: float64,
    at any width), before any slide is read."""
    if device.type != "cuda" or not use_pallas:
        return
    embed = state["_fc1.0.weight"].shape[0]
    why = kernel_refusal(embed // HEADS, embed // 2, dtype)
    if why:
        raise SystemExit(f"the Nystrom attention's CUDA kernels do not take {why}: pass "
                         "--no-use-pallas for the plain path")


def build_encoder(state: dict, dtype: torch.dtype, use_pallas: bool,
                  device: torch.device) -> FeatureTransMIL:
    """A FeatureTransMIL of the state's widths in eval mode on ``device``,
    its weights ``state``'s."""
    embed, input_dim = state["_fc1.0.weight"].shape
    with torch.device("meta"):
        encoder = FeatureTransMIL(input_dim, embed, dtype, dropout=0.0, use_pallas=use_pallas)
    encoder = encoder.to_empty(device=device).eval()
    missing = sorted(set(encoder.state_dict()) - set(state))
    if missing:
        raise SystemExit(f"the checkpoint lacks the encoder's {missing[:8]}")
    encoder.load_state_dict({k: state[k] for k in encoder.state_dict()})
    return encoder


@torch.no_grad()
def encode_slides(args, encoder: FeatureTransMIL, device: torch.device) -> int:
    """Encode every slide under ``args.wsi_feature_dir``; returns how many
    were encoded (rank 0 writes them)."""
    os.makedirs(args.output, exist_ok=True)
    files = list_feature_files(args.wsi_feature_dir)
    _logger.info("encoding %d slides over %d rank(s) (whole-slide, no subsampling)",
                 len(files), distributed.world_size())
    done = 0
    for fname in files:
        slide_id = fname.split(".")[0]
        out_path = os.path.join(args.output, slide_id + ".npy")
        if args.skip_existing and os.path.exists(out_path):
            continue
        feats = np.asarray(load_feature_file(os.path.join(args.wsi_feature_dir, fname)),
                           np.float32)
        n_real = feats.shape[0]
        tokens = torch.from_numpy(np.array(wrap_pad_square(feats))).to(device)
        out = transmil_encode_cp(encoder, tokens).float().cpu().numpy()
        # rows: [0] cls, [1 : n_real + 1] the real patches, then the wrap
        # pad's repeats (appended last): trimmed, so 'full' rows map 1:1
        # onto the slide's patches
        if distributed.is_main():
            np.save(out_path, out[0] if args.save == "cls" else out[: n_real + 1])
        done += 1
        if done % 25 == 0:
            _logger.info("%d slides encoded", done)
    _logger.info("done: %d slides -> %s", done, args.output)
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wsi-feature-dir", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--save", choices=["cls", "full"], default="cls",
                   help="'cls': [D] slide embedding; 'full': [1+n, D] normed sequence (cls "
                   "row 0, then one row per REAL patch: the wrap-pad rows are trimmed)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype; the kernels on the card take either")
    p.add_argument("--heads", type=int, default=HEADS,
                   help=f"attention heads: the encoder's {HEADS} (any other is refused)")
    p.add_argument("--skip-existing", action="store_true", default=True)
    p.add_argument("--no-skip-existing", dest="skip_existing", action="store_false")
    p.add_argument("--device", default=default_device(),
                   help="torch device; the kernels run on cuda, cpu runs their plain versions")
    p.add_argument("--use-pallas", action="store_true", default=True,
                   help="the CUDA kernels on a CUDA device (the default)")
    p.add_argument("--no-use-pallas", action="store_false", dest="use_pallas",
                   help="the plain path on any device")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.heads != HEADS:
        raise SystemExit(f"--heads {args.heads}: the port's TransMIL encoder has {HEADS} heads")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    state = wsi_encoder_state(args.checkpoint)
    refuse_kernel_path(state, dtype, args.use_pallas, device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available; pass --device cpu to "
                         "encode on the CPU with the kernels' plain versions")
    with distributed.session(None, device) as device:
        encode_slides(args, build_encoder(state, dtype, args.use_pallas, device), device)
    return 0


if __name__ == "__main__":
    main()
