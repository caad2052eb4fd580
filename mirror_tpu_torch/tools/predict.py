#!/usr/bin/env python
"""Batch inference from a trained downstream checkpoint to a CSV.

Counterpart of ``mirror_tpu/tools/predict.py``, with the same CLI and CSV
columns, reading the reference's ``.pth.tar`` payload:

    python -m mirror_tpu_torch.tools.predict --checkpoint model_best.pth.tar \\
        --task subtyping --wsi-feature-dir feats/ --rna-feature-csv rna.csv \\
        --output predictions.csv --device cuda

The model is rebuilt from the checkpoint's embedded run args. Output columns:
``slide_id`` plus ``pred`` and per-class ``prob_{i}`` softmax probabilities
(subtyping) or the ``risk`` score -sum(cumprod(1 - hazards)) (survival).
Slides are every feature file in the directory (or in its class
subdirectories); RNA rows are matched by the 15-char "Sample ID" prefix.
Each slide is scored on ``num_wsi_feature_tokens`` patches drawn with the
same numpy generator as the JAX tool, so the two CSVs agree row for row;
``--whole-slide`` scores EVERY patch instead: the WSI encoder runs as
``parallel/context_parallel.py::transmil_encode_cp`` and its cls row feeds
the fusion and head (``MIRRORClassifier.head_from_wsi``).

Under a process group (``torchrun --nproc-per-node R -m
mirror_tpu_torch.tools.predict ...``, or the ``MIRROR_*`` env of
``parallel/distributed.py``), as on the JAX tool's multi-device mesh: the
batch is rounded up to a multiple of the ranks and each rank scores its
block of every batch, the pinv's scale taken over the whole batch
(``ops/pinv.py::GlobalScale``); with ``--whole-slide`` every rank encodes
each slide together, its tokens split over the ranks. Rank 0 gathers the
rows and writes the CSV.
"""

import argparse
import logging
import os
from typing import Optional

import numpy as np
import pandas as pd
import torch

from mirror_tpu_torch.data.formats import list_feature_files, load_feature_file
from mirror_tpu_torch.parallel import distributed
from mirror_tpu_torch.parallel.context_parallel import transmil_encode_cp, wrap_pad_square
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args as _run_args
from mirror_tpu_torch.train.steps import survival_risk
from mirror_tpu_torch.utils.platform import default_device

_logger = logging.getLogger("predict")


def _rebuild_model(payload, rna_dim, task, device, use_pallas=None):
    run_args = _run_args(payload)
    model_name = payload.get("arch") or run_args.get("model", "mirror_classifier")
    mk = dict(run_args.get("model_kwargs") or {})
    if task == "survival":
        mk["num_classes"] = run_args.get("num_bins") or run_args.get("num_classes", 4)
    else:
        # train_subtyping: num_classes = args.num_classes or len(args.classes)
        mk["num_classes"] = (
            run_args.get("num_classes")
            or len(run_args.get("classes") or [])
            or mk.get("num_classes", 2)
        )
    if rna_dim is not None:
        mk["rna_embed_dim"] = rna_dim
    if run_args.get("amp", True):
        mk.setdefault("dtype", run_args.get("amp_dtype", "bfloat16"))
    if run_args.get("wsi_feature_only"):
        mk.setdefault("fusion", "add")
    # the flag, where given, over the training run's choice; else the run's,
    # and the kernels on a checkpoint that does not say
    if use_pallas is not None:
        mk["use_pallas"] = use_pallas
    mk.setdefault("use_pallas", True)
    model = create_model(model_name, device=device, **mk)
    num_tokens = int(run_args.get("num_wsi_feature_tokens", 2048))
    wsi_only = bool(run_args.get("wsi_feature_only", False))
    return model, num_tokens, wsi_only


def _list_slides(wsi_feature_dir, rna_df, wsi_only):
    files = [os.path.join(wsi_feature_dir, f) for f in list_feature_files(wsi_feature_dir)]
    if not files:
        # subtyping cohorts live in a class layout ({root}/{class}/{slide})
        for sub in sorted(os.listdir(wsi_feature_dir)):
            subdir = os.path.join(wsi_feature_dir, sub)
            if os.path.isdir(subdir):
                files += [os.path.join(subdir, f) for f in list_feature_files(subdir)]
    if rna_df is not None and not wsi_only:
        kept = [f for f in files if os.path.basename(f).split(".")[0][:15] in rna_df.index]
        if len(kept) < len(files):
            _logger.warning("%d slides have no RNA row; skipped", len(files) - len(kept))
        files = kept
    if not files:
        raise SystemExit(f"no usable feature files under {wsi_feature_dir}")
    return files


@torch.no_grad()
def predict(
    checkpoint: str,
    task: str,
    wsi_feature_dir: str,
    output: str,
    rna_feature_csv: str = "",
    batch_size: int = 16,
    use_ema: bool = False,
    seed: int = 42,
    whole_slide: bool = False,
    device: str = "cuda",
    use_pallas: Optional[bool] = None,
) -> list:
    """Score every slide under ``wsi_feature_dir`` on ``device`` and write
    the CSV (rank 0). Returns the rows (on every rank). On the card the
    kernels run unless ``use_pallas`` is False, or is None and the
    checkpoint was trained with them off. They run in the checkpoint's
    compute type (its args' ``amp`` and ``amp_dtype``: bf16, float16 or,
    with ``amp: false``, float32) at every width the JAX package serves
    (embed 1536: 8 heads of 192, 768 landmarks; embed 792: 99, 396). The
    process group, where the env asks for one, lasts the call
    (``distributed.session``)."""
    payload = load_checkpoint_file(checkpoint)
    state_dict = payload.get("state_dict_ema") if use_ema else None
    if use_ema and not state_dict:
        _logger.warning(
            "--use-ema requested but the checkpoint has no state_dict_ema; "
            "scoring the raw state_dict"
        )
    if not state_dict:
        state_dict = payload["state_dict"]

    rna_df = None
    rna_dim = None
    if rna_feature_csv:
        rna_df = pd.read_csv(rna_feature_csv, index_col=0)
        rna_df.index = [str(i)[:15] for i in rna_df.index]
        rna_df = rna_df.loc[~rna_df.index.duplicated(keep="first")]
        rna_dim = rna_df.shape[1]

    with distributed.session(None, torch.device(device)) as device:
        model, num_tokens, wsi_only = _rebuild_model(payload, rna_dim, task, device,
                                                     use_pallas)
        model.load_state_dict(state_dict)
        if rna_df is None and not wsi_only:
            raise SystemExit(
                "this checkpoint's model fuses RNA (wsi_feature_only was off at "
                "training time) — pass --rna-feature-csv"
            )
        files = _list_slides(wsi_feature_dir, rna_df, wsi_only)
        ranks = distributed.world_size()
        if not whole_slide and batch_size % ranks:
            batch_size = -(-batch_size // ranks) * ranks
            _logger.info("rounded batch size up to %d (multiple of %d ranks)", batch_size, ranks)
        rows = _score(model, task, files, rna_df, wsi_only, num_tokens, batch_size, seed,
                      whole_slide, device)
        if distributed.is_main():  # inside: the session may destroy the group it made
            pd.DataFrame(rows).to_csv(output, index=False)
            _logger.info("wrote %d predictions -> %s", len(rows), output)
    return rows


def _score(model, task, files, rna_df, wsi_only, num_tokens, batch_size, seed, whole_slide,
           device) -> list:
    """The CSV's rows. Every rank reads every slide of a batch, so the token
    draws are one stream; each rank then scores its block of the batch (the
    blocks gathered), or with ``whole_slide`` every rank encodes each slide
    together and scores the batch's cls rows alike."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(0, len(files), batch_size):
        chunk = files[i : i + batch_size]
        wsi, rna = [], []
        for f in chunk:
            feats = np.asarray(load_feature_file(f), np.float32)
            if whole_slide:
                tokens = torch.from_numpy(np.array(wrap_pad_square(feats))).to(device)
                wsi.append(transmil_encode_cp(model.wsi_encoder, tokens)[0].float())
            else:
                idx = rng.choice(feats.shape[0], num_tokens, replace=feats.shape[0] < num_tokens)
                wsi.append(torch.from_numpy(feats[idx]))
            if rna_df is not None and not wsi_only:
                sid = os.path.basename(f).split(".")[0][:15]
                rna.append(torch.from_numpy(rna_df.loc[sid].to_numpy(np.float32)))
        n_valid = len(chunk)
        if whole_slide:
            rna_t = torch.stack(rna).to(device) if rna else None
            logits = model.head_from_wsi(torch.stack(wsi), rna_t).float().cpu()
        else:
            if n_valid < batch_size:  # keep one batch shape: repeat the last slide
                wsi += [wsi[-1]] * (batch_size - n_valid)
                if rna:
                    rna += [rna[-1]] * (batch_size - n_valid)
            wsi_t = distributed.own_rows(torch.stack(wsi)).to(device)
            rna_t = distributed.own_rows(torch.stack(rna)).to(device) if rna else None
            logits = model(wsi_t, rna_t).float().cpu()
            logits = torch.from_numpy(distributed.allgather_rows(logits.numpy()))[:n_valid]
        risks = survival_risk(logits) if task == "survival" else None
        for j, (f, lg) in enumerate(zip(chunk, logits.numpy())):
            sid = os.path.basename(f).split(".")[0]
            if task == "survival":
                rows.append({"slide_id": sid, "risk": float(risks[j])})
            else:
                p = np.exp(lg - lg.max())
                p = p / p.sum()
                row = {"slide_id": sid, "pred": int(np.argmax(p))}
                row.update({f"prob_{c}": float(v) for c, v in enumerate(p)})
                rows.append(row)
        _logger.info("scored %d/%d slides", min(i + batch_size, len(files)), len(files))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--task", required=True, choices=["subtyping", "survival"])
    p.add_argument("--wsi-feature-dir", required=True)
    p.add_argument("--rna-feature-csv", default="")
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--use-ema", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--whole-slide", action="store_true", default=False,
                   help="score EVERY patch (the context-parallel whole-slide encoder) "
                   "instead of the training-time token subsample")
    p.add_argument("--device", default=default_device(),
                   help="torch device; the kernels run on cuda, cpu runs "
                   "their plain versions")
    p.add_argument("--use-pallas", action="store_true", default=None,
                   help="the CUDA kernels on a CUDA device (the default, unless the "
                   "checkpoint was trained with --no-use-pallas)")
    p.add_argument("--no-use-pallas", action="store_false", dest="use_pallas",
                   help="the plain path on any device (the default for a checkpoint "
                   "trained with it)")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    predict(a.checkpoint, a.task, a.wsi_feature_dir, a.output, a.rna_feature_csv,
            a.batch_size, a.use_ema, a.seed, whole_slide=a.whole_slide, device=a.device,
            use_pallas=a.use_pallas)


if __name__ == "__main__":
    main()
