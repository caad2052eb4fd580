#!/usr/bin/env python
"""MIRROR pretraining entry point of the PyTorch port.

Counterpart of ``train_mirror.py`` (the JAX package's, itself the
reference's CLI), with its flags and YAML:

    python -m mirror_tpu_torch.train_mirror \\
        --config configs/pretrain/mirror.template.yaml --fold-nb 0 \\
        --wsi-feature-dir feats/ --rna-feature-csv rna.csv --split-dir splits/ \\
        --output runs/

It trains on the card (``--device cuda``, the default) through the port's
kernels, forward and backward; ``--device cpu`` runs their plain versions.
Per epoch: one log line per ``--log-interval`` steps with the six loss terms
and the grad / param norms, an optional validation pass, ``summary.csv``,
and the reference's ``.pth.tar`` checkpoints (``last`` and
``model_best``). At the end the ``--result`` JSON goes to stdout. Flags of
the JAX entry point that the port does not implement are refused at start
when set away from their defaults (``config.refuse_unported``).
"""

import csv
import json
import logging
import os
import time
from datetime import datetime
from typing import Dict, Optional

import torch

from mirror_tpu_torch.config import parse_args, refuse_unported, resolve_lr
from mirror_tpu_torch.data.datasets import PretrainDataset
from mirror_tpu_torch.data.loader import Loader
from mirror_tpu_torch.losses import MirrorLossWeights
from mirror_tpu_torch.registry import create_model
from mirror_tpu_torch.train.checkpoint import save_checkpoint_file
from mirror_tpu_torch.train.optim import make_optimizer
from mirror_tpu_torch.train.steps import make_mirror_train_step, mirror_eval_losses

_logger = logging.getLogger("train")


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available; pass --device cpu to "
                         "train on the CPU with the kernels' plain versions")
    return device


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def loss_weights_from_args(args) -> MirrorLossWeights:
    kw = args.loss_kwargs or {}
    return MirrorLossWeights(
        alignment=float(kw.get("alignment_loss_weight", 0.5)),
        wsi_retention=float(kw.get("wsi_retention_loss_weight", 0.1)),
        rna_retention=float(kw.get("rna_retention_loss_weight", 0.1)),
        style=float(kw.get("style_loss_weight", 0.1)),
        cluster=float(kw.get("cluster_loss_weight", 0.2)),
    )


def _output_dir(args) -> Optional[str]:
    if not args.output:
        return None
    name = args.experiment or "-".join(
        [datetime.now().strftime("%Y%m%d-%H%M%S"), args.model, f"fold_{args.fold_nb}"])
    out_dir = os.path.join(args.output, "pretrain", name)
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def _update_summary(path: str, epoch: int, train: Dict[str, float],
                    evals: Optional[Dict[str, float]]) -> None:
    row = {"epoch": epoch, **{f"train_{k}": v for k, v in train.items()},
           **{f"eval_{k}": v for k, v in (evals or {}).items()}}
    header = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as f:
        writer = csv.DictWriter(f, fieldnames=list(row))
        if header:
            writer.writeheader()
        writer.writerow(row)


def train_one_epoch(args, epoch, train_step, loader, device) -> Dict[str, float]:
    """One pass over the loader; the metrics are summed on the device and
    pulled to the host at log lines and once at the end of the epoch."""
    loader.set_epoch(epoch)
    num_batches = len(loader)
    sums: Dict[str, torch.Tensor] = {}
    count = 0
    end = time.time()
    for batch_idx, host_batch in enumerate(loader):
        metrics = train_step(_to_device(host_batch, device))
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v.clone()
        count += 1
        if batch_idx % args.log_interval == 0 or batch_idx == num_batches - 1:
            vals = {k: float(v) for k, v in metrics.items()}
            rate = host_batch["wsi"].shape[0] / max(time.time() - end, 1e-9)
            _logger.info(
                "Train: %d [%4d/%d] Loss: %.4g (%.4g)  %s %.1f samples/s", epoch, batch_idx,
                num_batches, vals["loss"], float(sums["loss"]) / count,
                " ".join(f"{k}: {v:.4g}" for k, v in vals.items() if k != "loss"), rate)
        end = time.time()
    return {k: float(v) / count for k, v in sums.items()} if count else {}


def evaluate(args, model, dataset, loss_weights, generator, device) -> Dict[str, float]:
    loader = Loader(dataset.val(), args.validation_batch_size or args.batch_size,
                    shuffle=False, drop_last=False, seed=args.seed, workers=args.workers)
    totals: Dict[str, float] = {}
    seen = 0
    for host_batch in loader:
        n = host_batch["wsi"].shape[0]
        losses = mirror_eval_losses(model, _to_device(host_batch, device), loss_weights,
                                    args.wsi_mask_ratio, args.rna_mask_ratio, generator)
        for k, v in losses.items():
            totals[k] = totals.get(k, 0.0) + float(v) * n
        seen += n
    dataset.train()
    return {k: v / max(seen, 1) for k, v in totals.items()}


def main(argv=None) -> Dict:
    args, args_text = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    refuse_unported(args)
    device = _device(args.device)
    torch.manual_seed(args.seed)

    dataset = PretrainDataset(args.wsi_feature_dir, args.rna_feature_csv,
                              num_wsi_feature_tokens=args.num_wsi_feature_tokens,
                              splits=args.split_dir, k=args.k, cache=args.cache)
    dataset.update_fold_nb(args.fold_nb)

    model_kwargs = dict(args.model_kwargs or {})
    model_kwargs["rna_embed_dim"] = dataset.rna_dim
    model_kwargs.setdefault("wsi_num_tokens", args.num_wsi_feature_tokens)
    if args.amp:
        model_kwargs.setdefault("dtype", args.amp_dtype)
    model_kwargs.setdefault("pinv_grad", args.pinv_grad)
    args.model_kwargs = model_kwargs  # the checkpoint's args rebuild this model
    model = create_model(args.model, device=device,
                         generator=torch.Generator().manual_seed(args.seed), **model_kwargs)
    _logger.info("Model %s created on %s, param count: %d", args.model, device,
                 sum(p.numel() for p in model.parameters()))

    dataset.train()
    loader = Loader(dataset, args.batch_size, shuffle=True, drop_last=True, seed=args.seed,
                    workers=args.workers)
    optimizer = make_optimizer(args, model, resolve_lr(args, args.batch_size))
    loss_weights = loss_weights_from_args(args)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    train_step = make_mirror_train_step(model, optimizer, loss_weights, args.wsi_mask_ratio,
                                        args.rna_mask_ratio, generator=generator)
    out_dir = _output_dir(args)
    if out_dir:
        with open(os.path.join(out_dir, "args.yaml"), "w") as f:
            f.write(args_text)
    saved_args = {k: v for k, v in vars(args).items() if k != "defaults"}

    best_metric, best_epoch = None, None
    for epoch in range(args.epochs):
        t0 = time.time()
        train_metrics = train_one_epoch(args, epoch, train_step, loader, device)
        eval_metrics = None
        if args.val and args.split_dir is not None:
            eval_metrics = evaluate(args, model, dataset, loss_weights, generator, device)
            _logger.info("Eval: %d  %s", epoch,
                         " ".join(f"{k}: {v:.4f}" for k, v in eval_metrics.items()))
        metric = (eval_metrics or train_metrics).get(args.eval_metric)
        if out_dir:
            _update_summary(os.path.join(out_dir, "summary.csv"), epoch, train_metrics,
                            eval_metrics)
            save_checkpoint_file(os.path.join(out_dir, "last.pth.tar"), model.state_dict(),
                                 saved_args, arch=args.model, epoch=epoch, metric=metric)
        if metric is not None and (best_metric is None or metric < best_metric):
            best_metric, best_epoch = metric, epoch
            if out_dir:
                save_checkpoint_file(os.path.join(out_dir, "model_best.pth.tar"),
                                     model.state_dict(), saved_args, arch=args.model,
                                     epoch=epoch, metric=metric)
        _logger.info("Epoch %d done in %.1fs", epoch, time.time() - t0)

    results = {"best_metric": best_metric, "best_epoch": best_epoch,
               "metric_name": args.eval_metric}
    print(f"--result\n{json.dumps(results, indent=4)}", flush=True)
    return results


if __name__ == "__main__":
    main()
