#!/usr/bin/env python
"""Survival-prediction fine-tuning entry point of the PyTorch port.

Counterpart of ``train_survival.py`` (the JAX package's, itself the
reference's CLI), with its flags and YAML:

    python -m mirror_tpu_torch.train_survival \\
        --config configs/survival/mirror.template.yaml --pinv-grad exact \\
        --wsi-feature-dir feats/ --rna-feature-csv rna.csv \\
        --survival-csv survival.csv --split-dir splits/ --output runs/

Discrete-time survival over ``--num-bins`` quantile bins: the classifier is
built, warm-started and given its head as ``train_subtyping`` does, and
trains with ``nll_surv`` (``--loss-alpha``) or ``ce_surv`` on the card
(``--device cuda``, the default) or, with ``--device cpu``, on the kernels'
plain versions. Each epoch evaluates the loss and the censored
concordance index of risk = -sum_t S(t) over the whole validation split
and saves the reference's ``.pth.tar``; the ``--result`` JSON goes to
stdout. Data-parallel runs as ``train_subtyping``'s: the c-index is the
whole split's on every rank.
"""

import logging
from typing import Dict

import torch

from mirror_tpu_torch.config import parse_args
from mirror_tpu_torch.data.datasets import SurvivalDataset
from mirror_tpu_torch.parallel import distributed
from mirror_tpu_torch.train import harness
from mirror_tpu_torch.train.metrics import concordance_index_censored
from mirror_tpu_torch.train.steps import (
    make_survival_eval_step,
    make_survival_train_step,
    survival_loss,
    survival_risk,
)
from mirror_tpu_torch.train_subtyping import build_classifier, setup, train_loader_and_optimizer

_logger = logging.getLogger("train")


def main(argv=None) -> Dict:
    args, args_text = parse_args(argv, task="survival")
    device = setup(args)
    with distributed.session(args, device) as device:
        return train(args, args_text, device)


def train(args, args_text: str, device: torch.device) -> Dict:
    """The run on this rank's ``device`` (one process, or one rank of a
    process group)."""
    torch.manual_seed(args.seed)
    dataset = SurvivalDataset(args.wsi_feature_dir, args.rna_feature_csv, args.survival_csv,
                              num_wsi_feature_tokens=args.num_wsi_feature_tokens,
                              splits=args.split_dir, k=args.k, num_bins=args.num_bins,
                              wsi_feature_only=args.wsi_feature_only, cache=args.cache)
    dataset.update_fold_nb(args.fold_nb)
    if args.num_classes != args.num_bins:
        raise SystemExit(f"--num-classes {args.num_classes} must equal --num-bins "
                         f"{args.num_bins}")

    model = build_classifier(args, dataset, args.num_bins, device)
    loader, (optimizer, lr_controller, ema), batch_size = train_loader_and_optimizer(
        args, dataset, model)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    train_step = make_survival_train_step(
        model, optimizer, loss_name=args.loss, loss_alpha=args.loss_alpha,
        wsi_only=args.wsi_feature_only, generator=generator, ema=ema, watch=args.wandb_watch)

    def eval_fn(epoch, module):
        logits, labels, extras = harness.gather_eval_outputs(
            make_survival_eval_step(module, args.wsi_feature_only), dataset,
            args.validation_batch_size or batch_size, args, epoch, device,
            extra_keys=("event_time", "censorship"))
        batch = {"label": torch.from_numpy(labels),
                 "censorship": torch.from_numpy(extras["censorship"])}
        loss = float(survival_loss(args.loss, torch.from_numpy(logits), batch,
                                   args.loss_alpha))
        risks = survival_risk(logits).numpy()
        try:
            cindex = concordance_index_censored(extras["censorship"].astype(bool),
                                                extras["event_time"], risks,
                                                tied_tol=1e-8)[0]
        except ValueError as e:
            _logger.warning("c-index undefined this epoch: %s", e)
            cindex = float("nan")
        return {"loss": loss, "c-index": cindex}

    out_dir = harness.output_dir(args, "survival", args_text)
    return harness.run(args, model, train_step, loader, device,
                       eval_fn if args.val else None, out_dir,
                       decreasing=args.eval_metric == "loss", ema=ema,
                       lr_controller=lr_controller, optimizer=optimizer, generator=generator)


if __name__ == "__main__":
    main()
