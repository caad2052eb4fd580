#!/usr/bin/env python
"""Cancer-subtyping fine-tuning and linear-probe entry point of the PyTorch
port.

Counterpart of ``train_subtyping.py`` (the JAX package's, itself the
reference's CLI), with its flags and YAML:

    python -m mirror_tpu_torch.train_subtyping \\
        --config configs/subtyping/mirror.template.yaml \\
        --initial-checkpoint runs/pretrain/<run>/model_best.pth.tar \\
        --wsi-feature-dir feats/ --rna-feature-csv rna.csv --split-dir splits/ \\
        --classes LUAD LUSC --output runs/

It builds ``mirror_classifier`` (``--model mirror`` maps to it), warm-starts
it non-strict from a pretrain ``.pth.tar``, re-draws the head for the linear
probe (``--linear-probe``: only the head trains) or scales it
(``--init-head``), and trains with label-smoothed cross-entropy on the card
(``--device cuda``, the default) through the port's kernels; ``--device
cpu`` runs their plain versions. Each epoch evaluates accuracy, AUROC and
F1 (``--eval-metric-average``) over the whole validation split and saves
the reference's ``.pth.tar``, which ``tools/predict.py`` scores with. The
``--result`` JSON goes to stdout. Data-parallel runs (torchrun or the
``MIRROR_*`` env, one process per device) take the global
``--batch-size``, which must divide over the ranks after the clamp, and
``--optimizer-sharding``; every rank computes the metrics over the whole
split.
"""

import logging
from typing import Dict

import torch

from mirror_tpu_torch.config import (
    model_kwargs_from_args,
    parse_args,
    refuse_unported,
    resolve_lr,
)
from mirror_tpu_torch.data.datasets import SubtypingDataset
from mirror_tpu_torch.data.loader import Loader
from mirror_tpu_torch.parallel import distributed, tensor_parallel
from mirror_tpu_torch.registry import check_kernel_config, create_model
from mirror_tpu_torch.train import harness
from mirror_tpu_torch.train.checkpoint import load_pretrained
from mirror_tpu_torch.train.metrics import accuracy, multiclass_auroc, multiclass_f1
from mirror_tpu_torch.train.optim import reinit_head
from mirror_tpu_torch.train.steps import (
    make_classifier_eval_step,
    make_classifier_train_step,
    smoothed_xent,
)

_logger = logging.getLogger("train")


def clamp_batch_size(batch_size: int, dataset_len: int) -> int:
    """Halve the batch until it fits the dataset (the reference's
    train_subtyping.py:935-939)."""
    while batch_size > dataset_len and batch_size > 1:
        batch_size //= 2
    return batch_size


def setup(args) -> torch.device:
    """The start both downstream tasks share: parse-time refusals, logging,
    the device."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if args.model == "mirror":
        # the config default is the pretrain model; the downstream tasks
        # train the classifier
        args.model = "mirror_classifier"
    refuse_unported(args)
    device = harness.device_from_arg(args.device)
    check_kernel_config(args.model, device, **model_kwargs_from_args(args))
    return device


def build_classifier(args, dataset, num_classes: int, device) -> torch.nn.Module:
    """The classifier at the run's width, its init drawn from the seed, then
    the warm start, then the linear probe's or ``--init-head``'s head; then
    this rank's slices under ``--model-parallel``."""
    model_kwargs = model_kwargs_from_args(args)
    model_kwargs["num_classes"] = num_classes
    model_kwargs["rna_embed_dim"] = dataset.rna_dim
    if args.wsi_feature_only:
        model_kwargs.setdefault("fusion", "add")
    args.model_kwargs = model_kwargs  # the checkpoint's args rebuild this model
    generator = torch.Generator().manual_seed(args.seed)
    model = create_model(args.model, device=device, generator=generator, **model_kwargs)
    _logger.info("Model %s created on %s, param count: %d", args.model, device,
                 sum(p.numel() for p in model.parameters()))
    if args.initial_checkpoint:
        load_pretrained(model, args.initial_checkpoint)
    if args.linear_probe:
        reinit_head(model, generator, std=0.01)
        _logger.info("Linear probe: training head only")
    elif args.init_head:
        reinit_head(model, generator, scale=args.head_init_scale, bias=args.head_init_bias,
                    std=None)
    return tensor_parallel.shard_model(model)


def train_loader_and_optimizer(args, dataset, model):
    """The train loader (``clamp_batch_size``; ``--no-drop-last`` pads the
    tail batch and the loss masks it by ``valid``; ``--weighted-sampler``
    draws class-balanced) and the optimizer side (``harness.optimizer_side``)
    over every parameter, or over the head alone under ``--linear-probe``.
    Returns (loader, (optimizer, plateau controller, EMA), batch)."""
    dataset.train()
    batch_size = clamp_batch_size(args.batch_size, len(dataset))
    distributed.refuse_indivisible(batch_size, shrinkable=True)
    loader = Loader(dataset, batch_size, shuffle=not args.weighted_sampler,
                    drop_last=args.drop_last, pad_last=not args.drop_last,
                    weighted=args.weighted_sampler, seed=args.seed, workers=args.workers)
    side = harness.optimizer_side(args, model, loader, resolve_lr(args, batch_size),
                                  decreasing=args.eval_metric == "loss",
                                  head_only=args.linear_probe)
    return loader, side, batch_size


def main(argv=None) -> Dict:
    args, args_text = parse_args(argv, task="subtyping")
    device = setup(args)
    with distributed.session(args, device) as device:
        return train(args, args_text, device)


def train(args, args_text: str, device: torch.device) -> Dict:
    """The run on this rank's ``device`` (one process, or one rank of a
    process group)."""
    torch.manual_seed(args.seed)
    if not args.classes:
        raise SystemExit("subtyping needs --classes")
    dataset = SubtypingDataset(args.wsi_feature_dir, args.rna_feature_csv,
                               classes=args.classes,
                               num_wsi_feature_tokens=args.num_wsi_feature_tokens,
                               splits=args.split_dir, k=args.k,
                               wsi_feature_only=args.wsi_feature_only, cache=args.cache)
    dataset.update_fold_nb(args.fold_nb)
    num_classes = args.num_classes or len(args.classes)
    if num_classes != len(args.classes):
        raise SystemExit(f"--num-classes {num_classes} != {len(args.classes)} --classes")

    model = build_classifier(args, dataset, num_classes, device)
    loader, (optimizer, lr_controller, ema), batch_size = train_loader_and_optimizer(
        args, dataset, model)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    train_step = make_classifier_train_step(
        model, optimizer, smoothing=args.smoothing or 0.0, wsi_only=args.wsi_feature_only,
        generator=generator, ema=ema, watch=args.wandb_watch)
    avg = args.eval_metric_average

    def eval_fn(epoch, module):
        logits, labels, _ = harness.gather_eval_outputs(
            make_classifier_eval_step(module, args.wsi_feature_only), dataset,
            args.validation_batch_size or batch_size, args, epoch, device)
        loss = float(smoothed_xent(torch.from_numpy(logits), torch.from_numpy(labels)))
        return {"loss": loss, "acc": accuracy(logits, labels),
                "auc": multiclass_auroc(logits, labels, average=avg),
                "f1": multiclass_f1(logits, labels, average=avg)}

    out_dir = harness.output_dir(args, "subtyping", args_text)
    return harness.run(args, model, train_step, loader, device,
                       eval_fn if args.val else None, out_dir,
                       decreasing=args.eval_metric == "loss", ema=ema,
                       lr_controller=lr_controller, optimizer=optimizer, generator=generator)


if __name__ == "__main__":
    main()
