#!/usr/bin/env python
"""CLIP-baseline pretraining entry point of the PyTorch port.

Counterpart of ``train_pretrain.py`` (the JAX package's), with the pretrain
flags and YAML:

    python -m mirror_tpu_torch.train_pretrain \\
        --config configs/pretrain/mirror.template.yaml --fold-nb 0 \\
        --wsi-feature-dir feats/ --rna-feature-csv rna.csv --split-dir splits/ \\
        --output runs/

It trains ``mirror_dual`` (``--model mirror``, the template's, maps to it):
the FeatureTransMIL cls vector and the TransFormer RNA vector, each
projected, under InfoNCE over the batch's own negatives at
``--temperature`` (the JAX CLI's loss whatever ``--loss`` says). It runs on
the card (``--device cuda``, the default) through the port's kernels, or
with ``--device cpu`` on their plain versions; the optimizer side is
``train/optim.py``'s and the run control (warm start, resume, recovery,
activation checkpointing, profiler, wandb) ``train_mirror``'s. Per epoch: the train log lines (loss, grad / param
norms, lr), a validation pass over the whole val split (the tail batch
padded and masked, the loss weighted by the valid rows, a fresh token draw
each epoch) and the EMA's beside it under ``--model-ema``, ``summary.csv``
and the reference's ``.pth.tar`` checkpoints ranked by the eval loss; the
``--result`` JSON goes to stdout. Data-parallel runs (torchrun or the
``MIRROR_*`` env, one process per device) take ``train_mirror``'s flags:
the global ``--batch-size``, ``--contrastive-negatives`` (InfoNCE over the
rank's or the global batch's rows) and ``--optimizer-sharding``.
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
from mirror_tpu_torch.data.datasets import PretrainDataset
from mirror_tpu_torch.data.loader import Loader
from mirror_tpu_torch.parallel import distributed, tensor_parallel
from mirror_tpu_torch.registry import check_kernel_config, create_model
from mirror_tpu_torch.train import harness
from mirror_tpu_torch.train.checkpoint import load_pretrained
from mirror_tpu_torch.train.steps import make_clip_eval_step, make_clip_train_step

_logger = logging.getLogger("train")


def evaluate(args, model, dataset, batch_size: int, epoch: int, device,
             negatives: str = "local") -> Dict[str, float]:
    """The mean eval loss over the valid rows of the whole val split (across
    ranks the batch rounded up to a multiple of the ranks, each weighted by
    its global valid rows)."""
    ranks = distributed.data_size()
    loader = Loader(dataset.val(), (batch_size + ranks - 1) // ranks * ranks, shuffle=False,
                    drop_last=False, pad_last=True, seed=args.seed, workers=args.workers)
    loader.set_epoch(epoch)
    eval_step = make_clip_eval_step(model, temperature=args.temperature, negatives=negatives)
    total, seen = 0.0, 0
    for host_batch in loader:
        n_valid = int(distributed.allgather_rows(host_batch["valid"]).sum())
        total += float(eval_step(harness.to_device(host_batch, device))["loss"]) * n_valid
        seen += n_valid
    dataset.train()
    return {"loss": total / max(seen, 1)}


def main(argv=None) -> Dict:
    args, args_text = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if args.model == "mirror":
        args.model = "mirror_dual"
    refuse_unported(args)
    device = harness.device_from_arg(args.device)
    check_kernel_config(args.model, device, **model_kwargs_from_args(args))
    with distributed.session(args, device) as device:
        return train(args, args_text, device)


def train(args, args_text: str, device: torch.device) -> Dict:
    """The run on this rank's ``device`` (one process, or one rank of a
    process group)."""
    distributed.refuse_indivisible(args.batch_size)
    torch.manual_seed(args.seed)

    dataset = PretrainDataset(args.wsi_feature_dir, args.rna_feature_csv,
                              num_wsi_feature_tokens=args.num_wsi_feature_tokens,
                              splits=args.split_dir, k=args.k, cache=args.cache)
    dataset.update_fold_nb(args.fold_nb)

    model_kwargs = model_kwargs_from_args(args)
    model_kwargs["rna_embed_dim"] = dataset.rna_dim
    args.model_kwargs = model_kwargs  # the checkpoint's args rebuild this model
    model = create_model(args.model, device=device,
                         generator=torch.Generator().manual_seed(args.seed), **model_kwargs)
    _logger.info("Model %s created on %s, param count: %d", args.model, device,
                 sum(p.numel() for p in model.parameters()))
    if args.initial_checkpoint:
        load_pretrained(model, args.initial_checkpoint)
    tensor_parallel.shard_model(model)

    dataset.train()
    loader = Loader(dataset, args.batch_size, shuffle=True, drop_last=True, seed=args.seed,
                    workers=args.workers)
    optimizer, lr_controller, ema = harness.optimizer_side(
        args, model, loader, resolve_lr(args, args.batch_size), decreasing=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    negatives = harness.contrastive_negatives(args, args.batch_size)
    train_step = make_clip_train_step(model, optimizer, temperature=args.temperature,
                                      generator=generator, ema=ema, watch=args.wandb_watch,
                                      negatives=negatives)
    out_dir = harness.output_dir(args, "pretrain_clip", args_text)
    eval_fn = None
    if args.val and args.split_dir is not None:
        val_batch = args.validation_batch_size or args.batch_size

        def eval_fn(epoch, module):
            return evaluate(args, module, dataset, val_batch, epoch, device, negatives)
    return harness.run(args, model, train_step, loader, device, eval_fn, out_dir,
                       decreasing=True, ema=ema, lr_controller=lr_controller,
                       optimizer=optimizer, generator=generator)


if __name__ == "__main__":
    main()
