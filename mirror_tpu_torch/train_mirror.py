#!/usr/bin/env python
"""MIRROR pretraining entry point of the PyTorch port.

Counterpart of ``train_mirror.py`` (the JAX package's, itself the
reference's CLI), with its flags and YAML:

    python -m mirror_tpu_torch.train_mirror \\
        --config configs/pretrain/mirror.template.yaml --fold-nb 0 \\
        --wsi-feature-dir feats/ --rna-feature-csv rna.csv --split-dir splits/ \\
        --output runs/

It trains on the card (``--device cuda``, the default) through the port's
kernels, forward and backward; ``--device cpu`` or ``--no-use-pallas`` runs
their plain versions. The kernels run in the compute type of ``--amp``
(bf16, the default), ``--amp-dtype float16`` or ``--no-amp`` (float32),
as the JAX package runs its Pallas kernels; float16 takes no loss scaler,
as there. A width beyond the backward kernels (a head dim above 128 or
not a multiple of 16, a landmark count that is not a multiple of 8) is
refused at start unless ``--no-use-pallas``; the forward kernels, which
serving runs, take every width. The
optimizer side is the JAX package's (``train/optim.py``): every ``--opt``,
the timm schedules and plateau, clipping, ``--layer-decay``,
``--model-ema`` and ``--grad-accum-steps``; so is the run control
(``train/harness.py``): ``--initial-checkpoint`` (a non-strict warm start),
``--resume`` with the optimizer's state (``--no-resume-opt``,
``--start-epoch``), the SIGTERM stop and ``--recovery-interval``'s
``recovery.pth.tar``, ``--grad-checkpointing``, ``--profile``, and
``--log-wandb`` / ``--wandb-watch``. It runs data-parallel in one
process per device under ``torchrun --nproc-per-node R -m
mirror_tpu_torch.train_mirror ...`` or the ``MIRROR_COORDINATOR`` /
``MIRROR_NUM_PROCESSES`` / ``MIRROR_PROCESS_ID`` env
(``parallel/distributed.py``): ``--batch-size`` is the global batch,
``--contrastive-negatives`` picks the rank's or the global batch's
negatives, ``--optimizer-sharding`` shards the optimizer's state (ZeRO-1),
and ``--model-parallel N`` splits the wide RNA and head layers over N ranks
a data rank (``parallel/tensor_parallel.py``; the world size a multiple of
N).
Per epoch: one log line per ``--log-interval`` steps with the six loss terms,
the grad / param norms and the lr, an optional validation pass (and the
EMA's), ``summary.csv``, and the reference's ``.pth.tar`` checkpoints
(``last``, ``model_best`` and the best ``--checkpoint-hist``
``checkpoint-<epoch>``). At the end the ``--result`` JSON goes to stdout.
``--ckpt-format orbax`` and a model or loss that the port does not run are
refused at start (``config.refuse_unported``), and so are the CLIP
baseline's model and loss (``train_pretrain`` runs them).
``--initial-checkpoint`` also takes the JAX package's msgpack file
(``train/jax_checkpoint.py``).
"""

import logging
from typing import Dict

import torch

from mirror_tpu_torch.config import (
    model_kwargs_from_args,
    parse_args,
    refuse_clip_values,
    refuse_unported,
    resolve_lr,
)
from mirror_tpu_torch.data.datasets import PretrainDataset
from mirror_tpu_torch.data.loader import Loader
from mirror_tpu_torch.losses import MirrorLossWeights
from mirror_tpu_torch.parallel import distributed, tensor_parallel
from mirror_tpu_torch.registry import check_kernel_config, create_model
from mirror_tpu_torch.train import harness
from mirror_tpu_torch.train.checkpoint import load_pretrained
from mirror_tpu_torch.train.steps import make_mirror_train_step, mirror_eval_losses

_logger = logging.getLogger("train")


def loss_weights_from_args(args) -> MirrorLossWeights:
    kw = args.loss_kwargs or {}
    return MirrorLossWeights(
        alignment=float(kw.get("alignment_loss_weight", 0.5)),
        wsi_retention=float(kw.get("wsi_retention_loss_weight", 0.1)),
        rna_retention=float(kw.get("rna_retention_loss_weight", 0.1)),
        style=float(kw.get("style_loss_weight", 0.1)),
        cluster=float(kw.get("cluster_loss_weight", 0.2)),
    )


def evaluate(args, model, dataset, loss_weights, epoch, device,
             negatives: str = "local") -> Dict[str, float]:
    """The mean eval losses over the val split, the masking and VAE draws
    from the epoch's own generator (``harness.eval_generator``), not the
    train step's. Across ranks the batch is rounded up to a multiple of
    the ranks and its tail padded, and each batch is weighted by its
    global valid rows (``train_mirror.py:216-222`` of the JAX package)."""
    multi, ranks = distributed.multi(), distributed.data_size()
    batch = args.validation_batch_size or args.batch_size
    loader = Loader(dataset.val(), (batch + ranks - 1) // ranks * ranks, shuffle=False,
                    drop_last=False, pad_last=multi, seed=args.seed, workers=args.workers)
    generator = harness.eval_generator(args.seed, epoch, device)
    totals: Dict[str, float] = {}
    seen = 0
    for host_batch in loader:
        n = int(distributed.allgather_rows(host_batch["valid"]).sum()) if multi else \
            host_batch["wsi"].shape[0]
        losses = mirror_eval_losses(model, harness.to_device(host_batch, device), loss_weights,
                                    args.wsi_mask_ratio, args.rna_mask_ratio, generator,
                                    negatives)
        for k, v in losses.items():
            totals[k] = totals.get(k, 0.0) + float(v) * n
        seen += n
    dataset.train()
    return {k: v / max(seen, 1) for k, v in totals.items()}


def main(argv=None) -> Dict:
    args, args_text = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    refuse_unported(args)
    refuse_clip_values(args)
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
    model_kwargs.setdefault("wsi_num_tokens", args.num_wsi_feature_tokens)
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
    loss_weights = loss_weights_from_args(args)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    negatives = harness.contrastive_negatives(args, args.batch_size)
    train_step = make_mirror_train_step(model, optimizer, loss_weights, args.wsi_mask_ratio,
                                        args.rna_mask_ratio, generator=generator, ema=ema,
                                        watch=args.wandb_watch, negatives=negatives)
    out_dir = harness.output_dir(args, "pretrain", args_text)
    eval_fn = None
    if args.val and args.split_dir is not None:
        def eval_fn(epoch, module):
            return evaluate(args, module, dataset, loss_weights, epoch, device, negatives)
    return harness.run(args, model, train_step, loader, device, eval_fn, out_dir,
                       decreasing=True, ema=ema, lr_controller=lr_controller,
                       optimizer=optimizer, generator=generator)


if __name__ == "__main__":
    main()
