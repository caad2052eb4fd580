"""What the port's three training entry points share.

The port's counterpart of ``mirror_tpu/train/harness.py``, for one process
on one device: the device check, the run directory with ``args.yaml``, the
epoch loop (``optim.scheduled_epochs`` epochs) with its log lines,
``summary.csv`` (the epoch's mean ``lr`` among the train metrics), the
reference's ``.pth.tar`` saves (``last`` every epoch, ``model_best`` when
the eval metric improves, in the metric's direction: decreasing only for
``loss``, and the best ``--checkpoint-hist`` epochs as
``checkpoint-<epoch>``; with ``--model-ema`` each also carries
``state_dict_ema``), the EMA weights evaluated beside the live ones as
``ema_<metric>`` (which then ranks the epoch), the plateau controller's
step at each epoch boundary, the downstream evaluation gather, and the
``--result`` JSON on stdout.
"""

import csv
import json
import logging
import math
import os
import time
from datetime import datetime
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.loader import Loader
from .checkpoint import save_checkpoint_file
from .optim import PlateauController, make_optimizer, scheduled_epochs
from .steps import ModelEma

_logger = logging.getLogger("train")


def device_from_arg(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available; pass --device cpu to "
                         "train on the CPU with the kernels' plain versions")
    return device


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def output_dir(args, task: str, args_text: str) -> Optional[str]:
    """``{output}/{task}/{experiment or time-model-fold}``, with the run's
    resolved arguments in ``args.yaml``; None without ``--output``."""
    if not args.output:
        return None
    name = args.experiment or "-".join(
        [datetime.now().strftime("%Y%m%d-%H%M%S"), args.model, f"fold_{args.fold_nb}"])
    out_dir = os.path.join(args.output, task, name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "args.yaml"), "w") as f:
        f.write(args_text)
    return out_dir


def optimizer_side(args, model, loader, lr: float, decreasing: bool,
                   head_only: bool = False):
    """The optimizer over ``ceil(len(loader) / --grad-accum-steps)`` real
    updates an epoch, the plateau controller under ``--sched plateau``
    (None otherwise) and the model EMA under ``--model-ema`` (None
    otherwise), as the JAX entry points build them."""
    k = max(args.grad_accum_steps, 1)
    updates_per_epoch = max((len(loader) + k - 1) // k, 1)
    optimizer = make_optimizer(args, model, lr, head_only=head_only,
                               steps_per_epoch=updates_per_epoch)
    lr_controller = None
    if args.use_sched and args.sched == "plateau":
        lr_controller = PlateauController.from_args(args, lr, decreasing_metric=decreasing)
    ema = ModelEma(model, args.model_ema_decay, args.model_ema_warmup) if args.model_ema \
        else None
    return optimizer, lr_controller, ema


def update_summary(path: str, epoch: int, train: Dict[str, float],
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
    """One pass over the loader; the metrics are summed on the device (the
    lr, a float, on the host) and pulled to the host at log lines and once
    at the end of the epoch."""
    loader.set_epoch(epoch)
    num_batches = len(loader)
    sums: Dict[str, torch.Tensor] = {}
    count = 0
    end = time.time()
    for batch_idx, host_batch in enumerate(loader):
        metrics = train_step(to_device(host_batch, device))
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v
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


def gather_eval_outputs(eval_step: Callable, dataset, batch_size: int, args, epoch: int,
                        device, extra_keys: Sequence[str] = ()
                        ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """The downstream eval over the whole validation split: the tail batch
    padded (``pad_last``), a fresh token draw per epoch, and only the valid
    rows kept. Returns (logits, labels, {key: values for extra_keys})."""
    loader = Loader(dataset.val(), batch_size, shuffle=False, drop_last=False,
                    pad_last=True, seed=args.seed, workers=args.workers)
    loader.set_epoch(epoch)
    logits, labels = [], []
    extras = {k: [] for k in extra_keys}
    for host_batch in loader:
        keep = host_batch.pop("valid") > 0
        out = eval_step(to_device(host_batch, device)).cpu().numpy()
        logits.append(out[keep])
        labels.append(host_batch["label"][keep])
        for k in extra_keys:
            extras[k].append(host_batch[k][keep])
    dataset.train()
    return (np.concatenate(logits), np.concatenate(labels),
            {k: np.concatenate(v) for k, v in extras.items()})


class CheckpointHistory:
    """The best-k rule of the JAX package's ``CheckpointSaver.save_checkpoint``
    (``mirror_tpu/train/checkpoint.py:241-279``): a ranked epoch enters a
    list of ``checkpoint-<epoch>.pth.tar`` files sorted best first by its
    metric (a stable sort: of equal metrics the earlier epoch ranks first),
    the list is cut to ``max_history`` by dropping the worst, whose file is
    removed, and a file that falls out of the window on entry is never
    written. An unranked epoch (metric None) writes only ``last``."""

    def __init__(self, out_dir: str, max_history: int, decreasing: bool):
        self.out_dir, self.decreasing = out_dir, decreasing
        self.max_history = max(max_history, 1)
        self.files: List[Tuple[str, float]] = []

    def paths(self, epoch: int, metric: Optional[float]) -> List[str]:
        """The files to write for this epoch (after removing those that
        fell out of the window)."""
        last = os.path.join(self.out_dir, "last.pth.tar")
        if metric is None:
            return [last]
        path = os.path.join(self.out_dir, f"checkpoint-{epoch}.pth.tar")
        writes = [path, last]
        self.files.append((path, metric))
        self.files.sort(key=lambda t: t[1], reverse=not self.decreasing)
        while len(self.files) > self.max_history:
            dropped, _ = self.files.pop()
            if dropped == path:
                writes.remove(path)
            elif os.path.exists(dropped):
                os.remove(dropped)
        return writes


def save_epoch(paths: Sequence[str], model, ema, args, epoch: int,
               metric: Optional[float]) -> None:
    """The epoch's ``.pth.tar`` files, with ``state_dict_ema`` under
    ``--model-ema``."""
    saved_args = {k: v for k, v in vars(args).items() if k != "defaults"}
    ema_state = ema.module.state_dict() if ema is not None else None
    for path in paths:
        save_checkpoint_file(path, model.state_dict(), saved_args,
                             arch=args.model, epoch=epoch, metric=metric,
                             state_dict_ema=ema_state)


def run(args, model, train_step, loader, device, eval_fn: Optional[Callable],
        out_dir: Optional[str], decreasing: bool, ema=None, lr_controller=None,
        optimizer=None) -> Dict:
    """The epoch loop: train, evaluate (``eval_fn(epoch, model)``, and the
    EMA module as ``ema_<metric>``), summary, the plateau step
    (``lr_controller.step_epoch(optimizer, ...)``), checkpoints; then the
    ``--result`` JSON on stdout. A NaN eval metric (a c-index over an
    all-censored split) is logged and not ranked; so is an
    ``--eval-metric`` the epoch does not emit."""
    best_metric, best_epoch = None, None
    history = CheckpointHistory(out_dir, args.checkpoint_hist, decreasing) if out_dir else None
    for epoch in range(scheduled_epochs(args)):
        t0 = time.time()
        train_metrics = train_one_epoch(args, epoch, train_step, loader, device)
        eval_metrics = None
        if eval_fn is not None:
            eval_metrics = eval_fn(epoch, model)
            _logger.info("Eval: %d  %s", epoch,
                         " ".join(f"{k}: {v:.4f}" for k, v in eval_metrics.items()))
            if ema is not None:
                ema_metrics = eval_fn(epoch, ema.module)
                _logger.info("Eval EMA: %d  %s", epoch,
                             " ".join(f"{k}: {v:.4f}" for k, v in ema_metrics.items()))
                eval_metrics.update({f"ema_{k}": v for k, v in ema_metrics.items()})
        source = eval_metrics or train_metrics
        name = args.eval_metric
        if ema is not None and eval_metrics and f"ema_{name}" in eval_metrics:
            name = f"ema_{name}"  # the reference ranks by the EMA's metric
        metric = source.get(name)
        if metric is None:
            _logger.warning("eval metric %s not among the epoch's metrics (%s); epoch %d is "
                            "not ranked", args.eval_metric, ", ".join(source), epoch)
        elif math.isnan(metric):
            _logger.warning("eval metric %s is NaN at epoch %d; skipping ranking",
                            args.eval_metric, epoch)
            metric = None
        if out_dir:
            update_summary(os.path.join(out_dir, "summary.csv"), epoch, train_metrics,
                           eval_metrics)
        if lr_controller is not None:
            lr_controller.step_epoch(optimizer, epoch, metric)
            _logger.info("Plateau LR after epoch %d: %g", epoch, lr_controller.applied_lr)
        if out_dir:
            save_epoch(history.paths(epoch, metric), model, ema, args, epoch, metric)
        if metric is not None and (best_metric is None or (
                metric < best_metric if decreasing else metric > best_metric)):
            best_metric, best_epoch = metric, epoch
            if out_dir:
                save_epoch([os.path.join(out_dir, "model_best.pth.tar")], model, ema, args,
                           epoch, metric)
        _logger.info("Epoch %d done in %.1fs", epoch, time.time() - t0)

    results = {"best_metric": best_metric, "best_epoch": best_epoch,
               "metric_name": args.eval_metric}
    print(f"--result\n{json.dumps(results, indent=4)}", flush=True)
    return results
