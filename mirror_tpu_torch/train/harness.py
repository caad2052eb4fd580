"""What the port's training entry points share.

The port's counterpart of ``mirror_tpu/train/harness.py``, for one process
or for a process group of one process per device
(``parallel/distributed.py``): the device check, the run directory with
``args.yaml``, the
epoch loop (``optim.scheduled_epochs`` epochs) with its log lines,
``summary.csv`` (the epoch's mean ``lr`` among the train metrics), the
reference's ``.pth.tar`` saves (``last`` every epoch, ``model_best`` when
the eval metric improves, in the metric's direction: decreasing only for
``loss``, and the best ``--checkpoint-hist`` epochs as
``checkpoint-<epoch>``; with ``--model-ema`` each also carries
``state_dict_ema``), the EMA weights evaluated beside the live ones as
``ema_<metric>`` (which then ranks the epoch), the plateau controller's
step at each epoch boundary, the downstream evaluation gather, and the
``--result`` JSON on stdout. The run control of the JAX harness is here
too: ``--resume`` (with ``--no-resume-opt`` and ``--start-epoch``) from the
run's state in the checkpoint, the SIGTERM stop with its synchronous
``recovery.pth.tar`` and ``--recovery-interval``'s, ``--profile``'s
``torch.profiler`` trace of one epoch, and wandb (``--log-wandb``, with the
``--wandb-watch`` stats routed there only).

Across ranks, rank 0 alone owns the run directory: ``args.yaml``,
``summary.csv``, the checkpoints, wandb and the ``--result`` JSON (as the
JAX ``common_setup`` gates them on process 0); every rank logs, evaluates
and enters each save, since a ZeRO-1 optimizer gathers its state from all
of them before rank 0 writes. The downstream eval gathers the ranks'
logits, labels and extras in rank order, so every rank computes the same
global metrics. A SIGTERM stop is agreed at each batch boundary (one MAX
all-reduce of the flag): every rank stops at the same batch and enters the
recovery save.
"""

import contextlib
import csv
import json
import logging
import math
import os
import shutil
import signal
import time
from datetime import datetime
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.loader import Loader
from ..parallel import distributed, tensor_parallel
from .checkpoint import resume_checkpoint, save_checkpoint_file
from .optim import PlateauController, fast_forward_schedule, make_optimizer, scheduled_epochs
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


def contrastive_negatives(args, batch_size: int) -> str:
    """``--contrastive-negatives`` as the JAX CLIs take it
    (``train_mirror.py:159-176``): ``local`` (each rank's own rows, the
    reference's DDP semantics) or ``global``, the same thing with one
    process; a warning where a rank's block has fewer than 2 rows."""
    n = distributed.data_size()
    if args.contrastive_negatives == "local" and n > 1:
        _logger.info("contrastive loss: per-rank LOCAL negatives (parity mode)")
        if batch_size // n < 2:
            _logger.warning(
                "local negatives with %d sample/rank: the in-rank contrastive term is "
                "degenerate (a 1-row batch has no negatives, loss==0, as in reference DDP "
                "at per-rank batch 1); raise --batch-size or use --contrastive-negatives "
                "global", batch_size // n)
    return args.contrastive_negatives


def output_dir(args, task: str, args_text: str) -> Optional[str]:
    """``{output}/{task}/{experiment or time-model-fold}``, with the run's
    resolved arguments in ``args.yaml``; None without ``--output`` and on
    every rank but 0."""
    if not args.output or not distributed.is_main():
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


def train_one_epoch(args, epoch, train_step, loader, device,
                    stop_requested: Callable[[], bool] = lambda: False,
                    save_recovery: Optional[Callable[[int, int], None]] = None
                    ) -> Dict[str, float]:
    """One pass over the loader; the metrics are summed on the device (the
    lr, a float, on the host) and pulled to the host at log lines and once
    at the end of the epoch. The ``watch/*`` metrics (``--wandb-watch``)
    stay out of the log line. The pass stops before the next batch once
    ``stop_requested()`` (which the ranks agree on); every
    ``--recovery-interval`` batches
    ``save_recovery(epoch, batch_idx)`` writes the recovery file."""
    loader.set_epoch(epoch)
    num_batches = len(loader)
    recovery_interval = getattr(args, "recovery_interval", 0) or 0
    sums: Dict[str, torch.Tensor] = {}
    count = 0
    end = time.time()
    for batch_idx, host_batch in enumerate(loader):
        if stop_requested():
            _logger.warning("preemption: stopping epoch %d at batch %d", epoch, batch_idx)
            break
        metrics = train_step(to_device(host_batch, device))
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v
        count += 1
        if batch_idx % args.log_interval == 0 or batch_idx == num_batches - 1:
            vals = {k: float(v) for k, v in metrics.items() if not k.startswith("watch/")}
            rate = host_batch["wsi"].shape[0] * distributed.data_size() / \
                max(time.time() - end, 1e-9)
            _logger.info(
                "Train: %d [%4d/%d] Loss: %.4g (%.4g)  %s %.1f samples/s", epoch, batch_idx,
                num_batches, vals["loss"], float(sums["loss"]) / count,
                " ".join(f"{k}: {v:.4g}" for k, v in vals.items() if k != "loss"), rate)
        if save_recovery is not None and recovery_interval and \
                (batch_idx + 1) % recovery_interval == 0:
            save_recovery(epoch, batch_idx)
        end = time.time()
    return {k: float(v) / count for k, v in sums.items()} if count else {}


def gather_eval_outputs(eval_step: Callable, dataset, batch_size: int, args, epoch: int,
                        device, extra_keys: Sequence[str] = ()
                        ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """The downstream eval over the whole validation split: the tail batch
    padded (``pad_last``), a fresh token draw per epoch, and only the valid
    rows kept. Across ranks the batch is rounded up to a multiple of the
    ranks, and the logits, labels and extras are gathered in rank order
    (``allgather_rows``), so every rank holds the whole split. Returns
    (logits, labels, {key: values for extra_keys})."""
    n = distributed.data_size()
    batch_size = (batch_size + n - 1) // n * n
    loader = Loader(dataset.val(), batch_size, shuffle=False, drop_last=False,
                    pad_last=True, seed=args.seed, workers=args.workers)
    loader.set_epoch(epoch)
    gather = distributed.allgather_rows
    logits, labels = [], []
    extras = {k: [] for k in extra_keys}
    for host_batch in loader:
        keep = gather(host_batch.pop("valid")) > 0
        out = gather(eval_step(to_device(host_batch, device)).cpu().numpy())
        logits.append(out[keep])
        labels.append(gather(host_batch["label"])[keep])
        for k in extra_keys:
            extras[k].append(gather(host_batch[k])[keep])
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


def eval_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of an epoch's validation draws, a function of (seed,
    epoch) apart from the train step's stream (the JAX CLI folds its eval
    keys in at 10_000_000 + epoch * 10_000), so ``--val`` changes no
    training draw and a resume needs only the train stream."""
    return torch.Generator(device=device).manual_seed(seed + 10_000_000 + epoch * 10_000)


def save_epoch(paths: Sequence[str], model, ema, args, epoch: int,
               metric: Optional[float], optimizer=None,
               generator: Optional[torch.Generator] = None) -> None:
    """The epoch's ``.pth.tar`` files, with ``state_dict_ema`` under
    ``--model-ema`` and what ``--resume`` restores: the optimizer's state,
    its update count as ``step`` and the train step generator's state.
    Every rank calls it (rank 0 with the paths, the others with none): a
    ZeRO-1 optimizer's state is gathered from all of them first, and under
    tensor parallelism the weights, the EMA and the optimizer's buffers are
    gathered to the one-rank keys and shapes."""
    sharded = optimizer is not None and optimizer.shard is not None
    split = bool(tensor_parallel.sharded_dims(model))
    if not paths and not sharded and not split:
        return
    state: Dict = {}
    if optimizer is not None:
        state.update(optimizer=optimizer.state_dict(), step=optimizer.count)
    weights = tensor_parallel.full_state_dict(model)
    ema_state = tensor_parallel.full_state_dict(ema.module) if ema is not None else None
    if not paths:
        return
    saved_args = {k: v for k, v in vars(args).items() if k != "defaults"}
    if generator is not None:
        state["rng_state"] = generator.get_state()
    save_checkpoint_file(paths[0], weights, saved_args, arch=args.model,
                         epoch=epoch, metric=metric, state_dict_ema=ema_state, run_state=state)
    for path in paths[1:]:  # the same payload: copied, not serialized again
        shutil.copyfile(paths[0], path + ".tmp")
        os.replace(path + ".tmp", path)


def start_epoch_of(args, model, loader, optimizer=None, ema=None, lr_controller=None,
                   generator: Optional[torch.Generator] = None) -> int:
    """The JAX CLIs' start (``train_mirror.py:113-145``): ``--resume``
    restores the run (:func:`checkpoint.resume_checkpoint`; the plateau
    controller adopts a restored lr), an explicit ``--start-epoch``
    overrides the resumed epoch, and from a start past 0 the schedule's
    count goes to start_epoch x updates an epoch where it is still 0, or
    in any case with both flags (timm's rewind); the plateau, with no
    restored optimizer, takes the epoch before the start."""
    start_epoch = 0
    resume_opt = not args.no_resume_opt
    if args.resume:
        start_epoch = resume_checkpoint(args.resume, model, optimizer, ema, generator,
                                        resume_opt=resume_opt)
        if lr_controller is not None and resume_opt:
            lr_controller.sync_from_optimizer(optimizer)
    rewind = args.start_epoch is not None and bool(args.resume)
    if args.start_epoch is not None:
        start_epoch = args.start_epoch
    args.start_epoch = start_epoch
    if optimizer is not None and (start_epoch > 0 or rewind):
        k = max(args.grad_accum_steps, 1)
        fast_forward_schedule(optimizer, start_epoch * max((len(loader) + k - 1) // k, 1),
                              rewind=rewind)
    if start_epoch > 0 and lr_controller is not None and (not args.resume or not resume_opt):
        lr_controller.step_epoch(optimizer, start_epoch - 1, None)
    return start_epoch


def init_wandb(args, out_dir: Optional[str]):
    """The wandb run under ``--log-wandb``, or None (with a warning) where
    wandb is not installed."""
    if not getattr(args, "log_wandb", False):
        return None
    try:
        import wandb
    except ImportError:
        _logger.warning("wandb requested but not installed; skipping")
        return None
    return wandb.init(project=getattr(args, "wandb_project", "MIRROR"),
                      name=os.path.basename(out_dir) if out_dir else None,
                      config={k: v for k, v in vars(args).items() if k != "defaults"})


@contextlib.contextmanager
def profiled_epoch(profile_dir: Optional[str], epoch: int, device):
    """``--profile``: the epoch under ``torch.profiler`` (the CPU, and the
    card's kernels on a CUDA device), its trace written to
    ``{profile_dir}/epoch_<epoch>.pt.trace.json``; nothing without a
    directory."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"epoch_{epoch}.pt.trace.json")
    prof.export_chrome_trace(path)
    _logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def sigterm_flag():
    """A SIGTERM handler that only sets a flag (the run finishes its batch,
    writes the recovery file and stops), the old handler restored on every
    exit path. Off the main thread no handler can be set: the flag then
    stays down."""
    flag = {"stop": False}

    def on_term(signum, frame):
        flag["stop"] = True
        _logger.warning("signal %d received: will checkpoint and stop at the next batch "
                        "boundary", signum)

    try:
        old = signal.signal(signal.SIGTERM, on_term)
    except ValueError:  # not the main thread
        old = None
    try:
        yield flag
    finally:
        if old is not None:
            signal.signal(signal.SIGTERM, old)


def run(args, model, train_step, loader, device, eval_fn: Optional[Callable],
        out_dir: Optional[str], decreasing: bool, ema=None, lr_controller=None,
        optimizer=None, generator: Optional[torch.Generator] = None) -> Dict:
    """The epoch loop from the start epoch (:func:`start_epoch_of`): train,
    evaluate (``eval_fn(epoch, model)``, and the EMA module as
    ``ema_<metric>``), summary, wandb, the plateau step
    (``lr_controller.step_epoch(optimizer, ...)``), checkpoints with the
    run's state (``optimizer`` and the train step's ``generator``); then the
    ``--result`` JSON on stdout. A NaN eval metric (a c-index over an
    all-censored split) is logged and not ranked; so is an
    ``--eval-metric`` the epoch does not emit. ``--profile`` traces the
    epoch after the start epoch. On SIGTERM the run finishes its batch,
    writes ``recovery.pth.tar``, skips eval and the summary, and returns
    with ``"preempted": true``. Across ranks every rank runs the loop
    (``out_dir`` is rank 0's only) and rank 0 prints the ``--result``."""
    start_epoch = start_epoch_of(args, model, loader, optimizer, ema, lr_controller, generator)
    with sigterm_flag() as flag:
        best_metric, best_epoch = None, None
        history = CheckpointHistory(out_dir, args.checkpoint_hist, decreasing) if out_dir else None
        wandb_run = init_wandb(args, out_dir) if distributed.is_main() else None
        profile_dir = os.path.join(out_dir, "profile") if out_dir and args.profile else None
        save_recovery = None
        if args.output:  # on every rank: a ZeRO-1 save gathers from all of them
            def save_recovery(epoch, batch_idx):
                paths = [os.path.join(out_dir, "recovery.pth.tar")] if out_dir else []
                save_epoch(paths, model, ema, args, epoch, None, optimizer, generator)

        def stop_requested() -> bool:
            flag["stop"] = distributed.agree(flag["stop"], device)
            return flag["stop"]

        preempted = False
        for epoch in range(start_epoch, scheduled_epochs(args)):
            t0 = time.time()
            with profiled_epoch(profile_dir if epoch == start_epoch + 1 else None, epoch, device):
                train_metrics = train_one_epoch(args, epoch, train_step, loader, device,
                                                stop_requested, save_recovery)
            if stop_requested():
                # a grace window is short: the recovery file only, no eval or summary
                preempted = True
                if save_recovery is not None:
                    save_recovery(epoch, -1)
                    _logger.warning("preemption: recovery checkpoint written during epoch %d; "
                                    "exiting", epoch)
                break
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
            # the --wandb-watch stats go to wandb only
            watch = {k: v for k, v in train_metrics.items() if k.startswith("watch/")}
            train_metrics = {k: v for k, v in train_metrics.items() if k not in watch}
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
            if wandb_run is not None:
                payload = {f"train_{k}": v for k, v in train_metrics.items()}
                payload.update(watch)
                payload.update({f"eval_{k}": v for k, v in (eval_metrics or {}).items()})
                wandb_run.log(payload, step=epoch)
            if lr_controller is not None:
                lr_controller.step_epoch(optimizer, epoch, metric)
                _logger.info("Plateau LR after epoch %d: %g", epoch, lr_controller.applied_lr)
            improved = metric is not None and (best_metric is None or (
                metric < best_metric if decreasing else metric > best_metric))
            if improved:
                best_metric, best_epoch = metric, epoch
            if args.output:
                paths = history.paths(epoch, metric) if out_dir else []
                if improved and out_dir:
                    paths.append(os.path.join(out_dir, "model_best.pth.tar"))
                save_epoch(paths, model, ema, args, epoch, metric, optimizer, generator)
            _logger.info("Epoch %d done in %.1fs", epoch, time.time() - t0)

        results = {"best_metric": best_metric, "best_epoch": best_epoch,
                   "metric_name": args.eval_metric}
        if preempted:
            results["preempted"] = True
        if wandb_run is not None:
            wandb_run.summary.update(results)
            wandb_run.finish()
        if distributed.is_main():
            print(f"--result\n{json.dumps(results, indent=4)}", flush=True)  # lint: allow-print
        return results
