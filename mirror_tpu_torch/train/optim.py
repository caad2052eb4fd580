"""Optimizer, learning-rate schedules and plateau controller.

Counterpart of ``mirror_tpu/train/optim.py``, held to its optax chains
rather than to torch's built-in optimizers where the two differ.
:class:`ChainOptimizer` runs, per real update and in the JAX chain's order:

1. clipping (``--clip-grad``, ``--clip-mode``): ``norm`` (optax's global
   norm: no epsilon, nothing changes below the bar), ``value``, or ``agc``
   (timm's unit-wise adaptive clipping, the classifier head and the other
   :data:`AGC_EXCLUDE` leaves left alone);
2. the optimizer (``--opt``): ``adam`` (weight decay coupled into the
   gradient, as torch's Adam), ``adamw`` (decoupled, after the moments;
   both written into the weights by one ``addcdiv`` after the moments'
   passes, Adam's bias corrections in fp32 as optax takes them),
   ``sgd`` / ``nesterov`` (Nesterov momentum) and ``momentum`` (heavy
   ball), ``lamb`` (Adam, decay, then optax's trust ratio ||p|| / ||u||, 1
   where either norm is 0), ``adagrad`` (optax's rsqrt(sum + eps), 0 where
   the sum is 0), ``rmsprop`` (timm's alpha 0.9, eps outside the sqrt, the
   momentum buffer tracing the scaled update); decay only on parameters of
   ndim > 1 (timm's no-decay groups);
3. the learning rate, a function of the real-update count
   (:func:`make_schedule`: timm's cosine / tanh / poly with cycles and
   k-decay, step, multistep, warmup, noise) or a value the
   :class:`PlateauController` writes at epoch boundaries;
4. ``--layer-decay``: inert on the MIRROR-family models, as in the JAX
   package (no head prefix, so one group at scale 1.0); only logged.

Gradient accumulation (``--grad-accum-steps k``) is optax's ``MultiSteps``:
:meth:`ChainOptimizer.step` keeps the running mean of k micro-gradients and
updates on the k-th; the counter carries across epoch boundaries. The
optimizer state is fp32 on the parameters' device, and every per-update
step is a batched ``torch._foreach_*`` call over the parameter list (AGC
a few launches over one flat buffer).

ZeRO-1 (``--optimizer-sharding`` under a process group of several ranks;
the JAX package's ``shard_state(zero1=True)``): the parameter list is cut
into one contiguous range of whole tensors a rank, the fixed split with
the least largest range in elements (:func:`partition`; a range is empty
only where there are fewer tensors than ranks, as in the linear probe);
each rank keeps the buffers of its range only, clips on the whole
averaged gradient (so the norm and AGC see what an unsharded run sees),
updates its range and broadcasts it; ``state_dict`` gathers every range
(a collective: every rank calls it) into the file an unsharded run
writes, and ``load_state_dict`` takes the rank's range of any such file. ``ZeroRedundancyOptimizer`` cannot wrap the chain: it is not a
``torch.optim.Optimizer``.

Under tensor parallelism (``parallel/tensor_parallel.py``) the chain holds
the rank's slices of the model-sharded leaves (``sharded``: name -> split
dim): each reduction across a leaf or across leaves sums the slices'
squares over the model ranks (the global norm of ``--clip-mode norm``,
AGC's unit-wise norms where a unit is split, lamb's ||p|| and ||u||), so
every rank clips and scales as one rank holding the whole leaves would;
ZeRO-1 partitions the rank's own (sliced) leaves over the data ranks; and
``state_dict`` gathers the slices into the one-rank file, which
``load_state_dict`` cuts again.

The linear probe (``head_only``) holds only the ``head.*`` parameters, the
JAX package's ``head_only_mask`` with the frozen updates set to zero;
:func:`reinit_head` is the probe's head init (train_subtyping.py:48-62 of
the JAX package).
"""

import logging
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel import distributed, tensor_parallel

_logger = logging.getLogger(__name__)

OPTIMIZERS = ("adam", "adamw", "sgd", "momentum", "nesterov", "lamb", "adagrad", "rmsprop")
SCHEDULES = ("cosine", "tanh", "poly", "step", "multistep", "plateau")
HEAD_PREFIX = "head."
# timm's AGC passes list(model.parameters())[:-2], the last two parameters in
# registration order: MIRROR's style_decoder.bias and prototypes.weight, the
# classifier's head, the dual encoder's rna_projection (the JAX package's
# _AGC_EXCLUDE, here in torch names); none is clipped
AGC_EXCLUDE = ("style_decoder.bias", "prototypes.weight", "head.weight", "head.bias",
               "rna_projection.weight", "rna_projection.bias")

f32 = np.float32


def _timm_noise(t: int, seed: int, pct: float, std: float) -> float:
    """timm ``Scheduler._calculate_noise``: a CPU generator seeded with
    seed + t, normal draws until one is below ``pct`` in magnitude."""
    g = torch.Generator()
    g.manual_seed(seed + t)
    while True:
        noise = torch.randn(1, generator=g).item() * std
        if abs(noise) < pct:
            return noise


def _noise_range_t(args, t_initial: float):
    """timm ``create_scheduler_v2``: ``--lr-noise`` fractions of t_initial;
    one value means from there on, two a half-open window."""
    lr_noise = getattr(args, "lr_noise", None)
    if lr_noise is None or (isinstance(lr_noise, (list, tuple)) and len(lr_noise) == 0):
        return None
    if isinstance(lr_noise, (list, tuple)):
        rng = [n * t_initial for n in lr_noise]
        return rng[0] if len(rng) == 1 else (rng[0], rng[1])
    return lr_noise * t_initial


def _noise_applies(noise_range, t: float) -> bool:
    if noise_range is None:
        return False
    if isinstance(noise_range, tuple):
        return noise_range[0] <= t < noise_range[1]
    return t >= noise_range


def _noise_table(args, t_initial: float, total_t: int) -> Optional[np.ndarray]:
    """The lr factor (1 + noise) of every t, fp32; None without noise."""
    noise_range = _noise_range_t(args, t_initial)
    if noise_range is None:
        return None
    pct = getattr(args, "lr_noise_pct", 0.67)
    std = getattr(args, "lr_noise_std", 1.0)
    seed = getattr(args, "seed", 42)
    table = np.ones(max(total_t, 1), np.float32)
    for t in range(table.shape[0]):
        if _noise_applies(noise_range, t):
            table[t] = 1.0 + _timm_noise(t, seed, pct, std)
    return table


def _cycle_span_epochs(epochs: int, mul: float, limit: int) -> int:
    """timm ``Scheduler.get_cycle_length``: the epochs ``limit`` cycles of
    ``epochs`` growing by ``mul`` cover."""
    if mul == 1.0:
        return epochs * max(limit, 1)
    return int(math.floor(-epochs * (mul ** max(limit, 1) - 1) / (1 - mul)))


def scheduled_epochs(args) -> int:
    """The epochs a run trains: timm's cycle length plus ``--cooldown-epochs``
    for cosine / tanh / poly, ``--epochs`` otherwise."""
    if getattr(args, "use_sched", False) and args.sched in ("cosine", "tanh", "poly"):
        span = _cycle_span_epochs(args.epochs, getattr(args, "lr_cycle_mul", 1.0),
                                  getattr(args, "lr_cycle_limit", 1))
        return span + getattr(args, "cooldown_epochs", 0)
    return args.epochs


def make_schedule(args, steps_per_epoch: int, base_lr: float) -> Callable[[int], float]:
    """``lr(update_count)``, the JAX package's ``make_schedule`` (timm's
    ``create_scheduler_v2``) in its fp32 arithmetic: cosine / tanh / poly
    with ``--lr-cycle-mul`` / ``-decay`` / ``-limit`` and ``--lr-k-decay``
    (the cycle starts precomputed in float64, then cast), step, multistep
    (timm's decay one epoch early: ``t + 1`` against the milestones),
    linear warmup (``--warmup-prefix`` shifts a cycle schedule past it),
    and the ``--lr-noise`` table. Per epoch unless ``--sched-on-updates``.
    Constant at ``base_lr`` without ``--use-sched`` and under plateau (the
    controller sets that lr)."""
    if not getattr(args, "use_sched", False) or args.sched == "plateau":
        const = float(f32(base_lr))
        return lambda count: const
    sched = args.sched
    if sched not in SCHEDULES:
        raise ValueError(f"Unsupported sched '{sched}' (supported: {', '.join(SCHEDULES)})")

    on_updates = getattr(args, "sched_on_updates", False)
    unit = steps_per_epoch if on_updates else 1
    t_initial = float(args.epochs * unit)
    warmup_t = float(args.warmup_epochs * unit)
    decay_t = float(args.decay_epochs) * unit
    milestones = np.asarray([m * unit for m in args.decay_milestones], np.float32)
    warmup_prefix = getattr(args, "warmup_prefix", False)
    cycle_mul = float(getattr(args, "lr_cycle_mul", 1.0))
    cycle_decay = float(getattr(args, "lr_cycle_decay", 0.5))
    cycle_limit = int(getattr(args, "lr_cycle_limit", 1))
    k = f32(getattr(args, "lr_k_decay", 1.0))
    base, min_lr, warmup_lr = f32(base_lr), f32(args.min_lr), f32(args.warmup_lr)
    total_t = int((_cycle_span_epochs(args.epochs, cycle_mul, cycle_limit)
                   + getattr(args, "cooldown_epochs", 0)) * unit) + 1
    noise = _noise_table(args, t_initial, total_t)
    if cycle_mul != 1.0:
        starts = np.array([t_initial * (1.0 - cycle_mul ** j) / (1.0 - cycle_mul)
                           for j in range(cycle_limit + 1)], np.float64).astype(np.float32)
        lens = np.array([cycle_mul ** j * t_initial for j in range(cycle_limit + 1)],
                        np.float64).astype(np.float32)

    def cycle_lr(t, shape):
        if cycle_mul == 1.0:
            i = np.floor(t / f32(t_initial))
            t_i = f32(t_initial)
            t_curr = t - i * f32(t_initial)
        else:
            i = int(np.sum(t >= starts[1:]))
            t_i, t_curr = lens[i], t - starts[i]
        lr_max = base * np.power(f32(cycle_decay), f32(i))
        return min_lr + (lr_max - min_lr) * shape(t_curr, t_i) if i < cycle_limit else min_lr

    if sched == "cosine":
        def base_fn(t):
            return cycle_lr(t, lambda tc, ti: f32(0.5) * (
                f32(1) + np.cos(f32(np.pi) * tc ** k / ti ** k)))
    elif sched == "tanh":
        lb, ub = f32(-7.0), f32(3.0)  # timm TanhLRScheduler's defaults

        def base_fn(t):
            return cycle_lr(t, lambda tc, ti: f32(0.5) * (
                f32(1) - np.tanh(lb + (ub - lb) * (tc / ti))))
    elif sched == "poly":
        def base_fn(t):  # timm PolyLRScheduler's power 0.5
            return cycle_lr(t, lambda tc, ti: (f32(1) - tc ** k / ti ** k) ** f32(0.5))
    elif sched == "step":
        def base_fn(t):
            return base * np.power(f32(args.decay_rate), np.floor(t / f32(decay_t)))
    else:  # multistep
        def base_fn(t):
            return base * np.power(f32(args.decay_rate),
                                   f32(np.sum(t + f32(1) >= milestones)))

    cyclic = sched in ("cosine", "tanh", "poly")
    warm_span = f32(base_lr - args.warmup_lr)

    def fn(count: int) -> float:
        t = f32(count if on_updates else count // steps_per_epoch)
        lr = base_fn(max(t - f32(warmup_t), f32(0)) if cyclic and warmup_prefix else t)
        if warmup_t > 0 and t < f32(warmup_t):
            lr = warmup_lr + warm_span * (t / f32(warmup_t))
        if noise is not None:
            lr = lr * noise[min(max(int(t), 0), noise.shape[0] - 1)]
        return float(f32(lr))

    return fn


class PlateauController:
    """timm's ``PlateauLRScheduler`` (torch ``ReduceLROnPlateau`` with a
    relative threshold of 1e-4): linear warmup over ``warmup_epochs`` from
    ``warmup_lr``, then ``decay_rate`` once the metric has not improved for
    more than ``patience`` epochs, floored at ``min_lr``, with a
    ``cooldown``; ``--lr-noise`` perturbs the applied lr after warmup, the
    plateau decisions stay noise-free. :meth:`step_epoch` writes the lr into
    the optimizer at each epoch boundary; ``applied_lr`` is what it wrote."""

    def __init__(self, base_lr: float, decay_rate: float = 0.1, patience: int = 10,
                 cooldown: int = 0, warmup_epochs: int = 0, warmup_lr: float = 1e-5,
                 min_lr: float = 0.0, mode: str = "min", threshold: float = 1e-4,
                 noise_range=None, noise_pct: float = 0.67, noise_std: float = 1.0,
                 noise_seed: int = 42) -> None:
        self.base_lr, self.decay_rate, self.patience = base_lr, decay_rate, patience
        self.cooldown, self.warmup_epochs, self.warmup_lr = cooldown, warmup_epochs, warmup_lr
        self.min_lr, self.mode, self.threshold = min_lr, mode, threshold
        self.noise_range, self.noise_pct = noise_range, noise_pct
        self.noise_std, self.noise_seed = noise_std, noise_seed
        self.current_lr = warmup_lr if warmup_epochs > 0 else base_lr
        self.applied_lr = self.current_lr
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self._warmup_exited = warmup_epochs <= 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def epoch_lr(self, epoch: int, metric: Optional[float]) -> float:
        if epoch < self.warmup_epochs:
            t = (epoch + 1) / max(self.warmup_epochs, 1)
            self.current_lr = self.warmup_lr + t * (self.base_lr - self.warmup_lr)
            return self.current_lr
        if not self._warmup_exited:
            self.current_lr = self.base_lr
            self._warmup_exited = True
        if metric is None:
            return self._with_noise(epoch, self.current_lr)
        # ReduceLROnPlateau's order: best and the bad-epoch count first, then
        # the cooldown ticks down every epoch, suppressing bad epochs
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.current_lr = max(self.current_lr * self.decay_rate, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self._with_noise(epoch, self.current_lr)

    def _with_noise(self, epoch: int, lr: float) -> float:
        if not _noise_applies(self.noise_range, epoch):
            return lr
        return lr * (1.0 + _timm_noise(epoch, self.noise_seed, self.noise_pct,
                                       self.noise_std))

    def step_epoch(self, optimizer: "ChainOptimizer", epoch: int,
                   metric: Optional[float]) -> float:
        self.applied_lr = self.epoch_lr(epoch, metric)
        optimizer.set_lr(self.applied_lr)
        return self.applied_lr

    def sync_from_optimizer(self, optimizer: "ChainOptimizer") -> None:
        """Adopt the lr a resumed optimizer holds (``sync_from_state`` of the
        JAX package): the restored lr is the post-warmup, maybe decayed one,
        so the warmup's exit must not overwrite it at the next epoch."""
        self.current_lr = optimizer.host_lr
        self.applied_lr = self.current_lr
        self._warmup_exited = True

    @classmethod
    def from_args(cls, args, base_lr: float, decreasing_metric: bool = True):
        return cls(base_lr=base_lr, decay_rate=args.decay_rate, patience=args.patience_epochs,
                   cooldown=args.cooldown_epochs, warmup_epochs=args.warmup_epochs,
                   warmup_lr=args.warmup_lr, min_lr=args.min_lr,
                   mode="min" if decreasing_metric else "max",
                   noise_range=_noise_range_t(args, float(args.epochs)),
                   noise_pct=getattr(args, "lr_noise_pct", 0.67),
                   noise_std=getattr(args, "lr_noise_std", 1.0),
                   noise_seed=getattr(args, "seed", 42))


def partition(numels: Sequence[int], parts: int) -> List[int]:
    """The bounds [0, ..., n] of ``parts`` contiguous ranges of a list of
    tensors of ``numels`` elements, whole tensors a range: the least
    largest range in elements (the smallest capacity that a greedy walk
    fits into ``parts`` ranges), each range cut early where the tensors
    left are no more than the ranges left, so that a range is empty only
    when there are fewer tensors than ranges."""
    numels = [int(n) for n in numels]

    def ranges(cap: int) -> List[int]:
        bounds, load = [0], 0
        for i, n in enumerate(numels):
            opened = i > bounds[-1]
            if opened and (load + n > cap or len(numels) - i <= parts - len(bounds)):
                bounds.append(i)
                load = 0
            load += n
        return bounds

    lo, hi = max(numels, default=0), sum(numels)
    while lo < hi:  # the least capacity that fits
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if len(ranges(mid)) <= parts else (mid + 1, hi)
    bounds = ranges(lo)
    return bounds + [len(numels)] * (parts + 1 - len(bounds))


def fast_forward_schedule(optimizer: "ChainOptimizer", n_updates: int,
                          rewind: bool = False) -> None:
    """Set the update count to ``n_updates`` where it is still 0 (timm
    steps its rebuilt scheduler to the start epoch; the JAX package's
    ``fast_forward_schedule``), or whatever it is with ``rewind`` (an
    explicit ``--start-epoch`` with ``--resume``: timm's rewind, which the
    JAX package leaves out). The one count is both the schedule's and the
    logged lr's, so the two cannot part, under accumulation too."""
    if rewind or optimizer.count == 0:
        optimizer.count = int(n_updates)


class ChainOptimizer:
    """The JAX package's optax chain over the parameters it holds, decay on
    those of ndim > 1 (``params[:n_decay]``), none on the rest. ``step()``
    returns True when it updated the parameters (every call, or every k-th
    under accumulation). Its state (the moments and traces in ``state``,
    the update count, the accumulated gradients) is its own: there is no
    ``torch.optim.Optimizer`` underneath."""

    def __init__(self, named_params: Sequence[Tuple[str, nn.Parameter]], opt: str,
                 schedule: Callable[[int], float], weight_decay: float = 0.0,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.9, rms_alpha: float = 0.9, amsgrad: bool = False,
                 clip_grad: Optional[float] = None, clip_mode: str = "norm",
                 accum_steps: int = 1, host_lr: Optional[float] = None,
                 shard: Optional[Tuple[int, int]] = None,
                 sharded: Optional[Mapping[str, int]] = None):
        if opt not in OPTIMIZERS:
            raise ValueError(f"Unsupported optimizer: {opt}")
        if clip_grad is not None and clip_mode not in ("norm", "value", "agc"):
            raise ValueError(f"unknown clip_mode {clip_mode}")
        decay = [(n, p) for n, p in named_params if p.ndim > 1]
        no_decay = [(n, p) for n, p in named_params if p.ndim <= 1]
        self.names = [n for n, _ in decay + no_decay]
        self.params = [p for _, p in decay + no_decay]
        self.n_decay = len(decay)
        # ZeRO-1: (rank, ranks); this rank's range [lo, hi) of the list
        self.shard = shard if shard is not None and shard[1] > 1 else None
        self.bounds = partition([p.numel() for p in self.params],
                                self.shard[1] if self.shard else 1)
        r = self.shard[0] if self.shard else 0
        self.lo, self.hi = self.bounds[r], self.bounds[r + 1]
        self.own = self.params[self.lo:self.hi]
        self.own_names = self.names[self.lo:self.hi]
        self.own_decay = min(max(self.n_decay - self.lo, 0), self.hi - self.lo)
        self.opt, self.schedule, self.weight_decay = opt, schedule, weight_decay
        self.b1, self.b2, self.eps = float(betas[0]), float(betas[1]), eps
        self.momentum, self.rms_alpha, self.amsgrad = momentum, rms_alpha, amsgrad
        self.clip_grad, self.clip_mode = clip_grad, clip_mode
        self.agc_keep = [any(n == s or n.endswith("." + s) for s in AGC_EXCLUDE)
                         for n, _ in decay + no_decay]
        # tensor parallelism: the split dim of each model-sharded leaf, by name
        self.tp_dims = {n: d for n, d in (sharded or {}).items() if n in set(self.names)}
        self.tp_mask = torch.tensor([n in self.tp_dims for n in self.names],
                                    device=self.params[0].device) if self.tp_dims else None
        self.accum_steps = max(int(accum_steps), 1)
        self.host_lr = None if host_lr is None else float(f32(host_lr))
        self.count = 0  # real updates so far: the schedule's count
        # the updates the moments have seen: Adam's bias correction (optax
        # keeps it apart from the schedule's, so a fast-forward leaves it)
        self.moment_count = 0
        self.mini_step = 0
        self.state = {}
        self._acc: Optional[List[torch.Tensor]] = None
        self._agc_lengths: Optional[torch.Tensor] = None
        self._agc_split: Optional[torch.Tensor] = None

    def current_lr(self) -> float:
        """The lr of the next real update (the logged lr)."""
        return self.host_lr if self.host_lr is not None else self.schedule(self.count)

    def set_lr(self, lr: float) -> None:
        """The plateau controller's write."""
        self.host_lr = float(f32(lr))

    def _gathered(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's range of one buffer, in the list's order (each
        range broadcast by its owner)."""
        if self.shard is None:
            return bufs
        out = []
        for r in range(self.shard[1]):
            lo, hi = self.bounds[r], self.bounds[r + 1]
            part = bufs if r == self.shard[0] else [
                torch.empty_like(p, dtype=torch.float32) for p in self.params[lo:hi]]
            distributed.broadcast_(part, src=r)
            out += part
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The chain's whole state as CPU tensors and numbers, each buffer
        keyed by its parameter's name (``torch.load(weights_only=True)``
        reads it back): the moments and traces, the update count, the
        micro-step, the accumulated micro-gradients and the host lr. Under
        ZeRO-1 every rank must call it: the ranges are gathered."""
        def named(tensors):
            return {n: self._whole(n, t).detach().cpu().clone()
                    for n, t in zip(self.names, tensors)}

        return {"state": {key: named(self._gathered(self.state[key]))
                          for key in self.state},
                "count": self.count, "moment_count": self.moment_count,
                "mini_step": self.mini_step,
                "acc": None if self._acc is None else named(self._acc),
                "host_lr": self.host_lr}

    def load_state_dict(self, payload: Mapping[str, Any]) -> None:
        """Restore :meth:`state_dict`'s output onto this chain's parameters
        (by name, each buffer on its parameter's device in fp32; under
        ZeRO-1 the rank's range of the buffers)."""
        missing = [n for n in self.names if any(n not in bufs for bufs in
                                                payload["state"].values())]
        if missing:
            raise ValueError(f"optimizer state lacks parameters {missing[:5]}")

        def placed(named, names=self.names, params=self.params):
            return [self._slice(n, named[n]).to(device=p.device, dtype=torch.float32)
                    for n, p in zip(names, params)]

        self.state = {key: placed(bufs, self.own_names, self.own)
                      for key, bufs in payload["state"].items()}
        self.count = int(payload["count"])
        self.moment_count = int(payload["moment_count"])
        self.mini_step = int(payload["mini_step"])
        self._acc = None if payload.get("acc") is None else placed(payload["acc"])
        host_lr = payload.get("host_lr")
        self.host_lr = None if host_lr is None else float(host_lr)

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of a buffer of ``name`` (gathered from the model
        ranks where the leaf is split: a collective)."""
        dim = self.tp_dims.get(name)
        return t if dim is None else tensor_parallel.gather_along_model(t, dim)

    def _slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.tp_dims.get(name)
        return t if dim is None else tensor_parallel.shard_state({name: t}, {name: dim})[name]

    def _leaf_norms(self, tensors: List[torch.Tensor], lo: int = 0) -> torch.Tensor:
        """The L2 norm of each of ``tensors`` (the buffers of params[lo:]),
        of the whole leaf where the model ranks split it."""
        mask = None if self.tp_mask is None else self.tp_mask[lo:lo + len(tensors)]
        return tensor_parallel.leaf_norms(tensors, mask)

    def _state_keys(self) -> List[str]:
        """The keys of the buffers that an update makes, in its order."""
        if self.opt in ("adam", "adamw", "lamb"):
            return ["mu", "nu"] + (["nu_max"] if self.amsgrad else [])
        if self.opt == "adagrad":
            return ["sum_of_squares"]
        if self.opt == "rmsprop":
            return ["nu"] + (["trace"] if self.momentum else [])
        return ["trace"]

    def _state(self, key: str) -> List[torch.Tensor]:
        """An fp32 buffer a parameter (moments, traces, sums), zero at first."""
        if key not in self.state:
            self.state[key] = [torch.zeros_like(p, dtype=torch.float32) for p in self.own]
        return self.state[key]

    @torch.no_grad()
    def step(self) -> bool:
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.accum_steps > 1:
            # optax MultiSteps: the running (Welford) mean of the micro-gradients
            if self.mini_step == 0:
                self._acc = [g.clone() for g in grads]
            else:
                diff = torch._foreach_sub(grads, self._acc)
                torch._foreach_div_(diff, float(self.mini_step + 1))
                torch._foreach_add_(self._acc, diff)
            if self.mini_step < self.accum_steps - 1:
                self.mini_step += 1
                return False
            grads, self._acc, self.mini_step = self._acc, None, 0
        lr = self.current_lr()
        grads = self._clip(grads)[self.lo:self.hi]
        if not self.own:
            # an empty ZeRO-1 range: no update (a _foreach op refuses an empty
            # list), the buffers' keys all the same, so that state_dict's
            # gathers line up across the ranks
            for key in self._state_keys():
                self._state(key)
        elif self.opt in ("adam", "adamw"):
            self._adam_apply(grads, lr)
        else:
            updates = self._direction(grads)
            torch._foreach_mul_(updates, -lr)
            torch._foreach_add_(self.own, updates)
        if self.shard is not None:
            for r in range(self.shard[1]):
                distributed.broadcast_(self.params[self.bounds[r]:self.bounds[r + 1]], src=r)
        self.count += 1
        self.moment_count += 1
        return True

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.clip_grad is None:
            return grads
        c = float(self.clip_grad)
        if self.clip_mode == "value":
            out = torch._foreach_clamp_max(grads, c)
            torch._foreach_clamp_min_(out, -c)
            return out
        if self.clip_mode == "norm":
            # optax clip_by_global_norm: (g / |g|) * c at or above the bar,
            # g untouched below it; no host sync
            norm = torch.linalg.vector_norm(self._leaf_norms(grads))
            below = norm < c
            out = torch._foreach_div(grads, torch.where(below, 1.0, norm))
            torch._foreach_mul_(out, torch.where(below, 1.0, c))
            return out
        return self._agc(grads, c)

    def _agc(self, grads: List[torch.Tensor], c: float) -> List[torch.Tensor]:
        """timm's AGC in a fixed number of launches: the clipped parameters
        and their gradients flattened into one buffer each, the unit-wise
        norms (timm's ``unitwise_norm``: over every dim but dim 0, over the
        whole tensor for ndim <= 1) as one segmented sum, then
        g * (max(|p|, 1e-3) c / max(|g|, 1e-6)) where |g| is at or over the
        bar, g where it is under."""
        idx = [i for i, keep in enumerate(self.agc_keep) if not keep]
        if not idx:
            return grads
        if self._agc_lengths is None:
            units = [self.params[i].shape[0] if self.params[i].ndim > 1 else 1 for i in idx]
            self._agc_lengths = torch.tensor(
                [self.params[i].numel() // u for i, u in zip(idx, units) for _ in range(u)],
                device=self.params[idx[0]].device)
            # a unit that the model ranks split: a row of a row-parallel
            # weight, or a split vector (one unit)
            split = [self.names[i] in self.tp_dims and
                     (self.params[i].ndim <= 1 or self.tp_dims[self.names[i]] != 0)
                     for i in idx]
            self._agc_split = torch.tensor([s for s, u in zip(split, units) for _ in range(u)],
                                           device=self.params[idx[0]].device) \
                if any(split) else None
        lengths = self._agc_lengths

        def unit_norms(tensors):
            flat = torch.cat([t.reshape(-1) for t in tensors])
            sq = torch.segment_reduce(flat * flat, "sum", lengths=lengths)
            if self._agc_split is not None:
                sq = tensor_parallel.sum_over_model(sq, self._agc_split)
            return flat, sq.sqrt()

        flat_g, g_norm = unit_norms([grads[i] for i in idx])
        _, p_norm = unit_norms([self.params[i].float() for i in idx])
        max_norm = p_norm.clamp_min(1e-3) * c
        factor = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm.clamp_min(1e-6))
        flat_g = flat_g * factor.repeat_interleave(lengths, output_size=flat_g.numel())
        out = list(grads)
        for i, piece in zip(idx, flat_g.split([grads[i].numel() for i in idx])):
            out[i] = piece.view(grads[i].shape)
        return out

    def _add_decay(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax add_decayed_weights on the decay group: t + wd * p."""
        nd = self.own_decay
        if not self.weight_decay or nd == 0:
            return tensors
        decayed = list(torch._foreach_mul(self.own[:nd], self.weight_decay))
        torch._foreach_add_(decayed, tensors[:nd])
        return decayed + list(tensors[nd:])

    def _adam_moments(self, grads: List[torch.Tensor]):
        """optax scale_by_adam's moments, advanced in place: (mu, the
        denominator sqrt(nu / bc2) + eps, bc1); the update is mu / bc1 / den."""
        mu, nu = self._state("mu"), self._state("nu")
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        n = f32(self.moment_count + 1)
        bc1 = float(f32(1) - np.power(f32(self.b1), n))
        bc2 = float(f32(1) - np.power(f32(self.b2), n))
        den = torch._foreach_div(nu, bc2)
        if self.amsgrad:
            nu_max = self._state("nu_max")
            torch._foreach_maximum_(nu_max, den)
            den = torch._foreach_sqrt(nu_max)
        else:
            torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        return mu, den, bc1

    def _adam_apply(self, grads: List[torch.Tensor], lr: float) -> None:
        """adam (decay coupled into the gradient) and adamw (decoupled, p
        shrunk by lr * wd) applied in the moments' passes: one addcdiv
        writes p - (lr / bc1) mu / den."""
        nd = self.own_decay
        if self.opt == "adam":
            grads = self._add_decay(grads)
        mu, den, bc1 = self._adam_moments(grads)
        if self.opt == "adamw" and self.weight_decay and nd:
            torch._foreach_mul_(self.own[:nd], 1.0 - lr * self.weight_decay)
        torch._foreach_addcdiv_(self.own, mu, den, value=-lr / bc1)

    def _direction(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        opt = self.opt
        if opt == "lamb":
            mu, den, bc1 = self._adam_moments(grads)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            u = self._add_decay(u)
            p_norm = self._leaf_norms(self.own, self.lo)
            u_norm = self._leaf_norms(u, self.lo)
            ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
            torch._foreach_mul_(u, list(ratio.unbind()))
            return u
        grads = self._add_decay(grads)  # coupled decay: sgd, adagrad, rmsprop
        if opt in ("sgd", "momentum", "nesterov"):
            trace = self._state("trace")
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            if opt == "momentum":
                return [t.clone() for t in trace]
            out = torch._foreach_mul(trace, self.momentum)
            torch._foreach_add_(out, grads)
            return out
        if opt == "adagrad":
            ssum = self._state("sum_of_squares")
            torch._foreach_addcmul_(ssum, grads, grads)
            inv = torch._foreach_add(ssum, self.eps)
            torch._foreach_rsqrt_(inv)
            if self.eps <= 0:  # optax's 0 where the sum is 0
                inv = [torch.where(s > 0, i, 0.0) for s, i in zip(ssum, inv)]
            return torch._foreach_mul(inv, grads)
        # rmsprop
        nu = self._state("nu")
        torch._foreach_mul_(nu, self.rms_alpha)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.rms_alpha)
        scale = torch._foreach_sqrt(nu)
        torch._foreach_add_(scale, self.eps)
        torch._foreach_reciprocal_(scale)
        out = torch._foreach_mul(scale, grads)
        if self.momentum:
            trace = self._state("trace")
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, out)
            out = [t.clone() for t in trace]
        return out


def _trainable(model: nn.Module, head_only: bool) -> List[Tuple[str, nn.Parameter]]:
    """The parameters the optimizer holds: every one that requires a
    gradient, or the ``head.*`` ones alone under the linear probe."""
    return [(n, p) for n, p in model.named_parameters()
            if p.requires_grad and (not head_only or n.startswith(HEAD_PREFIX))]


def make_optimizer(args, model: nn.Module, lr: float, head_only: bool = False,
                   steps_per_epoch: int = 1) -> ChainOptimizer:
    """The JAX package's ``make_optimizer`` for ``model``: ``--opt`` with
    ``--opt-eps`` / ``--opt-betas`` / ``--momentum`` / ``--weight-decay``,
    ``--opt-kwargs`` eps, betas, momentum, alpha and amsgrad (the rest
    refused, as the JAX chain refuses them), clipping, the schedule of
    ``lr`` over ``steps_per_epoch`` real updates an epoch (or the plateau's
    host lr, starting at ``--warmup-lr`` under warmup), ``--layer-decay``
    (logged, inert), ``--grad-accum-steps`` and ``--optimizer-sharding``
    (ZeRO-1 across the ranks of a process group)."""
    opt = args.opt.lower()
    eps = args.opt_eps if args.opt_eps is not None else 1e-8
    betas = tuple(args.opt_betas) if args.opt_betas else (0.9, 0.999)
    momentum = getattr(args, "momentum", 0.9)
    opt_kwargs = dict(getattr(args, "opt_kwargs", None) or {})
    eps = float(opt_kwargs.pop("eps", eps))
    betas = tuple(opt_kwargs.pop("betas", betas))
    momentum = float(opt_kwargs.pop("momentum", momentum))
    rms_alpha = float(opt_kwargs.pop("alpha", 0.9))
    amsgrad = bool(opt_kwargs.pop("amsgrad", False))
    if opt_kwargs:
        raise ValueError(f"--opt-kwargs keys not supported by the '{opt}' chain: "
                         f"{sorted(opt_kwargs)} (supported: eps, betas, momentum, alpha, "
                         "amsgrad)")
    schedule = make_schedule(args, steps_per_epoch, lr)
    host_lr = None
    if getattr(args, "use_sched", False) and args.sched == "plateau":
        host_lr = args.warmup_lr if getattr(args, "warmup_epochs", 0) > 0 else schedule(0)
    layer_decay = getattr(args, "layer_decay", None)
    if layer_decay is not None:
        _logger.info(
            "layer_decay=%s: timm-parity grouping — MIRROR-family models have no head "
            "prefix, so every parameter lands in one group with lr scale 1.0 (the "
            "reference's --layer-decay is inert for its own models; see "
            "scale_by_layer_decay)", layer_decay)
    shard = None
    if getattr(args, "optimizer_sharding", False) and distributed.multi():
        shard = (distributed.data_rank(), distributed.data_size())
    return ChainOptimizer(
        _trainable(model, head_only), opt, schedule, weight_decay=args.weight_decay,
        betas=betas, eps=eps, momentum=momentum, rms_alpha=rms_alpha, amsgrad=amsgrad,
        clip_grad=getattr(args, "clip_grad", None),
        clip_mode=getattr(args, "clip_mode", "norm"),
        accum_steps=getattr(args, "grad_accum_steps", 1), host_lr=host_lr, shard=shard,
        sharded=tensor_parallel.sharded_dims(model))


@torch.no_grad()
def reinit_head(model: nn.Module, generator: torch.Generator, scale: Optional[float] = None,
                bias: Optional[float] = None, std: Optional[float] = 0.01) -> None:
    """The linear probe's head init, weight ~ N(0, std^2) drawn on the CPU
    from ``generator`` and a zero bias (``std``); then ``--init-head``'s
    ``scale`` of weight and bias, and its constant ``bias``."""
    head = model.head
    if std is not None:
        head.weight.copy_(torch.empty(head.weight.shape).normal_(0.0, std, generator=generator))
        head.bias.zero_()
    if scale is not None:
        head.weight.mul_(scale)
        head.bias.mul_(scale)
    if bias is not None:
        head.bias.fill_(bias)
