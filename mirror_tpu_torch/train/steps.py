"""The train and eval steps: MIRROR pretraining, the CLIP baseline,
subtyping, survival; and the model EMA.

Counterpart of ``mirror_tpu/train/steps.py``. The pretrain step
(``make_mirror_train_step``) runs its two in-step updates in the JAX step's
order (steps.py:211-248):

1. renorm the prototypes (L2 over each prototype; the torch weight is
   [P, D], so over dim 1, where the flax kernel [D, P] renorms axis 0);
2. forward and loss;
3. backward;
4. optimizer step;
5. clamp ``logit_scale`` to [0, ln 100].

The downstream steps (steps.py:382-505) take the classifier's fp32 logits
to label-smoothed cross-entropy (subtyping) or a discrete survival loss,
each over the batch's ``valid`` rows. Their eval steps return the fp32
logits; the caller takes metrics over the valid rows of the whole set.

The CLIP steps (steps.py:306-380) take InfoNCE of the dual encoder's two
embeddings; the eval step masks the batch's padded rows by ``valid``.

Every train step reports the lr of the next real update (``lr``) and calls
``optimizer.step()`` (``optim.ChainOptimizer``), which updates on every
call or, under gradient accumulation, on every k-th; a :class:`ModelEma`
then advances once per real update (steps.py:104-146).

The steps run eagerly: metrics come back as device tensors (the lr as a
float) and the caller pulls them to the host only when it logs.

Under a process group (``parallel/distributed.py``) each train step runs
the model wrapped in ``DistributedDataParallel`` (:func:`data_parallel`),
whose gradient is the average over the ranks; the eval steps run the bare
module. The contrastive terms take ``negatives`` (the rank's own or the
global batch's, ``losses``), and the reported losses are the global ones.
With several ranks the draws are :class:`RankDraws`'s: the masking noise and
the VAE eps are drawn for the GLOBAL batch from the shared step generator
and each rank keeps its block, so with dropout 0 the ranks draw what one
process draws; the dropout draws come from a generator of the rank's own,
seeded each step from one draw of the shared generator and the rank, so
they differ between ranks and follow from the one generator state that a
checkpoint holds. With one process every draw is the generator's, as
before. The prototype renorm, the logit-scale clamp, clipping and the EMA
run on every rank on the same averaged gradients, so the weights stay the
same bits on every rank.
"""

import copy
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..losses import (
    MirrorLossWeights,
    ce_surv_loss,
    contrastive_info_nce,
    mirror_loss,
    nll_surv_loss,
    reduce_info_nce,
    reduce_over_ranks,
)
from ..models.layers import Dropout, DropPath, set_generator
from ..parallel import distributed, tensor_parallel

LOG_100 = math.log(100.0)
LOSS_NAMES = ("loss", "alignment_loss", "wsi_retention_loss", "rna_retention_loss",
              "style_loss", "cluster_loss")


@torch.no_grad()
def renorm_prototypes(model: nn.Module) -> None:
    """Each prototype (a row of the [P, D] weight) to unit L2 norm: local
    under tensor parallelism, where a rank holds whole rows."""
    w = model.prototypes.weight
    w.div_(torch.linalg.vector_norm(w, dim=1, keepdim=True).clamp_min(1e-12))


@torch.no_grad()
def clamp_logit_scale(model: nn.Module) -> None:
    model.logit_scale.clamp_(0.0, LOG_100)


def _global_norm(named, dims: Dict[str, int]) -> torch.Tensor:
    """The global L2 norm of the (name, tensor) pairs in fp32, over whole
    leaves: the slices of a model-sharded model's split leaves (``dims``)
    summed over the model ranks (``tensor_parallel.leaf_norms``)."""
    tensors = [t.detach().float() for _, t in named]
    mask = torch.tensor([n in dims for n, _ in named], device=tensors[0].device) \
        if dims else None
    return torch.linalg.vector_norm(tensor_parallel.leaf_norms(tensors, mask))


def watch_stats(named_params, dims: Optional[Dict[str, int]] = None
                ) -> Dict[str, torch.Tensor]:
    """``--wandb-watch``'s stats (``watch_stats`` of the JAX package, the
    ``wandb.watch`` histograms as moments): the L2 norm, mean and
    population std of each gradient and each parameter, in fp32, as device
    scalars under ``watch/{gradients,parameters}/<name>/{norm,mean,std}``,
    each of the whole leaf (a model-sharded leaf, ``dims``, gathered first).
    The harness sums them like the other metrics and hands them to wandb
    only."""
    dims = dims or {}
    out: Dict[str, torch.Tensor] = {}
    named = [(n, p) for n, p in named_params if p.grad is not None]
    for kind, tensors in (("gradients", [p.grad for _, p in named]),
                          ("parameters", [p for _, p in named])):
        for (name, _), t in zip(named, tensors):
            x = t.detach().float()
            if name in dims:
                x = tensor_parallel.gather_along_model(x, dims[name])
            out[f"watch/{kind}/{name}/norm"] = torch.linalg.vector_norm(x)
            out[f"watch/{kind}/{name}/mean"] = x.mean()
            out[f"watch/{kind}/{name}/std"] = x.std(correction=0)
    return out


def ema_decay_at(decay: float, warmup: bool, n_updates: int) -> float:
    """timm ``ModelEmaV3.get_decay`` in the JAX package's fp32: 0 at the
    first update (the EMA takes the weights), then ``decay``, or with
    ``warmup`` the ramp 1 - (1 + step)^(-2/3) clipped to [0, decay], step
    being the updates before this one."""
    step = np.float32(n_updates) - np.float32(1)
    if step <= 0:
        return 0.0
    if not warmup:
        return float(np.float32(decay))
    d = np.float32(1) - np.power(np.float32(1) + step, np.float32(-2.0 / 3.0))
    return float(np.clip(d, np.float32(0), np.float32(decay)))


class ModelEma:
    """The model EMA (``--model-ema``): ``module`` is a copy of the model
    whose fp32 parameters on the device follow e <- d e + (1 - d) p after
    each real update (:func:`ema_decay_at`). The harness evaluates it beside
    the live model and saves its ``state_dict`` as ``state_dict_ema``."""

    def __init__(self, model: nn.Module, decay: float = 0.9998, warmup: bool = False):
        self.module = copy.deepcopy(model).eval()
        for p in self.module.parameters():
            p.requires_grad_(False)
        self.decay, self.warmup = decay, warmup
        self.updates = 0
        self._ema = list(self.module.parameters())
        self._live = list(model.parameters())

    @torch.no_grad()
    def update(self) -> None:
        self.updates += 1
        d = ema_decay_at(self.decay, self.warmup, self.updates)
        torch._foreach_mul_(self._ema, d)
        torch._foreach_add_(self._ema, self._live, alpha=1.0 - d)


def data_parallel(model: nn.Module, find_unused: bool = False) -> nn.Module:
    """``model`` wrapped in ``DistributedDataParallel`` over the data ranks
    when a process group is up (on the card with the model's device as its
    one device), else ``model``. ``find_unused`` for a forward that leaves
    parameters out (the downstream ``--wsi-feature-only``)."""
    if not distributed.initialized():
        return model
    from torch.nn.parallel import DistributedDataParallel

    device = next(model.parameters()).device
    kwargs = {"device_ids": [device]} if device.type == "cuda" else {}
    return DistributedDataParallel(model, find_unused_parameters=find_unused,
                                   process_group=distributed.data_group(), **kwargs)


class RankDraws:
    """A train step's draws. With one process (or none given) the model's
    dropout draws from ``generator`` and :meth:`step` does nothing. With
    several data ranks the dropout draws from a generator of the rank's
    own, and :meth:`step`, before each step, seeds it from one draw of the
    shared ``generator`` and the data rank when the model has a live
    dropout (with none the shared stream is the one process's). The model
    ranks of one data rank draw alike: a sharded activation's dropout draws
    the whole width and keeps its slice (``tensor_parallel``)."""

    def __init__(self, model: nn.Module, generator: Optional[torch.Generator]):
        self.generator = generator
        self.own = None
        if distributed.multi() and generator is not None:
            self.own = torch.Generator(device=generator.device)
            self.live = any(isinstance(m, (Dropout, DropPath)) and m.rate > 0
                            for m in model.modules())
            set_generator(model, self.own)
        else:
            set_generator(model, generator)

    def step(self) -> None:
        if self.own is None or not self.live:
            return
        seed = int(torch.randint(0, 2**62, (1,), generator=self.generator,
                                 device=self.generator.device).item())
        self.own.manual_seed((seed * 1_000_003 + distributed.data_rank()) % 2**63)


def _update(optimizer, ema: Optional[ModelEma],
            after_update: Optional[Callable] = None) -> None:
    """One optimizer call; on a real update the step's post-update work
    (the logit-scale clamp), then the EMA."""
    if optimizer.step():
        if after_update is not None:
            after_update()
        if ema is not None:
            ema.update()


def make_mirror_train_step(model: nn.Module, optimizer,
                           loss_weights: MirrorLossWeights, wsi_mask_ratio: float = 0.75,
                           rna_mask_ratio: float = 0.75,
                           generator: Optional[torch.Generator] = None,
                           ema: Optional[ModelEma] = None, watch: bool = False,
                           negatives: str = "local") -> Callable:
    """``train_step(batch, noise=None) -> metrics``. ``generator`` drives
    every draw of the step (dropout, token masking, VAE eps; across ranks
    see :class:`RankDraws`); ``noise`` injects the masking noise and eps
    instead (see ``models.mirror``; across ranks the rank's block).
    ``negatives`` is the alignment term's (``losses.clip_loss``).
    ``grad_norm`` and ``param_norm`` are the global norms of the gradients
    and of the renormed parameters the gradients were taken at; ``watch``
    adds :func:`watch_stats` of those."""
    draws = RankDraws(model, generator)
    net = data_parallel(model)
    named = list(model.named_parameters())
    trained = [(n, p) for n, p in named if p.requires_grad]
    dims = tensor_parallel.sharded_dims(model)

    def train_step(batch: Dict[str, torch.Tensor],
                   noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        model.train()
        renorm_prototypes(model)
        draws.step()
        b = batch["wsi"].shape[0]
        if noise is None and distributed.multi():
            draws_all = model.draw_noise(b * distributed.data_size(), batch["wsi"].shape[1],
                                         generator, batch["wsi"].device)
            noise = {k: distributed.own_rows(v) for k, v in draws_all.items()}
        out = net(batch["wsi"], batch["rna"], wsi_mask_ratio, rna_mask_ratio,
                  generator=generator, noise=noise)
        losses = mirror_loss(*out, weights=loss_weights, negatives=negatives)
        model.zero_grad(set_to_none=True)
        losses[0].backward()
        with torch.no_grad():
            metrics = {
                "grad_norm": _global_norm([(n, p.grad) for n, p in trained
                                           if p.grad is not None], dims),
                "param_norm": _global_norm(trained, dims),
                "lr": optimizer.current_lr(),
            }
            if watch:
                metrics.update(watch_stats(named, dims))
        _update(optimizer, ema, lambda: clamp_logit_scale(model))
        metrics.update(zip(LOSS_NAMES, reduce_over_ranks(losses, loss_weights, b, negatives)))
        metrics["logit_scale"] = torch.exp(model.logit_scale.detach())
        return metrics

    return train_step


@torch.no_grad()
def mirror_eval_losses(model: nn.Module, batch: Dict[str, torch.Tensor],
                       loss_weights: MirrorLossWeights, wsi_mask_ratio: float = 0.75,
                       rna_mask_ratio: float = 0.75,
                       generator: Optional[torch.Generator] = None,
                       negatives: str = "local") -> Dict[str, torch.Tensor]:
    """The validation forward (make_mirror_eval_step of the JAX package):
    dropout off, token masking and the VAE draw still stochastic. Across
    ranks the draws are made for the global batch (each rank keeping its
    block), the batch's ``valid`` takes its padded rows out, and the
    losses are the global ones (``losses.reduce_over_ranks``)."""
    model.eval()
    b, n = batch["wsi"].shape[0], distributed.data_size()
    draws_all = model.draw_noise(b * n, batch["wsi"].shape[1], generator, batch["wsi"].device)
    noise = {k: distributed.own_rows(v) for k, v in draws_all.items()}
    out = model(batch["wsi"], batch["rna"], wsi_mask_ratio, rna_mask_ratio, noise=noise)
    valid = batch.get("valid")
    losses = mirror_loss(*out, weights=loss_weights, negatives=negatives, valid=valid)
    n_valid = b if valid is None else valid.sum()
    return dict(zip(LOSS_NAMES, reduce_over_ranks(losses, loss_weights, n_valid, negatives)))


def _make_train_step(model: nn.Module, optimizer, loss_of: Callable,
                     generator: Optional[torch.Generator],
                     ema: Optional[ModelEma], watch: bool = False,
                     find_unused: bool = False) -> Callable:
    """``train_step(batch) -> {"loss", "grad_norm", "param_norm", "lr"}``
    with ``loss_of(net, batch)`` the (rank's loss, reported global loss) of
    the forward of ``net`` (the model, or its DDP wrapper): the whole model
    is differentiated, as in the JAX step, and ``optimizer`` updates what it
    holds (every parameter, or the head alone under the linear probe, where
    the JAX step discards the trunk's updates); the norms (and ``watch``'s
    :func:`watch_stats`) are over every parameter."""
    draws = RankDraws(model, generator)
    net = data_parallel(model, find_unused)
    named = list(model.named_parameters())
    dims = tensor_parallel.sharded_dims(model)

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        draws.step()
        loss, reported = loss_of(net, batch)
        model.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            metrics = {
                "loss": reported,
                "grad_norm": _global_norm([(n, p.grad) for n, p in named
                                           if p.grad is not None], dims),
                "param_norm": _global_norm(named, dims),
                "lr": optimizer.current_lr(),
            }
            if watch:
                metrics.update(watch_stats(named, dims))
        _update(optimizer, ema)
        return metrics

    return train_step


def make_clip_train_step(model: nn.Module, optimizer, temperature: float = 0.1,
                         generator: Optional[torch.Generator] = None,
                         ema: Optional[ModelEma] = None, watch: bool = False,
                         negatives: str = "local") -> Callable:
    """The CLIP baseline's step: in-batch InfoNCE of the dual encoder's
    (wsi, rna) embeddings over the rank's or the global batch's negatives
    (``losses.contrastive_info_nce``); ``generator`` drives its dropout."""
    def loss_of(net, batch):
        wsi, rna = net(batch["wsi"], batch["rna"])
        loss = contrastive_info_nce(wsi, rna, temperature, negatives)
        return loss, reduce_info_nce(loss, wsi.shape[0], negatives)

    return _make_train_step(model, optimizer, loss_of, generator, ema, watch)


def make_clip_eval_step(model: nn.Module, temperature: float = 0.1,
                        negatives: str = "local") -> Callable:
    """``eval_step(batch) -> {"loss"}``, dropout off; the batch's ``valid``
    takes the padded rows out of the loss and of the negatives; across
    ranks the loss is the global one."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        wsi, rna = model(batch["wsi"], batch["rna"])
        valid = batch.get("valid")
        loss = contrastive_info_nce(wsi, rna, temperature, negatives, valid=valid)
        return {"loss": reduce_info_nce(loss, wsi.shape[0] if valid is None else valid.sum(),
                                        negatives)}

    return eval_step


def smoothed_xent(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.0,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy with label smoothing (timm's LabelSmoothingCrossEntropy),
    in fp32; ``valid`` ([B] 0/1) drops padded rows from the mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if smoothing > 0:
        nll = (1.0 - smoothing) * nll - smoothing * logp.mean(-1)
    if valid is not None:
        valid = valid.to(nll.dtype)
        return (nll * valid).sum() / valid.sum().clamp_min(1.0)
    return nll.mean()


def _make_downstream_train_step(model: nn.Module, optimizer, loss_fn: Callable,
                                wsi_only: bool, generator: Optional[torch.Generator],
                                ema: Optional[ModelEma], watch: bool) -> Callable:
    """The downstream losses are means over the batch's valid rows. Across
    ranks a rank's share of the global mean is its mean times its valid
    rows over the global count, so the rank's loss is scaled by R n_rank /
    n_global (DDP's average then gives the global mean's gradient, padded
    tails included) and the reported loss is the global mean."""
    def loss_of(net, batch):
        logits = net(batch["wsi"], None if wsi_only else batch["rna"]).float()
        loss = loss_fn(logits, batch)
        if not distributed.multi():
            return loss, loss.detach()
        valid = batch.get("valid")
        n = valid.float().sum() if valid is not None else \
            torch.tensor(float(logits.shape[0]), device=logits.device)
        sums = distributed.all_reduce(torch.stack([loss.detach().float() * n, n]))
        share = (distributed.data_size() * n / sums[1].clamp_min(1.0)).to(loss.dtype)
        return loss * share, sums[0] / sums[1].clamp_min(1.0)

    return _make_train_step(model, optimizer, loss_of, generator, ema, watch,
                            find_unused=wsi_only)


def make_classifier_train_step(model: nn.Module, optimizer, smoothing: float = 0.0,
                               wsi_only: bool = False,
                               generator: Optional[torch.Generator] = None,
                               ema: Optional[ModelEma] = None, watch: bool = False) -> Callable:
    def loss_fn(logits, batch):
        return smoothed_xent(logits, batch["label"], smoothing, valid=batch.get("valid"))

    return _make_downstream_train_step(model, optimizer, loss_fn, wsi_only, generator, ema,
                                       watch)


def survival_loss(loss_name: str, logits: torch.Tensor, batch: Dict[str, torch.Tensor],
                  alpha: float = 0.0) -> torch.Tensor:
    """``nll_surv`` (with ``alpha``) or ``ce_surv`` of the batch's labels and
    censorship, over its ``valid`` rows."""
    valid = batch.get("valid")
    if loss_name == "ce_surv":
        return ce_surv_loss(logits, batch["label"], batch["censorship"], valid=valid)
    if loss_name != "nll_surv":
        raise ValueError(f"unknown survival loss {loss_name!r}")
    return nll_surv_loss(logits, batch["label"], batch["censorship"], alpha=alpha,
                         valid=valid)


def make_survival_train_step(model: nn.Module, optimizer, loss_name: str = "nll_surv",
                             loss_alpha: float = 0.0, wsi_only: bool = False,
                             generator: Optional[torch.Generator] = None,
                             ema: Optional[ModelEma] = None, watch: bool = False) -> Callable:
    def loss_fn(logits, batch):
        return survival_loss(loss_name, logits, batch, loss_alpha)

    return _make_downstream_train_step(model, optimizer, loss_fn, wsi_only, generator, ema,
                                       watch)


def make_classifier_eval_step(model: nn.Module, wsi_only: bool = False) -> Callable:
    """``eval_step(batch) -> fp32 logits``, dropout off (the survival eval
    step is the same function: ``make_survival_eval_step``)."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        return model(batch["wsi"], None if wsi_only else batch["rna"]).float()

    return eval_step


make_survival_eval_step = make_classifier_eval_step


def survival_risk(logits) -> torch.Tensor:
    """risk = -sum_t S(t), S(t) = prod_{j<=t} (1 - sigmoid(logit_j))."""
    hazards = torch.sigmoid(torch.as_tensor(logits, dtype=torch.float32))
    return -torch.cumprod(1.0 - hazards, dim=1).sum(dim=1)
