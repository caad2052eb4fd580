"""Optimizer factory, the port's subset of ``mirror_tpu/train/optim.py``.

What the pretrain template runs is ported: ``adam`` (torch's coupled weight
decay, as timm builds it) and ``adamw`` (decoupled), each with timm's
parameter groups (no weight decay on parameters of ndim <= 1: biases, norms,
the logit scale), at a constant learning rate. Every other optimizer, the
timm schedules, gradient clipping, layer-wise decay and the model EMA are
refused by :func:`refuse_unported` with a message naming the flag: they
are ROADMAP item 8, still to port.
"""

from typing import Any, Dict, List

import torch
from torch import nn

_ROADMAP = "not ported to the PyTorch port yet (ROADMAP item 8)"


def refuse_unported(args) -> None:
    """Raise SystemExit naming the first optimizer-side flag the port does
    not implement that is set away from what the port runs."""
    if args.opt.lower() not in ("adam", "adamw"):
        raise SystemExit(f"--opt {args.opt}: only adam and adamw are ported; the rest are "
                         f"{_ROADMAP}")
    for flag, value, ported in (
        ("--use-sched", args.use_sched, False),
        ("--clip-grad", args.clip_grad, None),
        ("--layer-decay", args.layer_decay, None),
        ("--model-ema", args.model_ema, False),
    ):
        if value != ported:
            raise SystemExit(f"{flag}={value!r}: schedules, clipping, layer decay and "
                             f"the model EMA are {_ROADMAP}")


def param_groups(model: nn.Module, weight_decay: float) -> List[Dict[str, Any]]:
    """timm's ``param_groups_weight_decay``: decay on ndim > 1, none on the
    rest (the JAX package's ``_no_decay_mask``)."""
    decay, no_decay = [], []
    for p in model.parameters():
        if p.requires_grad:
            (decay if p.ndim > 1 else no_decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def make_optimizer(args, model: nn.Module, lr: float) -> torch.optim.Optimizer:
    refuse_unported(args)
    kwargs = dict(getattr(args, "opt_kwargs", None) or {})
    eps = float(kwargs.pop("eps", args.opt_eps if args.opt_eps is not None else 1e-8))
    betas = tuple(kwargs.pop("betas", args.opt_betas or (0.9, 0.999)))
    amsgrad = bool(kwargs.pop("amsgrad", False))
    if kwargs:
        raise SystemExit(f"--opt-kwargs {sorted(kwargs)}: only eps, betas and amsgrad are "
                         "ported")
    cls = torch.optim.AdamW if args.opt.lower() == "adamw" else torch.optim.Adam
    return cls(param_groups(model, args.weight_decay), lr=lr, betas=betas, eps=eps,
               amsgrad=amsgrad)
