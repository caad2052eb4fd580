"""The MIRROR pretrain train step.

Counterpart of ``mirror_tpu/train/steps.py::make_mirror_train_step`` and its
two in-step updates, in the JAX step's order (steps.py:211-248):

1. renorm the prototypes (L2 over each prototype; the torch weight is
   [P, D], so over dim 1, where the flax kernel [D, P] renorms axis 0);
2. forward and loss;
3. backward;
4. optimizer step;
5. clamp ``logit_scale`` to [0, ln 100].

The step runs eagerly: metrics come back as device tensors and the caller
pulls them to the host only when it logs.
"""

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..losses import MirrorLossWeights, mirror_loss
from ..models.layers import set_generator

LOG_100 = math.log(100.0)
LOSS_NAMES = ("loss", "alignment_loss", "wsi_retention_loss", "rna_retention_loss",
              "style_loss", "cluster_loss")


@torch.no_grad()
def renorm_prototypes(model: nn.Module) -> None:
    w = model.prototypes.weight
    w.div_(torch.linalg.vector_norm(w, dim=1, keepdim=True).clamp_min(1e-12))


@torch.no_grad()
def clamp_logit_scale(model: nn.Module) -> None:
    model.logit_scale.clamp_(0.0, LOG_100)


def _global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def make_mirror_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                           loss_weights: MirrorLossWeights, wsi_mask_ratio: float = 0.75,
                           rna_mask_ratio: float = 0.75,
                           generator: Optional[torch.Generator] = None) -> Callable:
    """``train_step(batch, noise=None) -> metrics``. ``generator`` drives
    every draw of the step (dropout, token masking, VAE eps); ``noise``
    injects the masking noise and eps instead (see ``models.mirror``).
    ``grad_norm`` and ``param_norm`` are the global norms of the gradients
    and of the renormed parameters the gradients were taken at."""
    set_generator(model, generator)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: Dict[str, torch.Tensor],
                   noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        model.train()
        renorm_prototypes(model)
        out = model(batch["wsi"], batch["rna"], wsi_mask_ratio, rna_mask_ratio,
                    generator=generator, noise=noise)
        losses = mirror_loss(*out, weights=loss_weights)
        optimizer.zero_grad(set_to_none=True)
        losses[0].backward()
        with torch.no_grad():
            metrics = {
                "grad_norm": _global_norm([p.grad for p in params if p.grad is not None]),
                "param_norm": _global_norm(params),
            }
        optimizer.step()
        clamp_logit_scale(model)
        metrics.update({name: v.detach() for name, v in zip(LOSS_NAMES, losses)})
        metrics["logit_scale"] = torch.exp(model.logit_scale.detach())
        return metrics

    return train_step


@torch.no_grad()
def mirror_eval_losses(model: nn.Module, batch: Dict[str, torch.Tensor],
                       loss_weights: MirrorLossWeights, wsi_mask_ratio: float = 0.75,
                       rna_mask_ratio: float = 0.75,
                       generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The validation forward (make_mirror_eval_step of the JAX package):
    dropout off, token masking and the VAE draw still stochastic."""
    model.eval()
    out = model(batch["wsi"], batch["rna"], wsi_mask_ratio, rna_mask_ratio,
                generator=generator)
    return dict(zip(LOSS_NAMES, mirror_loss(*out, weights=loss_weights)))
