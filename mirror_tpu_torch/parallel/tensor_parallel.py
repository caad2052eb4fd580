"""Tensor parallelism over the model ranks (``--model-parallel N``).

Counterpart of ``mirror_tpu/parallel/tensor_parallel.py``. The JAX package
annotates parameter shardings on a (data, model) mesh and lets GSPMD insert
the collectives; the port runs N ranks a data rank
(``distributed.set_model_parallel``: a model group is N consecutive ranks)
and writes the collectives out, Megatron's way, so that the results are
those of one rank holding every weight:

- the rules (:func:`param_spec`) are the JAX file's, on the reference's
  ``state_dict`` keys and torch's [out, in] layout: column-parallel leaves
  (``embedding.fc1``, every ``mlp.fc1``, both ``retention_head``s and the
  ``prototypes``) shard the weight's dim 0 and the bias with it, the
  row-parallel ``fc2``s of those MLPs shard dim 1 and keep their bias
  whole, and the RNA embedding's mid-LayerNorm vectors shard along the
  hidden axis. A leaf that does not divide stays whole on every rank
  (logged once, as the JAX code logs it). The JAX docstring says the whole
  WSI encoder stays replicated, but its rule also shards
  ``wsi_encoder.retention_head``; the port follows the rule;
- :func:`shard_model` swaps the matching layers of a built model, in
  place, for the layers below, keeping this rank's slice of each weight.
  A column-parallel :class:`ColumnParallelDense` takes its input as it is
  and all-reduces the input's gradient over the model group; a
  row-parallel :class:`RowParallelDense` all-reduces its partial product
  and then adds its bias once; the mid LayerNorm
  (:class:`ShardedLayerNorm`) all-reduces its fp32 mean, then its centred
  sum of squares; the dropout between them (:class:`ShardedDropout`) draws
  the whole hidden width's mask and keeps this rank's slice, so that N
  ranks draw what one does; the heads whose output meets a loss over the
  whole axis (the prototypes before the log-softmax, the retention heads)
  all-gather their output, and their backward keeps this rank's slice.
  Everything else is whole on every rank (the WSI encoder's Nystrom path
  runs its kernels on every rank, as on the JAX model axis), and its
  gradient is the same on every model rank;
- :func:`shard_state` keeps a rank's slice of a whole ``state_dict`` (a
  port checkpoint, or the JAX parameters through ``convert.py``'s names),
  and :func:`gather_state` gathers the whole one back (a collective of the
  model group), so that a checkpoint written at any N is the one-rank
  file.

With one model rank every function here is the identity.
"""

import logging
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense, Dropout, LayerNorm, Mlp, _cdt
from . import distributed

_logger = logging.getLogger(__name__)

# (trailing key segments) of the JAX rule tables, in torch names: column
# parallel (weight dim 0), row parallel (weight dim 1), vectors (dim 0)
_COL = (
    ("embedding", "fc1", "weight"),
    ("mlp", "fc1", "weight"),
    ("retention_head", "weight"),
    ("prototypes", "weight"),
)
_ROW = (
    ("embedding", "fc2", "weight"),
    ("mlp", "fc2", "weight"),
)
_VEC = (
    ("embedding", "fc1", "bias"),
    ("mlp", "fc1", "bias"),
    ("retention_head", "bias"),
    ("embedding", "norm", "weight"),
    ("embedding", "norm", "bias"),
)
# the column-parallel layers whose output is gathered (no row-parallel
# layer follows them)
_GATHERED = ("retention_head", "prototypes")


def _endswith(names, suffixes) -> bool:
    return any(names[-len(s):] == s for s in suffixes if len(names) >= len(s))


def param_spec(key: str, shape: Sequence[int], model_parallel: int) -> Optional[int]:
    """The dim of the leaf ``key`` (a ``state_dict`` key, torch layout) that
    the model ranks split, or None where it stays whole: the JAX
    ``param_spec`` (``tensor_parallel.py:76-88``), a leaf that does not
    divide by ``model_parallel`` falling back to whole."""
    names = tuple(key.split("."))
    if _endswith(names, _COL):
        return 0 if len(shape) == 2 and shape[0] % model_parallel == 0 else None
    if _endswith(names, _ROW):
        return 1 if len(shape) == 2 and shape[1] % model_parallel == 0 else None
    if _endswith(names, _VEC):
        return 0 if len(shape) == 1 and shape[0] % model_parallel == 0 else None
    return None


def _ruled(key: str) -> bool:
    return _endswith(tuple(key.split(".")), _COL + _ROW + _VEC)


# --------------------------------------------------------------------------
# the model group's collectives, each an autograd Function; with one model
# rank every one is the identity
# --------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """The input of a column-parallel layer: the identity forward; the
    backward sums the ranks' partial gradients (each rank's slice of the
    layer saw the whole input)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce(g, axis="model").to(g.dtype)


class _ReduceFromModel(torch.autograd.Function):
    """The partial products of a row-parallel layer summed in fp32; the
    backward is the identity (the sum's gradient reaches every part)."""

    @staticmethod
    def forward(ctx, x):
        return distributed.all_reduce(x, axis="model").to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _SumOverModel(torch.autograd.Function):
    """A sum over the model ranks that every rank goes on to use on its own
    slice: the backward sums the ranks' gradients too."""

    @staticmethod
    def forward(ctx, x):
        return distributed.all_reduce(x, axis="model").to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce(g, axis="model").to(g.dtype)


class _GatherFromModel(torch.autograd.Function):
    """Every model rank's slice along the last dim, in rank order; the
    backward keeps this rank's slice of the (whole, identical) gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.size = x.shape[-1]
        return torch.cat(distributed.gather_parts(x.contiguous(), "model"), -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, distributed.model_rank() * ctx.size, ctx.size).contiguous()


def _on(fn, x):
    return fn.apply(x) if distributed.model_parallel() > 1 else x


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------

def _slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's slice of ``t`` along ``dim``, a tensor of its own."""
    size = t.shape[dim] // distributed.model_parallel()
    return t.detach().narrow(dim, distributed.model_rank() * size, size).clone()


def _param_like(p: nn.Parameter, data: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(data, requires_grad=p.requires_grad)


class ColumnParallelDense(Dense):
    """A ``Dense`` holding rows [r out / N, (r + 1) out / N) of the weight
    and the bias: its output is this rank's slice of the features, or with
    ``gather`` the whole features."""

    tp_dims = {"weight": 0, "bias": 0}

    @classmethod
    def of(cls, dense: Dense, gather: bool) -> "ColumnParallelDense":
        mp = distributed.model_parallel()
        with torch.device("meta"):
            new = cls(dense.in_features, dense.out_features // mp, dense.bias is not None,
                      dense.dtype, dense.init, dense.init_scale)
        new.weight = _param_like(dense.weight, _slice(dense.weight, 0))
        if dense.bias is not None:
            new.bias = _param_like(dense.bias, _slice(dense.bias, 0))
        new.gather = gather
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(_on(_CopyToModel, x))
        return _on(_GatherFromModel, y) if self.gather else y


class RowParallelDense(Dense):
    """A ``Dense`` holding columns [r in / N, (r + 1) in / N) of the weight
    and the whole bias: the partial products of the ranks' input slices are
    summed over the model group, then the bias is added once."""

    tp_dims = {"weight": 1}

    @classmethod
    def of(cls, dense: Dense) -> "RowParallelDense":
        mp = distributed.model_parallel()
        with torch.device("meta"):
            new = cls(dense.in_features // mp, dense.out_features, dense.bias is not None,
                      dense.dtype, dense.init, dense.init_scale)
        new.weight = _param_like(dense.weight, _slice(dense.weight, 1))
        if dense.bias is not None:
            new.bias = _param_like(dense.bias, dense.bias.detach().clone())
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = _cdt(self.dtype)
        y = _on(_ReduceFromModel, F.linear(x.to(cdt), self.weight.to(cdt)))
        return y if self.bias is None else y + self.bias.to(cdt)


class ShardedLayerNorm(LayerNorm):
    """The LayerNorm of a hidden axis that the model ranks split: the fp32
    mean over the whole axis (a sum over the ranks), then the centred sum
    of squares, as torch's two-pass LayerNorm takes them; this rank's slice
    of the scale and bias."""

    tp_dims = {"weight": 0, "bias": 0}

    @classmethod
    def of(cls, norm: LayerNorm) -> "ShardedLayerNorm":
        full = norm.normalized_shape[0]
        with torch.device("meta"):
            new = cls(full // distributed.model_parallel(), norm.eps, norm.dtype)
        new.full = full
        new.weight = _param_like(norm.weight, _slice(norm.weight, 0))
        new.bias = _param_like(norm.bias, _slice(norm.bias, 0))
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = _on(_SumOverModel, xf.sum(-1, keepdim=True)) / self.full
        xc = xf - mean
        var = _on(_SumOverModel, (xc * xc).sum(-1, keepdim=True)) / self.full
        y = xc * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(_cdt(self.dtype))


class ShardedDropout(Dropout):
    """Dropout of an activation whose last axis the model ranks split: the
    mask of the whole axis is drawn (the draw of one rank holding it all),
    and this rank's slice of it applied."""

    @classmethod
    def of(cls, drop: Dropout, full: int) -> "ShardedDropout":
        new = cls(drop.rate)
        new.generator, new.full = drop.generator, full
        new.train(drop.training)
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        size = x.shape[-1]
        keep = torch.empty(x.shape[:-1] + (self.full,), device=x.device).bernoulli_(
            keep_prob, generator=self.generator)
        keep = keep.narrow(-1, distributed.model_rank() * size, size)
        return torch.where(keep > 0, x / keep_prob, torch.zeros_like(x))


def sharded_dims(module: nn.Module) -> Dict[str, int]:
    """{``state_dict`` key: the dim the model ranks split} of ``module``'s
    sharded leaves (empty for a model that :func:`shard_model` left whole)."""
    out = {}
    for name, mod in module.named_modules():
        for pname, dim in getattr(mod, "tp_dims", {}).items():
            if getattr(mod, pname, None) is not None:
                out[f"{name}.{pname}" if name else pname] = dim
    return out


def shard_model(model: nn.Module) -> nn.Module:
    """Swap ``model``'s layers that :func:`param_spec` shards over the live
    model ranks (``distributed.model_parallel()``) for their parallel forms,
    in place, each holding this rank's slice of its weights; ``model``
    itself. Call it after the weights are drawn or loaded whole, and before
    the optimizer, the EMA copy and DDP see the model."""
    mp = distributed.model_parallel()
    if mp == 1:
        return model
    full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    spec = {k: param_spec(k, shape, mp) for k, shape in full.items()}

    def dim(key):
        return spec.get(key)

    for name, mod in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(mod, Mlp) and dim(f"{prefix}fc1.weight") == 0:
            hidden = mod.fc1.out_features
            mod.fc1 = ColumnParallelDense.of(mod.fc1, gather=False)
            mod.drop1 = ShardedDropout.of(mod.drop1, hidden)
            if isinstance(mod.norm, LayerNorm):
                mod.norm = ShardedLayerNorm.of(mod.norm)
            mod.fc2 = RowParallelDense.of(mod.fc2)
        elif isinstance(mod, Dense) and not isinstance(mod, (ColumnParallelDense,
                                                                RowParallelDense)) \
                and name.split(".")[-1] in _GATHERED and dim(f"{prefix}weight") == 0:
            parent, _, attr = name.rpartition(".")
            setattr(model.get_submodule(parent) if parent else model, attr,
                    ColumnParallelDense.of(mod, gather=True))
    got = sharded_dims(model)
    want = {k: d for k, d in spec.items() if d is not None}
    if got != want:  # a rule matched a leaf of a layer the swap does not know
        raise ValueError(f"model-parallel {mp}: sharded {sorted(got)} but the rules shard "
                         f"{sorted(want)}")
    fallbacks = sorted(k for k in full if _ruled(k) and spec[k] is None)
    if fallbacks:
        _logger.info("model-parallel: %d leaves do not divide model=%d and stay replicated "
                     "(e.g. %s)", len(fallbacks), mp, fallbacks[0])
    return model


# --------------------------------------------------------------------------
# whole state_dicts to a rank's slices and back
# --------------------------------------------------------------------------

def shard_state(state: Mapping[str, torch.Tensor],
                dims: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """This model rank's slice (``dims``: :func:`sharded_dims`) of each leaf
    of a whole ``state_dict``; the other leaves as they are."""
    return {k: _slice(v, dims[k]) if k in dims else v for k, v in state.items()}


def gather_along_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole leaf of this rank's slice ``t`` (every model rank's slice
    along ``dim``, in rank order): a collective of the model group."""
    if distributed.model_parallel() == 1:
        return t
    return torch.cat(distributed.gather_parts(t.detach().contiguous(), "model"), dim)


def gather_state(state: Mapping[str, torch.Tensor],
                 dims: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` of this rank's slices: the inverse of
    :func:`shard_state`. Every model rank calls it."""
    return {k: gather_along_model(v, dims[k]) if k in dims else v for k, v in state.items()}


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` at the one-rank keys and shapes (gathered from
    the model group where the module is sharded: every rank calls it)."""
    return gather_state(module.state_dict(), sharded_dims(module))


def load_full_state_dict(module: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """``module.load_state_dict`` of a whole (one-rank) ``state_dict``, each
    sharded leaf cut to this rank's slice."""
    module.load_state_dict(shard_state(state, sharded_dims(module)))


def leaf_norms(tensors: Sequence[torch.Tensor],
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of each whole leaf, ``tensors`` (fp32) being this rank's
    slices where the bool ``mask`` is set (leaves the model ranks split):
    their squares are summed over the model group. ``mask`` None: no leaf
    is split. The global norm is the vector norm of the result."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    if mask is None or distributed.model_parallel() == 1:
        return norms
    split = distributed.all_reduce(norms * norms, axis="model").sqrt().to(norms.dtype)
    return torch.where(mask, split, norms)


def sum_over_model(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``values`` with the entries under the bool ``mask`` summed over the
    model group (each a partial sum of squares of a leaf the ranks split),
    the rest as they are."""
    return torch.where(mask, distributed.all_reduce(values, axis="model").to(values.dtype),
                       values)
