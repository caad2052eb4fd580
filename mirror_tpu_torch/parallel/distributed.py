"""Multi-process data parallelism: one process per device, ``torch.distributed``.

Counterpart of ``mirror_tpu/parallel/distributed.py`` and of the parts of
``mirror_tpu/parallel/mesh.py`` that a process group needs. The JAX package
runs one SPMD program over a ``data`` mesh axis; the port runs R processes,
each on its own device, with the model wrapped in ``DistributedDataParallel``
(``train/steps.py``), so an R-rank run computes what the R-way data mesh
computes:

- :func:`session` is the rendezvous (``maybe_initialize`` there). It takes
  the JAX package's env contract, ``MIRROR_COORDINATOR=host:port`` (or a
  ``file://`` / ``tcp://`` URL) with ``MIRROR_NUM_PROCESSES`` and
  ``MIRROR_PROCESS_ID``, or torchrun's (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); ``--distributed`` asks
  for one of them. The backend is NCCL on a CUDA device and gloo on the CPU
  (``MIRROR_DIST_BACKEND`` overrides it), the device ``cuda:LOCAL_RANK``,
  set before the group is made, and ``init_process_group`` is given a
  timeout (``MIRROR_DIST_TIMEOUT`` seconds, default 600), so a rank that
  never arrives fails the run instead of hanging it;
- the loader cuts each GLOBAL batch into per-rank blocks (:func:`local_block`:
  rank p owns rows [p * b / R, (p + 1) * b / R)), so the blocks in rank order
  are the one-process batch; :func:`allgather_rows` puts them back together
  on every rank, and :func:`gather_rows` does so for a tensor in the
  autograd graph (its backward sums the incoming gradients over the ranks
  and keeps the rank's block);
- ``create_mesh``, ``shard_batch`` and ``replicate`` have no counterpart:
  the group is the mesh, a rank moves its block to its device, and DDP
  broadcasts rank 0's parameters when it wraps the model (every rank builds
  the same weights from the seed anyway).

With ``--model-parallel N`` (tensor parallelism, ``tensor_parallel.py``)
the group is ``create_mesh``'s (data, model) grid, ``reshape(R // N, N)``:
global rank r is data rank r // N and model rank r % N, a model group is N
consecutive ranks and a data group the ranks of one model rank, at stride
N (:func:`set_model_parallel`, which :func:`session` calls). Every helper
that pools the BATCH (:func:`own_rows`, :func:`process_info`,
:func:`all_reduce`, :func:`allgather_rows`, :func:`gather_rows`,
:func:`broadcast_`, :func:`refuse_indivisible`) and :func:`multi` run over
the data group, so the data-parallel math reads the data rank and size;
:func:`agree` and :func:`is_main` stay the whole group's, and so do the
collectives of context parallelism, which runs without a model axis. With
no model axis the data group is the whole group.

With no group every helper is the identity of one process.
"""

import contextlib
import datetime
import logging
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600.0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Rank 0, or the one process: the owner of the run directory."""
    return rank() == 0


# the (data, model) layout of the live group: the model axis' size and
# this rank's two subgroups (None: the whole group, where the axis is all
# of it)
_PLAIN = {"model_parallel": 1, "data": None, "model": None}
_LAYOUT = dict(_PLAIN)


def model_parallel() -> int:
    """N of ``--model-parallel N``: the ranks that share one data rank."""
    return _LAYOUT["model_parallel"] if initialized() else 1


def data_size() -> int:
    return world_size() // model_parallel()


def data_rank() -> int:
    return rank() // model_parallel()


def model_rank() -> int:
    return rank() % model_parallel()


def data_group():
    """The process group of this rank's data ranks (None: the whole group)."""
    return _LAYOUT["data"]


def multi() -> bool:
    """More than one data rank: the collectives of the data-parallel math
    run."""
    return data_size() > 1


def refuse_model_parallel(model_parallel_: int, world: int) -> None:
    """``create_mesh``'s assertion (``mirror_tpu/parallel/mesh.py:32``) as a
    refusal by name: N must be at least 1 and divide the world size."""
    if model_parallel_ < 1 or world % model_parallel_:
        raise SystemExit(
            f"--model-parallel {model_parallel_}: tensor parallelism needs a world size that "
            f"is a multiple of {model_parallel_} (this run has {world} process"
            f"{'es' if world != 1 else ''}); start a multiple of {max(model_parallel_, 1)} "
            "ranks, or leave --model-parallel at 1")


def set_model_parallel(model_parallel_: int) -> None:
    """Cut the live group into ``create_mesh``'s grid of data x model ranks
    (``model_parallel_`` consecutive ranks a data rank). Every rank calls
    it: each subgroup is made on all of them, in the same order. 1 restores
    the plain layout."""
    world = world_size()
    refuse_model_parallel(model_parallel_, world)
    mp, r = model_parallel_, rank()
    _LAYOUT.update(_PLAIN)
    if mp == 1:
        return
    for d in range(world // mp):
        group = dist.new_group([d * mp + m for m in range(mp)])
        if r // mp == d:
            _LAYOUT["model"] = group
    for m in range(mp):
        group = dist.new_group(list(range(m, world, mp)))
        if r % mp == m:
            _LAYOUT["data"] = group
    _LAYOUT.update(model_parallel=mp)
    _logger.info("model-parallel: rank %d is data rank %d/%d, model rank %d/%d", r,
                 data_rank(), data_size(), model_rank(), mp)


def _axis(axis: str):
    """(process group, this rank's index in it, its size) of ``axis``:
    ``data``, ``model`` or ``world``."""
    if axis == "data":
        return _LAYOUT["data"], data_rank(), data_size()
    if axis == "model":
        return _LAYOUT["model"], model_rank(), model_parallel()
    return None, rank(), world_size()


def process_info(process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> Tuple[int, int]:
    """(process_index, process_count), defaulting to the live group's data
    rank and size (0 and 1 without one)."""
    if process_index is None:
        process_index = data_rank()
    if process_count is None:
        process_count = data_size()
    return process_index, process_count


def local_block(chunk: np.ndarray, process_index: int, process_count: int) -> np.ndarray:
    """This rank's rows of one GLOBAL batch chunk, whose length divides over
    the ranks: rank p owns rows [p * lbs, (p + 1) * lbs), so the blocks in
    rank order are the chunk."""
    n = len(chunk)
    if n % process_count:
        raise ValueError(f"{n} rows do not divide over {process_count} processes")
    lbs = n // process_count
    return chunk[process_index * lbs:(process_index + 1) * lbs]


def own_rows(x):
    """This rank's rows of a global-batch array or tensor
    (:func:`local_block` of the live group's data ranks); ``x`` with one
    process."""
    return local_block(x, data_rank(), data_size())


def _env_contract() -> Optional[Tuple[str, int, int, Optional[int]]]:
    """(init_method, world size, rank, local rank or None) from the env,
    or None where neither contract is set."""
    coord = os.environ.get("MIRROR_COORDINATOR")
    if coord:
        method = coord if "://" in coord else f"tcp://{coord}"
        local = os.environ.get("LOCAL_RANK")
        return (method, int(os.environ["MIRROR_NUM_PROCESSES"]),
                int(os.environ["MIRROR_PROCESS_ID"]), None if local is None else int(local))
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return ("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                int(os.environ.get("LOCAL_RANK", 0)))
    return None


def maybe_initialize(args=None, device: Optional[torch.device] = None) -> torch.device:
    """Join the process group when the env or ``args.distributed`` asks for
    one; return this rank's device (``device`` itself on the CPU or
    without a group). A group made before the call is kept."""
    device = torch.device(device or getattr(args, "device", "cpu"))
    contract = _env_contract()
    if initialized() or (contract is None and not getattr(args, "distributed", False)):
        if initialized() and device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if contract is None:
        raise SystemExit("--distributed: set torchrun's env (RANK, WORLD_SIZE, LOCAL_RANK, "
                         "MASTER_ADDR, MASTER_PORT; `torchrun --nproc-per-node R -m ...`) or "
                         "MIRROR_COORDINATOR=host:port, MIRROR_NUM_PROCESSES and "
                         "MIRROR_PROCESS_ID")
    method, world, rank_, local = contract
    backend = os.environ.get("MIRROR_DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if local is None:
            local = rank_ % max(torch.cuda.device_count(), 1)
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    timeout = float(os.environ.get("MIRROR_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device  # binds the communicator to this rank's card
    dist.init_process_group(backend, init_method=method, world_size=world, rank=rank_,
                            timeout=datetime.timedelta(seconds=timeout), **kwargs)
    _logger.info("distributed: rank %d/%d on %s (%s, %s)", rank_, world, device, backend,
                 method)
    return device


@contextlib.contextmanager
def session(args, device: torch.device) -> Iterator[torch.device]:
    """:func:`maybe_initialize` for the length of a run, cut into data x
    model ranks by ``args.model_parallel`` (:func:`set_model_parallel`;
    refused by name where the world size does not divide by it); the group
    is destroyed on the way out if this call made it."""
    mp = int(getattr(args, "model_parallel", 1) or 1)
    refuse_model_parallel(mp, world_size() if initialized() else (
        (_env_contract() or (None, 1))[1]))
    made = not initialized()
    device = maybe_initialize(args, device)
    made = made and initialized()
    try:
        if initialized():
            set_model_parallel(mp)
        yield device
    finally:
        _LAYOUT.update(_PLAIN)
        if made:
            dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a host array travels for a collective: the card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_rows(array) -> np.ndarray:
    """Concatenate every data rank's host array (equal shapes) along axis 0
    in rank order, the global row order under the blocked layout; the array
    itself with one data rank."""
    array = np.asarray(array)
    if not multi():
        return array
    dtype = array.dtype
    t = torch.from_numpy(np.ascontiguousarray(array.astype(np.float64) if dtype == bool
                                              else array)).to(_comm_device())
    parts = [torch.empty_like(t) for _ in range(data_size())]
    dist.all_gather(parts, t, group=_LAYOUT["data"])
    return torch.cat(parts).cpu().numpy().astype(dtype)


def all_reduce(t: torch.Tensor, op: str = "sum", axis: str = "data") -> torch.Tensor:
    """``t`` reduced over the ranks of ``axis`` (the data ranks, the model
    ranks or the whole group; ``sum`` or ``max``) in fp32, a new tensor on
    t's device (under gloo it travels through the CPU); ``t`` in fp32 with
    one rank on the axis. Outside autograd."""
    group, _, size = _axis(axis)
    out = t.detach().float().to(_comm_device() if size > 1 else t.device, copy=True)
    if size > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=group)
    return out.to(t.device)


def agree(flag: bool, device: Optional[torch.device] = None) -> bool:
    """True on every rank of the whole group when any rank says True (a
    one-element MAX all-reduce); ``flag`` with one process."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device or _comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank tensor, in the autograd graph where x
    is: :func:`gather_along` its rows over the data ranks (the backward sums
    the incoming gradient over them, each rank differentiating its own copy
    of a function of the whole batch, and keeps this rank's rows); ``x``
    itself with one data rank."""
    return gather_along(x, 0, "data")


def broadcast_(tensors: Sequence[torch.Tensor], src: int) -> None:
    """Broadcast ``tensors`` (each rank holds the same shapes) from data
    rank ``src`` over the data group in place, one collective per dtype:
    flattened into one buffer."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    mine = data_rank() == src
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group]) if mine else \
            torch.empty(sum(t.numel() for t in group), dtype=group[0].dtype,
                        device=group[0].device)
        # src is a data rank; the collective takes the global rank
        dist.broadcast(flat, src=src * model_parallel() + model_rank(), group=_LAYOUT["data"])
        if not mine:
            for t, piece in zip(group, flat.split([t.numel() for t in group])):
                t.detach().copy_(piece.view(t.shape))


# --------------------------------------------------------------------------
# The collectives of context parallelism (``context_parallel.py``): one long
# sequence split over the ranks. Each is an autograd Function whose backward
# is the matching collective, and each is the identity of one process (no
# collective) with one rank. The rule they keep: a tensor that every rank
# holds alike (replicated) gets as gradient the sum of every rank's partial,
# summed once, at the collective that made it. The all-reduce SUM of the
# ranks' attention parts, whose backward all-reduces the incoming gradient,
# is ``context_parallel.KvCombine``'s own (its forward and backward).
# --------------------------------------------------------------------------

def gather_parts(x: torch.Tensor, axis: str = "world") -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes) on ``axis`` (:func:`_axis`), in
    rank order, on x's device. They travel as bytes, so any dtype goes over
    any backend unchanged, and under gloo through the CPU
    (:func:`_comm_device`)."""
    group, _, size = _axis(axis)
    flat = x.detach().contiguous().reshape(-1).view(torch.uint8).to(_comm_device())
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    return [p.to(x.device).view(x.dtype).view(x.shape) for p in parts]


class _GatherAlong(torch.autograd.Function):
    """Every rank's block on ``axis`` concatenated along ``dim`` in rank
    order; the backward sums the incoming gradient over those ranks (each
    rank's is a partial) and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, dim: int, axis: str):
        ctx.dim, ctx.size, ctx.axis = dim, x.shape[dim], axis
        return torch.cat(gather_parts(x, axis), dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, axis=ctx.axis).to(g.dtype)
        index = _axis(ctx.axis)[1]
        return g.narrow(ctx.dim, index * ctx.size, ctx.size).contiguous(), None, None


def gather_along(x: torch.Tensor, dim: int, axis: str = "world") -> torch.Tensor:
    """The tiled all-gather of every rank's block of equal size along
    ``dim`` over ``axis``'s ranks (:class:`_GatherAlong`); ``x`` itself with
    one rank there."""
    return _GatherAlong.apply(x, dim, axis) if _axis(axis)[2] > 1 else x


class _HaloExchange(torch.autograd.Function):
    """This rank's block along ``dim`` with ``halo`` rows on each side: the
    previous rank's last rows before it, the next rank's first rows after
    it, zeros at the ends of the whole sequence. The edges of every rank
    travel in one all-gather, which every rank enters alike. The backward
    sends each halo's gradient back to the rank that owns those rows, where
    it is added to the gradient of its edge."""

    @staticmethod
    def forward(ctx, x, dim: int, halo: int):
        n = x.shape[dim]
        ctx.dim, ctx.halo, ctx.n = dim, halo, n
        edges = gather_parts(torch.stack([x.narrow(dim, 0, halo),
                                           x.narrow(dim, n - halo, halo)]))
        r, p = rank(), world_size()
        zeros = torch.zeros_like(edges[0][0])
        left = edges[r - 1][1] if r > 0 else zeros
        right = edges[r + 1][0] if r < p - 1 else zeros
        return torch.cat([left, x, right], dim)

    @staticmethod
    def backward(ctx, g):
        dim, halo, n = ctx.dim, ctx.halo, ctx.n
        grads = gather_parts(torch.stack([g.narrow(dim, 0, halo),
                                           g.narrow(dim, halo + n, halo)]))
        r, p = rank(), world_size()
        gx = g.narrow(dim, halo, n).clone()
        if r > 0:  # our first rows were the previous rank's right halo
            gx.narrow(dim, 0, halo).add_(grads[r - 1][1])
        if r < p - 1:  # our last rows were the next rank's left halo
            gx.narrow(dim, n - halo, halo).add_(grads[r + 1][0])
        return gx, None, None


def halo_exchange(x: torch.Tensor, dim: int, halo: int) -> torch.Tensor:
    """:class:`_HaloExchange` (``halo`` at most this rank's rows); with one
    rank the block zero-padded by ``halo`` rows on each side."""
    if world_size() > 1:
        return _HaloExchange.apply(x, dim, halo)
    pad = [0, 0] * (x.dim() - 1 - dim) + [halo, halo]
    return torch.nn.functional.pad(x, pad)


def refuse_indivisible(batch_size: int, shrinkable: bool = False) -> None:
    """The JAX CLIs' refusal of a global batch that does not divide over
    the data axis (``train_mirror.py:68-72``; with ``shrinkable``, the
    downstream CLIs' multi-process form, ``parallel/mesh.py:108-112``):
    ranks cannot be left idle the way a one-process mesh shrinks. The model
    axis takes no share of the batch (``fit_mesh_to_batch``, ``mesh.py:110-113``)."""
    n = data_size()
    if batch_size % n == 0:
        return
    if shrinkable:
        raise SystemExit(f"batch_size {batch_size} must divide over the data axis ({n}) "
                         "(cannot shrink a multi-process mesh)")
    raise SystemExit(f"batch_size {batch_size} must divide over the data axis ({n} shards)")
