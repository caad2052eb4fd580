"""One rank of a data-parallel train-step run, and a launcher of R of them.

    python -m mirror_tpu_torch.parallel.worker SPEC OUT

with the rendezvous in the env (``distributed.session``'s contract, e.g.
``MIRROR_COORDINATOR=file:///tmp/rdv MIRROR_NUM_PROCESSES=2
MIRROR_PROCESS_ID=0``). ``SPEC`` is a ``torch.save``'d dict:

- ``model``, ``model_kwargs``, ``device`` (``cpu`` or ``cuda``), and either
  ``state_dict`` or ``seed`` (weights drawn from that seed, as the CLIs do);
- ``step``: ``mirror`` or ``clip``; ``negatives``; ``argv``, the pretrain
  flags that build the optimizer (``config.parse_args``), and ``lr``;
  ``loss_weights``, ``mask_ratios``, ``temperature``;
- ``batches``: global batches ({"wsi", "rna"}), and for ``mirror`` either
  ``noise`` (one global dict of draws a batch; each rank takes its block)
  or a ``generator_seed`` for the step's own draws;
- optional ``model_parallel`` (``--model-parallel N``: the model's wide
  layers split over N ranks a data rank, ``tensor_parallel.shard_model``),
  ``optimizer_state`` to load before the steps, ``snapshot_after`` (after
  that many steps, the weights and the optimizer's gathered state in the
  output: a collective), ``dump`` (``weights`` and / or ``grads``: the
  weights after the last step, the averaged gradients of the last step),
  ``reps`` (steps timed after the batches, on the last batch), ``ema`` (a
  ``ModelEma`` updated by the steps);
- or ``cases``: a list of such specs, run one after the other in the one
  group (each with its own layout), or of ``{"cli": module, "argv": [...]}``
  entries that run a training CLI's ``main`` in the group (a refusal's
  message is kept as ``refused``; the kernel launches of the run as
  ``launches``).

Each rank writes ``OUT.<rank>``: the digest of its weights (whole leaves,
gathered over the model ranks) before the wrap and after each step, each
step's metrics, what ``dump`` asks for (whole leaves too), the bytes of
its parameters and optimizer state, and the times (the group's init, the
first step, the timed steps' median), on the host's clock around steps
that end in a device synchronize; with ``cases``, the list of their
outputs.
:func:`start` runs R ranks as subprocesses and :func:`launch` also waits
for them and gathers their outputs; a rank that fails or outlives the
timeout fails the launch, and every rank is stopped.
"""

import hashlib
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import distributed, tensor_parallel


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(spec: Dict, device: torch.device) -> Dict:
    from ..config import parse_args
    from ..losses import MirrorLossWeights
    from ..registry import create_model
    from ..train.optim import make_optimizer
    from ..train.steps import ModelEma, make_clip_train_step, make_mirror_train_step

    out: Dict = {}
    generator = None if "state_dict" in spec else torch.Generator().manual_seed(spec["seed"])
    model = create_model(spec["model"], device=device, generator=generator,
                         **spec["model_kwargs"])
    if "state_dict" in spec:
        model.load_state_dict(spec["state_dict"])
    tensor_parallel.shard_model(model)
    dims = tensor_parallel.sharded_dims(model)

    def whole_digest():
        return digest(tensor_parallel.full_state_dict(model).values())

    out["init_digest"] = whole_digest()
    args, _ = parse_args(list(spec.get("argv", [])), task="pretrain")
    optimizer = make_optimizer(args, model, spec["lr"])
    if spec.get("optimizer_state") is not None:
        optimizer.load_state_dict(spec["optimizer_state"])
    ema = ModelEma(model) if spec.get("ema") else None
    step_gen = None
    if spec.get("generator_seed") is not None:
        step_gen = torch.Generator(device=device).manual_seed(spec["generator_seed"])
    if spec["step"] == "mirror":
        wsi_ratio, rna_ratio = spec.get("mask_ratios", (0.75, 0.75))
        step = make_mirror_train_step(model, optimizer,
                                      MirrorLossWeights(*spec.get("loss_weights", ())),
                                      wsi_ratio, rna_ratio, generator=step_gen, ema=ema,
                                      negatives=spec["negatives"])
    else:
        step = make_clip_train_step(model, optimizer, spec.get("temperature", 0.1),
                                    generator=step_gen, ema=ema, negatives=spec["negatives"])

    def run_step(i: int) -> Dict:
        batch = {k: distributed.own_rows(v).to(device) for k, v in spec["batches"][i].items()}
        if spec["step"] == "mirror" and spec.get("noise") is not None:
            noise = {k: distributed.own_rows(v).to(device) for k, v in spec["noise"][i].items()}
            return step(batch, noise=noise)
        return step(batch)

    out["metrics"], out["digests"] = [], []
    for i in range(len(spec["batches"])):
        _sync(device)
        t0 = time.perf_counter()
        metrics = run_step(i)
        _sync(device)
        if i == 0:
            out["first_step_ms"] = 1e3 * (time.perf_counter() - t0)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["digests"].append(whole_digest())
        if spec.get("snapshot_after") == i + 1:  # every rank: ZeRO-1 and TP gather
            out["snapshot"] = {"weights": {k: v.detach().cpu().clone() for k, v in
                                           tensor_parallel.full_state_dict(model).items()},
                               "optimizer": optimizer.state_dict()}
    dump = spec.get("dump", ())
    if "grads" in dump:
        out["grads"] = {n: tensor_parallel.gather_along_model(p.grad, dims[n]).cpu().clone()
                        if n in dims else p.grad.detach().cpu().clone()
                        for n, p in model.named_parameters() if p.grad is not None}
    if "weights" in dump:
        out["weights"] = {k: v.detach().cpu().clone()
                          for k, v in tensor_parallel.full_state_dict(model).items()}
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    out["optimizer_bytes"] = sum(t.numel() * t.element_size()
                                 for bufs in optimizer.state.values() for t in bufs)
    if ema is not None:
        out["ema_bytes"] = sum(p.numel() * p.element_size() for p in ema.module.parameters())
    times = []
    for _ in range(spec.get("reps", 0)):
        _sync(device)
        t0 = time.perf_counter()
        run_step(len(spec["batches"]) - 1)
        _sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    if times:
        out["step_ms"] = sorted(times)[len(times) // 2]
    out["rank"], out["world"] = distributed.rank(), distributed.world_size()
    return out


def run_case(case: Dict, device: torch.device) -> Dict:
    """One entry of a spec's ``cases``: a train-step spec under its own
    (data, model) layout, or a CLI's ``main`` on its ``argv`` (its result,
    or the message of the refusal that stopped it, as ``refused``)."""
    if "cli" in case:
        from ..ops import _common

        module = importlib.import_module(case["cli"])
        _common.reset_launch_counts()
        try:
            out = {"result": module.main(list(case["argv"]))}
        except SystemExit as refusal:
            out = {"refused": str(refusal)}
        return dict(out, launches=_common.launch_counts())
    distributed.set_model_parallel(case.get("model_parallel", 1))
    try:
        return run(case, device)
    finally:
        distributed.set_model_parallel(1)


def rank_env(rank: int, world: int, rendezvous: Path, timeout_s: float) -> Dict[str, str]:
    """The env of rank ``rank`` of ``world``: this process's, the
    ``MIRROR_*`` rendezvous by ``file://{rendezvous}`` with ``timeout_s``
    as the group's timeout, one intra-op thread, and the repository on the
    path."""
    return dict(os.environ, MIRROR_COORDINATOR=f"file://{rendezvous}",
                MIRROR_NUM_PROCESSES=str(world), MIRROR_PROCESS_ID=str(rank),
                MIRROR_DIST_TIMEOUT=str(int(timeout_s)), OMP_NUM_THREADS="1",
                PYTHONPATH=str(Path(__file__).resolve().parents[2]))


def start_ranks(cmd: List[str], world: int, rendezvous: Path, log_prefix: Path,
                timeout_s: float = 120.0, env: Optional[Dict[str, str]] = None
                ) -> Callable[[], List[str]]:
    """Start ``cmd`` as ``world`` ranks (:func:`rank_env`, then ``env``),
    rendezvous by ``file://{rendezvous}`` (which must not exist yet), each
    rank's output in ``{log_prefix}.<rank>.log``. Returns the wait: it gives
    the ranks' output in rank order, or raises with it if a rank failed or
    the ranks outlived ``timeout_s`` from their start (every rank is then
    stopped)."""
    procs, paths = [], []
    for r in range(world):
        child = rank_env(r, world, rendezvous, timeout_s)
        child.update(env or {})
        paths.append(Path(f"{log_prefix}.{r}.log"))
        with open(paths[-1], "w") as log:
            procs.append(subprocess.Popen(cmd, env=child, stdout=log,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s

    def wait() -> List[str]:
        failed = False
        try:
            for proc in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
                failed = failed or proc.returncode != 0
        except subprocess.TimeoutExpired:
            failed = True
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        logs = [p.read_text() for p in paths]
        if failed:
            raise RuntimeError("a rank failed or timed out:\n" + "\n---\n".join(logs))
        return logs

    return wait


def start(spec_path: Path, out_path: Path, world: int, rendezvous: Path,
          timeout_s: float = 120.0, env: Optional[Dict[str, str]] = None,
          module: str = "mirror_tpu_torch.parallel.worker") -> Callable[[], List[Dict]]:
    """:func:`start_ranks` of ``module``'s ``main`` (this module's, or
    ``context_parallel``'s cases in ``cp_worker``) on ``spec_path``; the
    wait returns the ranks' outputs (``OUT.<rank>``) in rank order."""
    wait = start_ranks([sys.executable, "-m", module, str(spec_path), str(out_path)], world,
                       rendezvous, out_path, timeout_s, env)

    def outputs() -> List[Dict]:
        wait()
        return [torch.load(f"{out_path}.{r}", weights_only=False) for r in range(world)]

    return outputs


def launch(spec_path: Path, out_path: Path, world: int, rendezvous: Path,
           timeout_s: float = 120.0, env: Optional[Dict[str, str]] = None,
           module: str = "mirror_tpu_torch.parallel.worker") -> List[Dict]:
    """:func:`start`, then its wait."""
    return start(spec_path, out_path, world, rendezvous, timeout_s, env, module)()


def main(argv=None) -> int:
    spec_path, out_path = argv or sys.argv[1:]
    if os.environ.get("OMP_NUM_THREADS") == "1":
        torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    t0 = time.perf_counter()
    with distributed.session(None, torch.device(spec["device"])) as device:
        init_s = time.perf_counter() - t0
        if "cases" in spec:
            out = {"cases": [run_case(case, device) for case in spec["cases"]],
                   "rank": distributed.rank()}
        else:
            out = run_case(spec, device)
    out["init_s"] = init_s
    torch.save(out, f"{out_path}.{out['rank']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
