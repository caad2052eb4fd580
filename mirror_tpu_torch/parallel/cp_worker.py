"""One rank of a context-parallel run: the cases of a spec, in order.

    python -m mirror_tpu_torch.parallel.cp_worker SPEC OUT

with the rendezvous in the env (``distributed.session``'s contract);
``worker.launch(..., module="mirror_tpu_torch.parallel.cp_worker")`` starts
R of them and gathers their outputs. ``SPEC`` is a ``torch.save``'d dict:
``device`` (``cpu`` or ``cuda``) and ``cases``, a list of dicts, each with
a ``kind``:

- ``attention``: ``kwargs`` of a ``NystromAttention``, its ``state_dict``
  and ``x`` [n, dim], one sequence; each rank takes its block and runs
  ``nystrom_attention_cp``. With ``t`` [n, dim], also the gradient of
  sum(out t), each rank's loss over its own rows. The output has ``out``
  (the blocks gathered), and with ``t`` ``gx`` (the blocks of x's
  gradient gathered) and ``grads`` (each parameter's gradient summed over
  the ranks);
- ``refuse``: the same with an ``x`` that does not split; the output's
  ``error`` is the refusal's message;
- ``encoder``: ``kwargs`` of a ``FeatureTransMIL``, its ``state_dict`` and
  ``tokens`` [n, input_dim] (or ``tokens_path``, a feature file): the
  output's ``seq`` is ``transmil_encode_cp``'s sequence;
- ``main``: ``module`` (a tool of the port) and ``argv``: its ``main``.

Each case's output also has ``ms`` (host clock around the case, the device
synchronized), ``launches`` (the kernel launches the case made) and
``peak_gib`` (peak device memory of the case, on the card). Rank r writes
``OUT.<r>``: ``rank``, ``world`` and ``results``, one a case.
"""

import importlib
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..data.formats import load_feature_file
from ..models.nystrom import NystromAttention
from ..models.transmil import FeatureTransMIL
from ..ops import _common
from . import distributed
from .context_parallel import nystrom_attention_cp, transmil_encode_cp


def _module(cls, case: Dict, device: torch.device):
    mod = cls(**case["kwargs"])
    mod.load_state_dict({k: torch.as_tensor(v) for k, v in case["state_dict"].items()})
    return mod.to(device).eval()


def _gathered(t: torch.Tensor) -> torch.Tensor:
    return torch.cat(distributed.gather_parts(t.detach().contiguous())).float().cpu()


def _attention(case: Dict, device: torch.device) -> Dict:
    attn = _module(NystromAttention, case, device)
    x = distributed.own_rows(torch.as_tensor(case["x"])).to(device)
    t = case.get("t")
    if t is not None:
        x.requires_grad_(True)
    with torch.set_grad_enabled(t is not None):
        out = nystrom_attention_cp(x, attn)
        if t is not None:
            t = distributed.own_rows(torch.as_tensor(t)).to(device)
            (out.float() * t.float()).sum().backward()
    res = {"out": _gathered(out)}
    if t is not None:
        res["gx"] = _gathered(x.grad)
        res["grads"] = {n: distributed.all_reduce(p.grad, axis="world").cpu()
                        for n, p in attn.named_parameters()}
    return res


def _refuse(case: Dict, device: torch.device) -> Dict:
    try:
        _attention(case, device)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


@torch.no_grad()
def _encoder(case: Dict, device: torch.device) -> Dict:
    encoder = _module(FeatureTransMIL, case, device)
    tokens = case.get("tokens")
    if tokens is None:
        tokens = np.asarray(load_feature_file(case["tokens_path"]), np.float32)
    return {"seq": transmil_encode_cp(encoder, torch.as_tensor(tokens).to(device)).float().cpu()}


def _main(case: Dict, device: torch.device) -> Dict:
    importlib.import_module(case["module"]).main(list(case["argv"]))
    return {}


CASES = {"attention": _attention, "refuse": _refuse, "encoder": _encoder, "main": _main}


def run_case(case: Dict, device: torch.device) -> Dict:
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    _common.reset_launch_counts()
    t0 = time.perf_counter()
    res = CASES[case["kind"]](case, device)
    if cuda:
        torch.cuda.synchronize(device)
    res["ms"] = 1e3 * (time.perf_counter() - t0)
    res["launches"] = _common.launch_counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0.0
    return res


def main(argv=None) -> int:
    spec_path, out_path = argv or sys.argv[1:]
    if os.environ.get("OMP_NUM_THREADS") == "1":
        torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    with distributed.session(None, torch.device(spec["device"])) as device:
        results = [run_case(case, device) for case in spec["cases"]]
        rank, world = distributed.rank(), distributed.world_size()
    torch.save({"rank": rank, "world": world, "results": results}, f"{out_path}.{rank}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
