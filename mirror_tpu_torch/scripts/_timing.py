"""What the probes and ``chip_smoke.py`` share: the device, the timing, the
roofline bound, the bars and errors of a kernel against its plain version,
and the JSON line.

The TPU scripts chain R reps inside one ``jit`` (``lax.scan``) and divide
the host time by R. Here a sample is a run of R back-to-back calls between
two CUDA events, divided by R, and the time is the median of the samples.
On the CPU nothing is timed: the plain versions run once each and their
time is reported as not measured (null). ``chip_smoke.py`` imports the
peaks, :func:`bound`, :func:`nbytes`, :func:`events_ms`, the bars and the
errors from here, so that the probes' rows and its kernels line are read
against one copy. The A/B probes (``exp_landmark_ab``, ``exp_ln_qkv_ab``,
``exp_conv_parts --parent``) import an earlier tree with
:func:`load_parent`, time the two in turns with :func:`in_turns` and split
a call's device time by launch with :func:`launch_split`.
"""

import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops import _common

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): bf16
# tensor cores dense, fp32 outside the tensor cores, HBM bandwidth. A
# kernel's bound is the larger of its bytes (each input read once, each
# output written once) over the bandwidth and its operations over the peak
# of their kind: the matrix products at the bf16 tensor-core rate, the
# conv taps and the other fp32 arithmetic at the fp32 rate.
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# The products of the other compute types' instances: float16 at the bf16
# rate (989 TFLOP/s); float32 at the 3xTF32 rate, a third of TF32's 495
# TFLOP/s, the fastest float32-accurate product the card has (one TF32 pass
# keeps about three digits).
PEAK_MMA_FLOPS = {torch.bfloat16: PEAK_BF16_FLOPS, torch.float16: PEAK_BF16_FLOPS,
                  torch.float32: 495e12 / 3}

# Bounds on the relative Frobenius error of a kernel against its plain
# version. Outputs rounded once to bf16 after an fp32 sum taken in another
# order: a bf16 rounding is at most 2^-9 = 2e-3 relative, and the attention
# also rounds its unnormalised probabilities before the product, so 1e-2
# leaves 5x room.
BOUND_SINGLE_ROUNDING = 1e-2
# The backward kernels: each output is rounded once to bf16 (2^-9), but
# dsim is rounded too before its products, and a probability that kernel
# and plain version compute one fp32 ulp apart can round dsim to the next
# bf16 value; dq and dk are sums of such terms with cancellation, so 2e-2.
BOUND_BWD = 2e-2
# The exact pinv backward (2b) against its plain version on the same bf16
# inputs: gx (relative Frobenius) and gs (relative) within 5e-2. The replay
# chains 4 x 6 bf16 products and the sweep 8 x 6 more; a one-ulp difference
# of an fp32 sum taken in another order rounds a product to its bf16
# neighbour and the unconverged iterations carry it on (the plain version in
# bf16 sits 8.6e-3 from the fp32 backward at m 384 on the CPU). Held by
# function too: gx at cosine >= 0.999 of the fp32 autograd of the plain
# iterations (the bf16 plain version reads 0.99995 there).
BOUND_PINV_BWD, BOUND_PINV_BWD_COS = 5e-2, 0.999
# Sums over a whole batch (dkern of the conv; gw, gs and gb of the LN +
# q/k/v projection), held beside the relative Frobenius error by their max
# abs error against the plain version's largest magnitude: 1e-2 where the
# kernel rounds the sum to bf16 (gw, dkern for bf16 taps), 1e-4 where it
# stays fp32 (the same bf16 products summed in another order).
BOUND_SUM_BF16, BOUND_SUM_FP32 = 1e-2, 1e-4
# The float32 instances (--no-amp) against their plain versions in float32:
# nothing is rounded but the products' 3xTF32 split (about 2^-21 relative a
# product), with sums in another order and ex2.approx (2 ulp), so 1e-4
# (relative Frobenius) forward; 1e-3 backward, where dsim = P dP - P D
# cancels and dq, dk sum such terms; 1e-3 for the pinv's 6 iterations and
# its exact backward. The float16 instances (--amp-dtype float16) round
# where bf16 does, with a finer ulp (2^-11 against 2^-8): bf16's bars.
BOUND_F32, BOUND_F32_BWD = 1e-4, 1e-3


def device_from_arg(name: str) -> torch.device:
    """``cuda`` runs the kernels and needs a card (no CPU fallback); ``cpu``
    runs the plain versions."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card is available; the kernels have no "
                           "CPU mode (pass --device cpu for the plain versions)")
    if device.type == "cuda":
        # the plain versions are fp32 references: no TF32 in their products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def randn(device: torch.device, *shape, scale: float = 1.0, dtype=torch.bfloat16, seed: int = 0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=device) * scale).to(dtype)


def events_ms(fn: Callable, runs: int = 1) -> float:
    """ms of the card's time per call over ``runs`` back-to-back calls of
    ``fn``, from before the first to after the last (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def median_ms(fn: Callable, device: torch.device, runs: int, reps: int = 5,
              warmup: int = 2) -> Optional[float]:
    """Median over ``reps`` samples of the ms per call of ``runs``
    back-to-back calls between two CUDA events; None on the CPU."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return statistics.median(events_ms(fn, runs) for _ in range(reps))


def bound(n_bytes: float, mma_flops: float = 0.0, fp32_flops: float = 0.0,
          mma_peak: float = PEAK_BF16_FLOPS):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the bandwidth and the operations over their peak (the
    products' at ``mma_peak``: :data:`PEAK_MMA_FLOPS` of their type)."""
    ops = max(mma_flops / mma_peak, fp32_flops / PEAK_FP32_FLOPS)
    if n_bytes / PEAK_BYTES >= ops:
        return n_bytes / PEAK_BYTES * 1e3, "bytes"
    return ops * 1e3, "operations"


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative Frobenius error of ``out`` against ``ref``."""
    d = out.float() - ref.float()
    return (d.norm() / ref.float().norm().clamp_min(1e-30)).item()


def sum_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs error of a batch sum against the plain version's largest
    magnitude."""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def sum_bound(out: torch.Tensor) -> float:
    """The bar of :func:`sum_err`: the kernel rounds the sum to bf16, or
    keeps it fp32."""
    return BOUND_SUM_BF16 if out.dtype == torch.bfloat16 else BOUND_SUM_FP32


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().ravel(), b.float().ravel()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-30)).item()


class Launches:
    """The kernels a piece of work launched, read from the ops' counters
    without resetting them (the caller may be counting too)."""

    def __enter__(self):
        self._before = _common.launch_counts()
        self.counts: Dict[str, int] = {}
        return self

    def __exit__(self, *exc):
        after = _common.launch_counts()
        self.counts = {k: v - self._before.get(k, 0) for k, v in after.items()
                       if v != self._before.get(k, 0)}
        return False


PARENT_NAME = "parent_mirror_tpu_torch"


def load_parent(root: Path, op: str = "landmark"):
    """``root/mirror_tpu_torch`` (a checkout of an earlier tree, e.g. unpacked
    by ``git archive`` into a git-ignored directory) imported as
    ``parent_mirror_tpu_torch``, which builds its own kernel library under
    ``root/build/kernels``; returns its ``ops.<op>`` (whose kernels are
    ``csrc/<op>.cu``). The A/B probes run both trees' wrappers in one
    process."""
    pkg = root / "mirror_tpu_torch"
    if not (pkg / "csrc" / f"{op}.cu").is_file():
        raise FileNotFoundError(f"{pkg}: no mirror_tpu_torch/csrc/{op}.cu in --parent")
    spec = importlib.util.spec_from_file_location(PARENT_NAME, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[PARENT_NAME] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{PARENT_NAME}.ops.{op}")


def in_turns(calls: Dict[str, Callable], device: torch.device, runs: int,
             reps: int) -> Dict[str, List[Optional[float]]]:
    """Each tree's call timed in turns, parent, this, this, parent (this
    alone without a parent): {tree: [median ms of each reading]}. Two
    trees are compared only inside one such run."""
    order = ("parent", "this", "this", "parent") if "parent" in calls else ("this",)
    samples: Dict[str, List[Optional[float]]] = {name: [] for name in calls}
    for name in order:
        samples[name].append(median_ms(calls[name], device, runs, reps))
    return samples


def launch_split(fn, calls: int = 5):
    """[(kernel, ms a call, launches a call)] of ``calls`` calls of ``fn``
    under torch.profiler: the device's own events, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the device's own events, not a user annotation's span over them
    # (torch.optim's ``Optimizer.step#...``), which would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    return [(e.key, dev_us(e) / 1e3 / calls, e.count / calls)
            for e in sorted(events, key=dev_us, reverse=True)]


def fmt(value: Optional[float], spec: str = ".4f") -> str:
    return "not measured" if value is None else format(value, spec)


def emit(probe: str, device: torch.device, shape: dict, variants: Sequence[dict],
         **extra) -> dict:
    """Print the probe's JSON line (its last line) and return it."""
    line = dict(probe=probe, device=device_name(device), shape=shape, variants=list(variants),
                **extra)
    print(json.dumps(line), flush=True)
    return line
