"""The fused LN + q/k/v projection (kernels 10 and 10b) of this tree against an earlier tree's.

A probe beside ``csrc/ln_qkv.cu``, in the shape of ``exp_landmark_ab``. With
``--parent DIR`` (a checkout of an earlier tree, e.g. unpacked by ``git
archive`` into a git-ignored directory) it imports that tree's
``mirror_tpu_torch`` under another name, which builds its own kernel
library under ``DIR/build/kernels``, and runs both trees' ``ln_qkv_fused``:
the forward, and the backward alone through autograd for fixed incoming
gradients (the forward runs once, in its own tree), as ``chip_smoke.py``'s
rows 10 and 10b time them. At phase 3's x [16, 2117, 768] and the probe
``exp_ln_qkv``'s [64, 2117, 768], 8 heads of 96, each is

- held against this tree's plain versions (``ln_qkv_ref`` at
  BOUND_SINGLE_ROUNDING; ``ln_qkv_bwd_ref`` at BOUND_BWD, and gs, gb, gw by
  the batch-sum bars), the backward also run twice and compared bit for
  bit;
- timed in the order parent, this, this, parent (medians of runs of calls
  between CUDA events; the two readings of each tree are averaged), beside
  one reading of the library call (``layer_norm`` + ``matmul`` with the
  head-major view; autograd for the backward) and the bound;
- profiled with ``torch.profiler``: the device time of each kernel launch
  of one call, by kernel name, and their sum.

Without ``--parent`` it runs this tree alone. Needs a card:

    python -m mirror_tpu_torch.scripts.exp_ln_qkv_ab --parent build/parent

Prints one line a (shape, tree, pass), the profiler's split under it, and
one JSON line; exits 1 if either tree disagrees with a plain version beyond
its bar or a backward is not bit-identical over two runs.
"""

import argparse
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import ln_qkv
from . import _timing as T

HEADS, DH, D, N, EPS = 8, 96, 768, 2117, 1e-5
BATCHES = (16, 64)


def _inputs(device, b, seed):
    x = T.randn(device, b, N, D, seed=seed)
    s = 1.0 + T.randn(device, D, scale=0.1, dtype=torch.float32, seed=seed + 1)
    lb = T.randn(device, D, scale=0.1, dtype=torch.float32, seed=seed + 2)
    w = T.randn(device, D, 3 * HEADS * DH, scale=D ** -0.5, seed=seed + 3)
    grads = tuple(T.randn(device, b, HEADS, N, DH, seed=seed + 4 + i) for i in range(3))
    return (x, s, lb, w), grads


def _library(b):
    def call(x, s, lb, w):
        y = F.layer_norm(x, (D,), s.to(x.dtype), lb.to(x.dtype), EPS) @ w
        return y.view(b, N, 3, HEADS, DH).permute(2, 0, 3, 1, 4).unbind(0)
    return call


def _backward_call(fn, inputs, grads):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    return lambda: torch.autograd.grad(outs, leaves, grads, retain_graph=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None,
                   help="a checkout of the earlier tree (its mirror_tpu_torch/)")
    p.add_argument("--runs", type=int, default=10, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=9, help="timed samples (median)")
    p.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    a = p.parse_args(argv)
    device = T.device_from_arg("cuda")
    trees = {"this": ln_qkv}
    if a.parent is not None:
        trees["parent"] = T.load_parent(a.parent.resolve(), "ln_qkv")
    failed, result = [], []
    for i, b in enumerate(a.batches):
        shape = f"x [{b}, {N}, {D}], heads {HEADS}, dh {DH}"
        inputs, grads = _inputs(device, b, 10 * i)
        rows = b * N
        mma = 2 * rows * D * 3 * HEADS * DH
        qkv_bytes = 3 * rows * HEADS * DH * 2
        bounds = {"fwd": T.bound(T.nbytes(*inputs) + qkv_bytes, mma, 8 * rows * D),
                  "bwd": T.bound(2 * T.nbytes(*inputs) + qkv_bytes, 2 * mma, 16 * rows * D)}
        gx, gw, gs, gb = ln_qkv.ln_qkv_bwd_ref(*inputs, *grads, HEADS, EPS)
        refs = {"fwd": ln_qkv.ln_qkv_ref(*inputs, HEADS, EPS), "bwd": (gx, gs, gb, gw)}
        del gx, gw, gs, gb
        bars = {"fwd": T.BOUND_SINGLE_ROUNDING, "bwd": T.BOUND_BWD}
        for pas in ("fwd", "bwd"):
            calls = {}
            for name, mod in trees.items():
                fused = lambda *t, mod=mod: mod.ln_qkv_fused(*t, HEADS, EPS)  # noqa: E731
                calls[name] = (lambda f=fused: f(*inputs)) if pas == "fwd" \
                    else _backward_call(fused, inputs, grads)
            library = (lambda: _library(b)(*inputs)) if pas == "fwd" \
                else _backward_call(_library(b), inputs, grads)
            samples = T.in_turns(calls, device, a.runs, a.reps)
            library_ms = T.median_ms(library, device, a.runs, a.reps)
            bound_ms, bound_by = bounds[pas]
            for name, call in calls.items():
                out = call()
                err = max(T.rel_err(o, r) for o, r in zip(out, refs[pas], strict=True))
                held = {}
                same = None
                if pas == "bwd":
                    sums = dict(zip(("gs", "gb", "gw"), zip(out[1:], refs[pas][1:])))
                    held = dict(sum_err={g: T.sum_err(o, r) for g, (o, r) in sums.items()},
                                sum_bar={g: T.sum_bound(o) for g, (o, _) in sums.items()})
                    again = call()
                    torch.cuda.synchronize()
                    same = all(torch.equal(x, y) for x, y in zip(out, again))
                ms = sum(samples[name]) / len(samples[name])
                split = T.launch_split(call)
                device_ms = sum(kms for _, kms, _ in split)
                result.append(dict(shape=shape, tree=name, direction=pas, ms=ms,
                                   samples_ms=samples[name], device_ms=device_ms,
                                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   rel_fro_err=err, bar=bars[pas], bit_identical=same, **held,
                                   launches=[dict(kernel=kname, ms=kms, per_call=cnt)
                                             for kname, kms, cnt in split]))
                bits = "" if same is None else f", two runs {'same bits' if same else 'DIFFER'}"
                sums_txt = "".join(f", {g} sum err {e:.3g} (bar {held['sum_bar'][g]:g})"
                                   for g, e in held.get("sum_err", {}).items())
                print(f"[{shape}] {name} {pas}: {ms:.4f} ms a call (samples "
                      f"{', '.join(f'{s:.4f}' for s in samples[name])}), {device_ms:.4f} ms of "
                      f"device time; library {library_ms:.4f} ms (kernel / library "
                      f"{ms / library_ms:.2f}); bound {bound_ms:.4f} ms by {bound_by} "
                      f"({100 * bound_ms / ms:.1f} %); rel Frobenius err {err:.3g} "
                      f"(bar {bars[pas]:g}){sums_txt}{bits}", flush=True)
                for kname, kms, cnt in split:
                    print(f"    {kms:9.4f} ms x{cnt:g} {kname[:100]}", flush=True)
                if not err <= bars[pas] or same is False or any(
                        e > held["sum_bar"][g] for g, e in held.get("sum_err", {}).items()):
                    failed.append(f"{shape} {name} {pas}")
            if "parent" in trees:
                this, parent = ({r["tree"]: r for r in result[-2:]}[t] for t in ("this", "parent"))
                print(f"[{shape}] {pas}: this / parent {this['ms'] / parent['ms']:.3f} a call, "
                      f"{this['device_ms'] / parent['device_ms']:.3f} in device time", flush=True)
        del inputs, grads, refs
        torch.cuda.empty_cache()
    T.emit("exp_ln_qkv_ab", device, dict(heads=HEADS, dh=DH, d=D, n=N, batches=a.batches),
           result, failed=failed)
    if failed:
        print(f"beyond the bar: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
