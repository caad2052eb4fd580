"""The landmark softmax (kernels 1 and 1b) of this tree against an earlier tree's.

A probe beside ``csrc/landmark.cu`` and ``landmark_bwd.cu``. With ``--parent DIR`` (a checkout of
an earlier tree, e.g. unpacked by ``git archive`` into a git-ignored
directory) it imports that tree's ``mirror_tpu_torch`` under another name,
which builds its own kernel library under ``DIR/build/kernels`` (this
tree's library is untouched), and runs both trees' ``landmark_softmax``
through their public entry: the forward, and the backward through
autograd for fixed incoming gradients (the forward runs once, in its own
tree). At the Nystrom shapes of the slices (the encoder's, the retention
decoder's, the self-test's) each is

- held against this tree's plain versions (``landmark_softmax_ref`` at
  BOUND_SINGLE_ROUNDING, ``landmark_softmax_bwd_ref`` at BOUND_BWD), the
  backward also run twice and compared bit for bit;
- timed in the order parent, this, this, parent (medians of runs of calls
  between CUDA events; the two readings of each tree are averaged): a call
  as a user makes it, host work and the autograd engine included, so a
  call whose kernels are short reads the host's time;
- profiled with ``torch.profiler``: the device time of each kernel launch
  of one call, by kernel name, and their sum, the call's device time.

Without ``--parent`` it runs this tree alone. Needs a card:

    python -m mirror_tpu_torch.scripts.exp_landmark_ab --parent build/parent

Prints one line a (shape, tree, pass), the profiler's split under it, and
one JSON line; exits 1 if either tree disagrees with a plain version beyond
its bar or a backward is not bit-identical over two runs.
"""

import argparse
import sys
from pathlib import Path

import torch

from ..ops import landmark
from . import _timing as T

HEADS = 8
# (b, n, pad, dh, m): the encoder's, the retention decoder's, the self-test's
SHAPES = ((16, 2117, 187, 96, 384), (16, 2049, 255, 96, 384), (8, 2117, 187, 64, 256))


def forward_call(mod, q, k, m, pad):
    return lambda: mod.landmark_softmax(q, k, m, pad)


def backward_call(mod, q, k, m, pad, grads):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k)]
    outs = mod.landmark_softmax(*leaves, m, pad)
    return lambda: torch.autograd.grad(outs, leaves, grads, retain_graph=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None,
                   help="a checkout of the earlier tree (its mirror_tpu_torch/)")
    p.add_argument("--runs", type=int, default=20, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=15, help="timed samples (median)")
    a = p.parse_args(argv)
    device = T.device_from_arg("cuda")
    trees = {"this": landmark}
    if a.parent is not None:
        trees["parent"] = T.load_parent(a.parent.resolve())
    failed, result = [], []
    for i, (b, n, pad, dh, m) in enumerate(SHAPES):
        shape = f"b {b}, h {HEADS}, n {n}, pad {pad}, dh {dh}, m {m}"
        q = T.randn(device, b, HEADS, n, dh, scale=dh ** -0.5, seed=10 * i + 1)
        k = T.randn(device, b, HEADS, n, dh, seed=10 * i + 2)
        grads = (T.randn(device, b, HEADS, m, dh, seed=10 * i + 3),
                 T.randn(device, b, HEADS, m, dh, seed=10 * i + 4),
                 T.randn(device, b, HEADS, m, m, seed=10 * i + 5))
        refs = {"fwd": landmark.landmark_softmax_ref(q, k, m, pad),
                "bwd": landmark.landmark_softmax_bwd_ref(q, k, m, pad, *grads)}
        bars = {"fwd": T.BOUND_SINGLE_ROUNDING, "bwd": T.BOUND_BWD}
        for pas in ("fwd", "bwd"):
            calls = {name: forward_call(mod, q, k, m, pad) if pas == "fwd"
                     else backward_call(mod, q, k, m, pad, grads)
                     for name, mod in trees.items()}
            samples = T.in_turns(calls, device, a.runs, a.reps)
            for name, call in calls.items():
                out = call()
                err = max(T.rel_err(o, r) for o, r in zip(out, refs[pas], strict=True))
                same = None
                if pas == "bwd":
                    again = call()
                    torch.cuda.synchronize()
                    same = all(torch.equal(x, y) for x, y in zip(out, again))
                ms = sum(samples[name]) / len(samples[name])
                split = T.launch_split(call)
                device_ms = sum(kms for _, kms, _ in split)
                result.append(dict(shape=shape, tree=name, direction=pas, ms=ms,
                                   samples_ms=samples[name], device_ms=device_ms,
                                   rel_fro_err=err, bar=bars[pas], bit_identical=same,
                                   launches=[dict(kernel=kname, ms=kms, per_call=cnt)
                                             for kname, kms, cnt in split]))
                bits = "" if same is None else f", two runs {'same bits' if same else 'DIFFER'}"
                print(f"[{shape}] {name} {pas}: {ms:.4f} ms a call (samples "
                      f"{', '.join(f'{s:.4f}' for s in samples[name])}), {device_ms:.4f} ms of "
                      f"device time; rel Frobenius err "
                      f"{err:.3g} (bar {bars[pas]:g}){bits}", flush=True)
                for kname, kms, cnt in split:
                    print(f"    {kms:9.4f} ms x{cnt:g} {kname[:100]}", flush=True)
                if not err <= bars[pas] or same is False:
                    failed.append(f"{shape} {name} {pas}")
            if "parent" in trees:
                this, parent = ({r["tree"]: r for r in result[-2:]}[t] for t in ("this", "parent"))
                print(f"[{shape}] {pas}: this / parent {this['ms'] / parent['ms']:.3f} a call, "
                      f"{this['device_ms'] / parent['device_ms']:.3f} in device time", flush=True)
        del q, k, grads, refs
        torch.cuda.empty_cache()
    T.emit("exp_landmark_ab", device, dict(heads=HEADS, shapes=SHAPES), result, failed=failed)
    if failed:
        print(f"beyond the bar: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
