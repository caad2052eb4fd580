"""The standalone depthwise conv's passes and the column sum, timed apart on the card.

Counterpart of ``scripts/exp_conv_parts.py``, which times
``conv1d_pallas._fwd_call`` and ``_bwd_call`` (kernels 9 and 9b) and XLA's
grouped conv at [64, 8, 2304, 96], K 33. Here kernels 9 and 9b of
``csrc/conv1d.cu`` are launched straight into outputs and scratch allocated
before the timing, so no autograd work paces a run of calls, and 9b is
split into its parts:

- ``fwd``: kernel 9;
- ``bwd fused dv+dk``: kernel 9b (dv and the dkern partials in one pass,
  then their column sum);
- ``bwd dv only``: the forward's kernel on g with the taps flipped (bit for
  bit the fused dv);
- ``column sum``: the second pass alone, on the fused pass's partials;
- ``dkern product (derived)``: fused - dv only - column sum;
- the library calls, as ``chip_smoke.py`` phase 3 builds them: ``F.conv2d``
  (groups h, a (K, 1) filter) and ``aten.convolution_backward``.

At the probe's shape (``--batch`` ...) the rows carry these names; on the
card the same rows follow at phase 3's [16, 8, 2117, 96] (`` @ phase 3``)
and at kernel 4b's conv, the padded length r 2304 (`` @ 4b conv``), and the
column sum alone at each of its call sites' shapes (``column sum [P, C]``:
the former conv partials [1152, 264] and [288, 264], kernel 5b's [96,
38400], kernel 10b's gw [7, 1769472], here into fp32), each beside
``parts.sum(0)``.

Each kernel is held against its plain version within ``chip_smoke.py``'s
bars for kernels 9 and 9b (``_timing``), the column sum of the partials
against the fused dkern bit for bit, and the column sum at a call site
against ``conv1d.column_sum_in_order`` bit for bit: the probe exits 1 when
one is out. The device time of each call is split by launch with
``torch.profiler``.

With ``--parent DIR`` (a checkout of an earlier tree, e.g. unpacked by ``git
archive`` into a git-ignored directory; card only) that tree's
``mirror_tpu_torch`` is imported under another name, builds its own
library, and every row is run for both trees in turns, parent, this, this,
parent (the two readings of a tree averaged), each tree held against this
tree's plain versions; the parent's rows are named ``parent: ...``.

    python -m mirror_tpu_torch.scripts.exp_conv_parts [--device cuda] [--parent build/parent]
"""

import argparse
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops import conv1d
from . import _timing as T
from ..utils.platform import default_device

# the kernels each variant launches, as the profiler names them (csrc/conv1d.cu,
# common.cuh): dv alone is the forward's kernel; the fused backward's second
# pass is the column sum
PROFILED = {"fwd": ("conv1d_kernel",),
            "bwd fused dv+dk": ("conv1d_bwd_kernel", "column_sum_kernel"),
            "bwd dv only": ("conv1d_kernel",), "column sum": ("column_sum_kernel",)}
# (label, (b, h, n, d, K)): phase 3's kernels 9 / 9b, and kernel 4b's conv
CARD_SHAPES = (("phase 3", (16, 8, 2117, 96, 33)), ("4b conv", (16, 8, 2304, 96, 33)))
# the column sum's call sites: the former conv partials at b 64 and 16,
# kernel 5b's dk / db, kernel 10b's gw
COLUMN_SUMS = ((1152, 264), (288, 264), (96, 38400), (7, 1769472))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--n", type=int, default=2304)
    p.add_argument("--d", type=int, default=96)
    p.add_argument("--ksize", type=int, default=33)
    p.add_argument("--steps", type=int, default=20, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=5, help="timed samples (median)")
    p.add_argument("--device", default=default_device())
    p.add_argument("--parent", type=Path, default=None,
                   help="a checkout of an earlier tree (its mirror_tpu_torch/), timed in turns")
    return p.parse_args(argv)


def conv_rows(trees, device, shape, suffix, a):
    """The conv's variants at one shape for each tree, timed in turns: the
    rows, and whether every check held."""
    b, h, n, d, K = shape
    v = T.randn(device, b, h, n, d, seed=0)
    g = T.randn(device, b, h, n, d, seed=1)
    taps = T.randn(device, h, K, dtype=torch.float32, seed=2).to(torch.bfloat16)
    weight = taps.view(h, 1, K, 1)
    on_card = device.type == "cuda"
    ref_out = conv1d.depthwise_conv_seq_ref(v, taps).to(v.dtype)
    ref_dv, ref_dk = conv1d.depthwise_conv_seq_bwd_ref(v, taps, g)

    # (bytes, tensor-core products, fp32 operations): the conv's products (2
    # K FLOP an element) on the tensor cores, so the bound is the bytes'
    macs = 2 * K * v.numel()
    work = {"fwd": (2 * T.nbytes(v), macs, 0), "bwd fused dv+dk": (3 * T.nbytes(v), 2 * macs, 0),
            "bwd dv only": (2 * T.nbytes(v), macs, 0)}
    library = {
        "fwd": lambda: F.conv2d(v, weight, padding=(K // 2, 0), groups=h),
        "bwd fused dv+dk": lambda: torch.ops.aten.convolution_backward(
            g, v, weight, None, [1, 1], [K // 2, 0], [1, 1], False, [0, 0], h,
            [True, True, False]),
        "bwd dv only": lambda: torch.ops.aten.convolution_backward(
            g, v, weight, None, [1, 1], [K // 2, 0], [1, 1], False, [0, 0], h,
            [True, False, False])[0],
    }
    calls, checks, ok = {}, {}, True
    for tree, mod in trees.items():
        out, dv, dv_only = torch.empty_like(v), torch.empty_like(v), torch.empty_like(v)
        dkern = torch.empty(h, K, dtype=torch.float32, device=device)
        if on_card:
            partial = mod.conv1d_bwd_scratch(v, K)
            fns = {
                "fwd": lambda mod=mod, out=out: mod.conv1d_fwd_into(v, taps, out),
                "bwd fused dv+dk": lambda mod=mod, dv=dv, dkern=dkern, partial=partial:
                    mod.conv1d_bwd_into(v, taps, g, dv, dkern, partial),
                "bwd dv only": lambda mod=mod, dv_only=dv_only:
                    mod.conv1d_bwd_dv(g, taps, out=dv_only),
                "column sum": lambda mod=mod, partial=partial: mod.column_sum(partial),
            }
        else:  # the plain versions; the partials one per batch row
            partial = torch.stack([conv1d.depthwise_conv_seq_bwd_ref(
                v[i:i + 1], taps, g[i:i + 1])[1].reshape(-1) for i in range(b)])

            def fused(dv=dv, dkern=dkern):
                dv_ref, dk = conv1d.depthwise_conv_seq_bwd_ref(v, taps, g)
                dv.copy_(dv_ref)
                dkern.copy_(dk)
            fns = {
                "fwd": lambda out=out: out.copy_(conv1d.depthwise_conv_seq_ref(v, taps)),
                "bwd fused dv+dk": fused,
                "bwd dv only": lambda dv_only=dv_only: conv1d.conv1d_bwd_dv(g, taps, out=dv_only),
                "column sum": lambda partial=partial: conv1d.column_sum(partial),
            }
        launched, results = {}, {}
        for name, fn in fns.items():
            with T.Launches() as counts:
                results[name] = fn()
            launched[name] = counts.counts
        errs = {"fwd": T.rel_err(out, ref_out),
                "bwd fused dv+dk": max(T.rel_err(dv, ref_dv), T.rel_err(dkern, ref_dk)),
                "bwd dv only": T.rel_err(dv_only, dv),
                "column sum": T.rel_err(results["column sum"], partial.float().sum(0))}
        # the bars, chip_smoke.py's for kernels 9 and 9b: the fused dkern, a
        # sum over the batch, also by its max abs error against its largest
        # value; dv alone, and on the card the column sum of the partials, bit
        # for bit
        bars = {"fwd": T.BOUND_SINGLE_ROUNDING, "bwd fused dv+dk": T.BOUND_BWD,
                "bwd dv only": 0.0, "column sum": T.BOUND_SINGLE_ROUNDING}
        dkern_sum_err, dkern_sum_bar = T.sum_err(dkern, ref_dk), T.sum_bound(dkern)
        dv_exact = bool(torch.equal(dv_only, dv))
        sum_exact = bool(torch.equal(results["column sum"], dkern.reshape(-1)))
        ok = (ok and dv_exact and (sum_exact or not on_card) and dkern_sum_err <= dkern_sum_bar
              and all(errs[name] <= bar for name, bar in bars.items()))
        checks[tree] = {}
        for name, fn in fns.items():
            calls.setdefault(name, {})[tree] = fn
            row = dict(tree=tree, shape=list(shape), err=errs[name],
                       err_vs="the fused dv" if name == "bwd dv only" else "plain",
                       bar=bars[name], launches=launched[name],
                       _work=work.get(name, (T.nbytes(partial) + 4 * h * K, 0, partial.numel())))
            if name == "bwd fused dv+dk":
                row.update(dkern_sum_err=dkern_sum_err, dkern_sum_bar=dkern_sum_bar,
                           column_sum_bit_exact=sum_exact)
            checks[tree][name] = row
        if tree == "this":  # the column sum's library call: this tree's partials' sum(0)
            library["column sum"] = lambda partial=partial: partial.sum(0)
    rows = []
    for name, by_tree in calls.items():
        rows += timed(by_tree, device, a, f"{name}{suffix}", checks, name, library[name])
    for tree in trees:  # the dkern product, derived from the three timed parts
        ms = {r["variant"]: r["ms"] for r in rows if r["tree"] == tree}
        prod = (ms["bwd fused dv+dk"] - ms["bwd dv only"] - ms["column sum"]) if on_card else None
        rows.append(dict(name=_tree_name(tree, f"dkern product (derived){suffix}"), tree=tree,
                         ms=prod, derived=True,
                         formula="bwd fused dv+dk - bwd dv only - column sum"))
    return rows, ok


def _tree_name(tree, name):
    return name if tree == "this" else f"{tree}: {name}"


def timed(by_tree, device, a, label, checks, variant, library):
    """One variant for each tree: timed in turns, split by launch, beside
    its library call (this tree's inputs, timed once) and its bound (and,
    for the conv, the bound of its products counted as fp32 FMAs, as the
    earlier CUDA-core slide ran them)."""
    samples = T.in_turns(by_tree, device, a.steps, a.reps)
    library_ms = T.median_ms(library, device, a.steps, a.reps) if library else None
    # the library call's device time, by the profiler as the kernels' (a
    # short call's run of calls reads the host's time)
    library_split = T.launch_split(library) if library and device.type == "cuda" else []
    rows = []
    for tree, fn in by_tree.items():
        row = dict(checks[tree][variant])
        n_bytes, mma, fp32 = row.pop("_work")
        bound_ms, bound_by = T.bound(n_bytes, mma_flops=mma, fp32_flops=fp32)
        if mma:
            row["bound_fp32_fma_ms"] = T.bound(n_bytes, fp32_flops=mma)[0]
        ms = None if samples[tree][0] is None else sum(samples[tree]) / len(samples[tree])
        split = T.launch_split(fn) if device.type == "cuda" else []
        device_ms = sum(kms for _, kms, _ in split) if split else None
        # this tree's kernels by name; an earlier tree's launches all count
        kernels = PROFILED.get(variant, ("column_sum_kernel",))
        row.update(name=_tree_name(tree, label), variant=variant, ms=ms, samples_ms=samples[tree],
                   bound_ms=bound_ms, bound_by=bound_by, device_ms=device_ms,
                   profiler_ms=(sum(kms for kname, kms, _ in split
                                    if any(k in kname for k in kernels))
                                if split and tree == "this" else device_ms),
                   split=[dict(kernel=kname, ms=kms, per_call=cnt) for kname, kms, cnt in split])
        if library:
            row["library_ms"] = library_ms
            row["library_device_ms"] = (sum(kms for _, kms, _ in library_split)
                                        if library_split else None)
        rows.append(row)
    return rows


def column_sum_rows(trees, device, a):
    """The column sum alone at its call sites' shapes, for each tree: within
    BOUND_SINGLE_ROUNDING of the float64 sum, and (this tree) bit for bit
    its order's plain emulation."""
    rows, ok = [], True
    for i, (nparts, count) in enumerate(COLUMN_SUMS):
        parts = T.randn(device, nparts, count, dtype=torch.float32, seed=10 + i)
        want = parts.double().sum(0)
        label = f"column sum [{nparts}, {count}]"
        checks, by_tree = {}, {}
        for tree, mod in trees.items():
            out = mod.column_sum(parts)
            err = T.rel_err(out, want)
            ordered = bool(torch.equal(out, conv1d.column_sum_in_order(parts))) \
                if tree == "this" else None
            ok = ok and err <= T.BOUND_SINGLE_ROUNDING and ordered is not False
            checks[tree] = {label: dict(tree=tree, shape=[nparts, count], err=err,
                                        err_vs="float64", bar=T.BOUND_SINGLE_ROUNDING,
                                        in_order_bit_exact=ordered,
                                        _work=(T.nbytes(parts) + 4 * count, 0, parts.numel()))}
            by_tree[tree] = lambda mod=mod: mod.column_sum(parts)
        rows += timed(by_tree, device, a, label, checks, label, lambda: parts.sum(0))
        del parts, want, out
    return rows, ok


def main(argv=None) -> int:
    a = parse_args(argv)
    device = T.device_from_arg(a.device)
    trees = {"this": conv1d}
    if a.parent is not None:
        if device.type != "cuda":
            raise ValueError("--parent times two trees' kernels: it needs --device cuda")
        trees["parent"] = T.load_parent(a.parent.resolve(), "conv1d")
    shapes = [("", (a.batch, a.heads, a.n, a.d, a.ksize))]
    if device.type == "cuda":
        shapes += [(f" @ {label}", shape) for label, shape in CARD_SHAPES]
    rows, ok = [], True
    for suffix, shape in shapes:
        got, held = conv_rows(trees, device, shape, suffix, a)
        rows += got
        ok = ok and held
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        got, held = column_sum_rows(trees, device, a)
        rows += got
        ok = ok and held
    for r in rows:
        if r.get("derived"):
            print(f"{r['name']:34s} {T.fmt(r['ms'], '8.4f')} ms", flush=True)
            continue
        lib, fma = r.get("library_ms"), r.get("bound_fp32_fma_ms")
        print(f"{r['name']:34s} {T.fmt(r['ms'], '8.4f')} ms  profiler {T.fmt(r['profiler_ms'])}"
              f"  bound {r['bound_ms']:.4f} ({r['bound_by']}"
              + (f"; as fp32 FMAs {fma:.4f}" if fma is not None else "") + ")"
              + f"  err {r['err']:.3g} vs {r['err_vs']} (bar {r['bar']:g})"
              + (f"  library {T.fmt(lib)} ms (device {T.fmt(r['library_device_ms'])})"
                 if "library_ms" in r else ""), flush=True)
        if r.get("samples_ms") and len(r["samples_ms"]) > 1:
            print(f"    readings {', '.join(T.fmt(s) for s in r['samples_ms'])}", flush=True)
        for s in r.get("split", []):
            print(f"    {s['ms']:9.4f} ms x{s['per_call']:g} {s['kernel'][:90]}", flush=True)
    main_rows = {r["name"]: r for r in rows}
    fused = main_rows["bwd fused dv+dk"]
    print(f"# dkern max abs err / largest magnitude {fused['dkern_sum_err']:.3g} "
          f"(bar {fused['dkern_sum_bar']:g})", flush=True)
    if "parent" in trees:
        for r in rows:
            other = main_rows.get(_tree_name("parent", r["name"]))
            if r["tree"] == "this" and other and r["ms"] and other["ms"]:
                print(f"# {r['name']}: this / parent {r['ms'] / other['ms']:.3f}", flush=True)
    b, h, n, d, K = shapes[0][1]
    T.emit("exp_conv_parts", device, dict(b=b, h=h, n=n, d=d, ksize=K), rows,
           dv_bit_exact=main_rows["bwd dv only"]["err"] == 0.0, ok=ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
