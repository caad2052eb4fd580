"""The standalone depthwise conv's passes, timed apart on the card.

Counterpart of ``scripts/exp_conv_parts.py``, which times
``conv1d_pallas._fwd_call`` and ``_bwd_call`` (kernels 9 and 9b) and XLA's
grouped conv at [64, 8, 2304, 96], K 33. Here kernels 9 and 9b of
``csrc/conv1d.cu`` are launched straight into outputs and scratch allocated
before the timing, so no autograd work paces a run of calls, and 9b is
split into its parts:

- ``fwd``: kernel 9;
- ``bwd fused dv+dk``: kernel 9b (dv and the dkern partials in one pass,
  then their column sum);
- ``bwd dv only``: 9b's instance without the dkern slide (bit for bit the
  fused dv);
- ``column sum``: the second pass alone, on the fused pass's partials;
- ``dkern slide (derived)``: fused - dv only - column sum;
- the library calls, as ``chip_smoke.py`` phase 3 builds them: ``F.conv2d``
  (groups h, a (K, 1) filter) and ``aten.convolution_backward``.

The device time of each kernel is also read from ``torch.profiler`` as a
cross-check of the CUDA events. Each kernel is held against its plain
version within ``chip_smoke.py``'s bars for kernels 9 and 9b (``_timing``):
the probe exits 1 when one is out.

    python -m mirror_tpu_torch.scripts.exp_conv_parts [--device cuda]
"""

import argparse
import statistics
import sys

import torch
import torch.nn.functional as F

from ..ops import conv1d
from . import _timing as T

# the kernels each variant launches, as the profiler names them (csrc/conv1d.cu,
# common.cuh): the fused backward's second pass is the column sum
PROFILED = {"fwd": ("conv1d_kernel",),
            "bwd fused dv+dk": ("conv1d_bwd_kernel<true>", "column_sum_kernel"),
            "bwd dv only": ("conv1d_bwd_kernel<false>",), "column sum": ("column_sum_kernel",)}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--n", type=int, default=2304)
    p.add_argument("--d", type=int, default=96)
    p.add_argument("--ksize", type=int, default=33)
    p.add_argument("--steps", type=int, default=20, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=5, help="timed samples (median)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def profiled_ms(fns, device) -> dict:
    """Device ms per call of each variant, from torch.profiler over 10 calls
    of it alone: the mean duration of each kernel it launches, summed (so
    an event the profiler dropped does not count as time); None where the
    profiler shows no device event of one of them."""
    if device.type != "cuda":
        return {name: None for name in fns}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        us = {kernel: [] for kernel in PROFILED[name]}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                for kernel in PROFILED[name]:
                    if kernel in ev.name:
                        us[kernel].append(ev.time_range.elapsed_us())
        out[name] = (sum(statistics.mean(v) for v in us.values()) / 1e3
                     if all(us.values()) else None)
    return out


def main(argv=None) -> int:
    a = parse_args(argv)
    device = T.device_from_arg(a.device)
    b, h, n, d, K = a.batch, a.heads, a.n, a.d, a.ksize
    v = T.randn(device, b, h, n, d, seed=0)
    g = T.randn(device, b, h, n, d, seed=1)
    kern = T.randn(device, h, K, dtype=torch.float32, seed=2)
    taps = kern.to(torch.bfloat16)
    weight = taps.view(h, 1, K, 1)
    on_card = device.type == "cuda"

    # outputs and scratch allocated once, before any timing
    out, dv, dv_only = torch.empty_like(v), torch.empty_like(v), torch.empty_like(v)
    dkern = torch.empty(h, K, dtype=torch.float32, device=device)
    if on_card:
        partial = conv1d.conv1d_bwd_scratch(v, K)
        fns = {
            "fwd": lambda: conv1d.conv1d_fwd_into(v, taps, out),
            "bwd fused dv+dk": lambda: conv1d.conv1d_bwd_into(v, taps, g, dv, dkern, partial),
            "bwd dv only": lambda: conv1d.conv1d_bwd_dv(g, taps, out=dv_only),
            "column sum": lambda: conv1d.column_sum(partial),
        }
    else:  # the plain versions; the partials one per batch row
        partial = torch.stack([conv1d.depthwise_conv_seq_bwd_ref(v[i:i + 1], taps, g[i:i + 1])[1]
                               .reshape(-1) for i in range(b)])

        def fused():
            dv_ref, dk = conv1d.depthwise_conv_seq_bwd_ref(v, taps, g)
            dv.copy_(dv_ref)
            dkern.copy_(dk)
        fns = {
            "fwd": lambda: out.copy_(conv1d.depthwise_conv_seq_ref(v, taps)),
            "bwd fused dv+dk": fused,
            "bwd dv only": lambda: conv1d.conv1d_bwd_dv(g, taps, out=dv_only),
            "column sum": lambda: conv1d.column_sum(partial),
        }
    library = {
        "fwd": lambda: F.conv2d(v, weight, padding=(K // 2, 0), groups=h),
        "bwd fused dv+dk": lambda: torch.ops.aten.convolution_backward(
            g, v, weight, None, [1, 1], [K // 2, 0], [1, 1], False, [0, 0], h,
            [True, True, False]),
        "column sum": lambda: partial.sum(0),
    }

    fmas = 2 * K * v.numel()
    work = {"fwd": T.bound(2 * T.nbytes(v), fp32_flops=fmas),
            "bwd fused dv+dk": T.bound(3 * T.nbytes(v), fp32_flops=2 * fmas),
            "bwd dv only": T.bound(2 * T.nbytes(v), fp32_flops=fmas),
            "column sum": T.bound(T.nbytes(partial) + 4 * h * K, fp32_flops=partial.numel())}
    # each variant once, then held against its plain version
    launched, results = {}, {}
    for name, fn in fns.items():
        with T.Launches() as counts:
            results[name] = fn()
        launched[name] = counts.counts
    ref_out = conv1d.depthwise_conv_seq_ref(v, taps).to(v.dtype)
    ref_dv, ref_dk = conv1d.depthwise_conv_seq_bwd_ref(v, taps, g)
    errs = {"fwd": T.rel_err(out, ref_out),
            "bwd fused dv+dk": max(T.rel_err(dv, ref_dv), T.rel_err(dkern, ref_dk)),
            "bwd dv only": T.rel_err(dv_only, dv),
            "column sum": T.rel_err(results["column sum"], partial.float().sum(0))}
    # the bars, chip_smoke.py's for kernels 9 and 9b: the fused dkern, a sum
    # over the batch, also by its max abs error against its largest value
    bars = {"fwd": T.BOUND_SINGLE_ROUNDING, "bwd fused dv+dk": T.BOUND_BWD, "bwd dv only": 0.0,
            "column sum": T.BOUND_SINGLE_ROUNDING}
    dkern_sum_err, dkern_sum_bar = T.sum_err(dkern, ref_dk), T.sum_bound(dkern)
    dv_exact = bool(torch.equal(dv_only, dv))
    ok = (dv_exact and all(errs[name] <= bar for name, bar in bars.items())
          and dkern_sum_err <= dkern_sum_bar)

    rows, times = [], {}
    for name, fn in fns.items():
        with T.Launches() as counts:
            times[name] = T.median_ms(fn, device, a.steps, a.reps)
        lib = library.get(name)
        lib_ms = T.median_ms(lib, device, a.steps, a.reps) if lib else None
        bound_ms, by = work[name]
        launches = {k: launched[name].get(k, 0) + counts.counts.get(k, 0)
                    for k in set(launched[name]) | set(counts.counts)}
        rows.append(dict(name=name, ms=times[name], bound_ms=bound_ms, bound_by=by,
                         err=errs[name], err_vs="the fused dv" if name == "bwd dv only"
                         else "plain", bar=bars[name], library_ms=lib_ms, launches=launches))
        if name == "bwd fused dv+dk":
            rows[-1].update(dkern_sum_err=dkern_sum_err, dkern_sum_bar=dkern_sum_bar)
    slide = None
    if on_card:
        slide = times["bwd fused dv+dk"] - times["bwd dv only"] - times["column sum"]
    rows.append(dict(name="dkern slide (derived)", ms=slide, derived=True,
                     formula="bwd fused dv+dk - bwd dv only - column sum"))
    prof = profiled_ms(fns, device)
    for r in rows:
        if r["name"] in prof:
            r["profiler_ms"] = prof[r["name"]]
        lib = r.get("library_ms")
        print(f"{r['name']:22s} {T.fmt(r['ms'], '8.4f')} ms"
              + ("" if r.get("derived") else
                 f"  profiler {T.fmt(r['profiler_ms'], '.4f')}  bound {r['bound_ms']:.4f} "
                 f"({r['bound_by']})  err {r['err']:.3g} vs {r['err_vs']} (bar {r['bar']:g})"
                 + (f"  library {T.fmt(lib)} ms" if r['name'] in library else "")),
              flush=True)
    print(f"# dkern max abs err / largest magnitude {dkern_sum_err:.3g} (bar {dkern_sum_bar:g})",
          flush=True)
    T.emit("exp_conv_parts", device, dict(b=b, h=h, n=n, d=d, ksize=K), rows,
           dv_bit_exact=dv_exact, ok=ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
