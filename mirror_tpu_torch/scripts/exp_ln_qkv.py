"""The fused LayerNorm + q/k/v projection against its unfused forms.

Counterpart of ``scripts/exp_ln_qkv.py``, at its shape (B 64, n 2117, d
768, 8 heads), forward and forward + backward:

- ``xla``: :func:`dense_ln_qkv`, plain torch: the fast-variance LN in fp32,
  one matmul in the compute dtype, the head split (the script's XLA
  lowering);
- ``fused|bigg``: kernel 10 (``csrc/ln_qkv.cu``; 10b for the backward).
  The script's ``big_core`` (one [d, 3d] GEMM, then the head-major slices)
  is kernel 10's design: an LN pass, then one full-width ``wgmma`` GEMM fed
  by TMA whose epilogue stores each head's box in place, where the TPU
  library kernel ran per-head dots. So the two are one row here, not two
  copies;
- ``library``: ``layer_norm`` + a cuBLAS ``matmul`` with the head-major
  view, as ``chip_smoke.py`` row 10 times it.

Errors are against the plain versions ``ln_qkv_ref`` / ``ln_qkv_bwd_ref``
(fp32 products, the kernels' rounding points). Kernels 10 and 10b are held
within ``chip_smoke.py``'s bars for them (``_timing``): the relative
Frobenius error of every output, and the batch sums gs, gb and gw also by
their max abs error against their largest value. The probe exits 1 when one
is out. On the card each ``fused|bigg`` row also prints its share of the
bound, its ratio to the ``library`` row, and the ``torch.profiler`` split
of one call by kernel launch (``split`` in its JSON row).

    python -m mirror_tpu_torch.scripts.exp_ln_qkv [--device cuda]
"""

import argparse
import sys

import torch
import torch.nn.functional as F

from ..ops import ln_qkv
from . import _timing as T
from ..utils.platform import default_device

EPS = 1e-5


def dense_ln_qkv(x, s, b, w, heads: int, eps: float = EPS):
    """The script's ``dense_ln_qkv``: flax's fast-variance LN in fp32, y in
    x's dtype, one product with w [d, 3 h dh] in y's dtype, then head-major
    q, k, v [b, h, n, dh]."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = ((xf - mu) * torch.rsqrt(var + eps) * s.float() + b.float()).to(x.dtype)
    bsz, n, _ = x.shape
    dh = w.shape[1] // (3 * heads)
    qkv = y @ w.to(y.dtype)
    return tuple(t.contiguous() for t in
                 qkv.view(bsz, n, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n", type=int, default=2117)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--chain", type=int, default=8, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=5, help="timed samples (median)")
    p.add_argument("--device", default=default_device())
    return p.parse_args(argv)


def _grad_fn(core, inputs, grads):
    """A callable that runs ``core`` forward and its backward for the
    incoming ``grads``, returning (outputs, gradients)."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]

    def run():
        outs = core(*leaves)
        return outs, torch.autograd.grad(outs, leaves, grads)
    return run


def main(argv=None) -> int:
    a = parse_args(argv)
    device = T.device_from_arg(a.device)
    bsz, n, d, heads, R = a.batch, a.n, a.d, a.heads, a.chain
    dh = d // heads
    x = T.randn(device, bsz, n, d, seed=0)
    s = torch.ones(d, device=device)
    b = torch.zeros(d, device=device)
    w = T.randn(device, d, 3 * d, scale=0.02, dtype=torch.float32, seed=1).to(torch.bfloat16)
    grads = tuple(T.randn(device, bsz, heads, n, dh, seed=2 + i) for i in range(3))
    rows_n = bsz * n

    def library(x, s, b, w):
        y = F.layer_norm(x, (d,), s.to(x.dtype), b.to(x.dtype), EPS) @ w
        return y.view(bsz, n, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)

    cores = {
        "xla": lambda x, s, b, w: dense_ln_qkv(x, s, b, w, heads),
        "fused|bigg": lambda x, s, b, w: ln_qkv.ln_qkv_fused(x, s, b, w, heads, EPS),
        "library": library,
    }
    ref = ln_qkv.ln_qkv_ref(x, s, b, w, heads, EPS)
    ref_gx, ref_gw, ref_gs, ref_gb = ln_qkv.ln_qkv_bwd_ref(x, s, b, w, *grads, heads, EPS)
    ref_grads = (ref_gx, ref_gs, ref_gb, ref_gw)  # the inputs' order: x, s, b, w
    mma = 2 * rows_n * d * 3 * d
    qkv_bytes = 3 * rows_n * heads * dh * x.element_size()
    fwd_bound = T.bound(T.nbytes(x, s, b, w) + qkv_bytes, mma, 8 * rows_n * d)
    both_bound = T.bound(2 * T.nbytes(x, s, b, w) + 2 * qkv_bytes, 3 * mma, 24 * rows_n * d)
    note = {"fused|bigg": "kernel 10 / 10b is big_core's design (one [d, 3d] GEMM, a "
                          "head-major epilogue): one instance for both rows"}

    # the kernels' bars (the fused|bigg rows); the other rows' errors are
    # reported, not held
    bars = {"fwd": T.BOUND_SINGLE_ROUNDING, "fwd+bwd": T.BOUND_BWD}
    rows, ok = [], True
    for mode, bound in (("fwd", fwd_bound), ("fwd+bwd", both_bound)):
        for name, core in cores.items():
            held = {}
            with T.Launches() as launched:
                if mode == "fwd":
                    fn = lambda core=core: core(x, s, b, w)  # noqa: E731
                    err = max(T.rel_err(o, r) for o, r in zip(fn(), ref))
                else:
                    fn = _grad_fn(core, (x, s, b, w), grads)
                    outs = fn()[1]
                    err = max(T.rel_err(o, r) for o, r in zip(outs, ref_grads))
                    sums = dict(zip(("gs", "gb", "gw"), zip(outs[1:], ref_grads[1:])))
                    held = dict(sum_err={g: T.sum_err(o, r) for g, (o, r) in sums.items()},
                                sum_bar={g: T.sum_bound(o) for g, (o, _) in sums.items()})
                ms = T.median_ms(fn, device, R, a.reps)
            if name == "fused|bigg":
                fused_call = fn
                held["bar"] = bars[mode]
                ok = ok and err <= bars[mode] and all(
                    e <= held["sum_bar"][g] for g, e in held.get("sum_err", {}).items())
            tflops = None if ms is None else (mma if mode == "fwd" else 3 * mma) / ms / 1e9
            rows.append(dict(name=f"{mode} {name}", mode=mode, ms=ms, tflops=tflops,
                             bound_ms=bound[0], bound_by=bound[1], err=err, err_vs="plain",
                             launches=launched.counts, **held,
                             **({"note": note[name]} if name in note else {})))
            print(f"{mode:8s} {name:11s}: {T.fmt(ms, '8.4f')} ms/call  "
                  f"{T.fmt(tflops, '6.1f')} TFLOP/s  bound {bound[0]:.4f} ms ({bound[1]})  "
                  f"err {err:.3g}" + (f" (bar {held['bar']:g})" if "bar" in held else ""),
                  flush=True)
        fused_row, library_row = rows[-2], rows[-1]
        if device.type == "cuda":
            split = T.launch_split(fused_call)
            fused_row["split"] = [dict(kernel=k, ms=kms, per_call=c) for k, kms, c in split]
            print(f"{mode:8s} fused|bigg: {100 * fused_row['bound_ms'] / fused_row['ms']:.1f} % of "
                  f"its bound, kernel / library {fused_row['ms'] / library_row['ms']:.2f}; one "
                  f"call by launch (torch.profiler):", flush=True)
            for kname, kms, cnt in split:
                print(f"    {kms:9.4f} ms x{cnt:g} {kname[:100]}", flush=True)
    T.emit("exp_ln_qkv", device, dict(b=bsz, n=n, d=d, heads=heads, dh=dh), rows, ok=ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
