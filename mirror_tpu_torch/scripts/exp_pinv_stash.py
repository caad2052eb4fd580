"""What the exact pinv backward keeps of its replay: all of it, or z (and x z).

Counterpart of ``scripts/exp_pinv_stash.py``. The exact backward (kernel
2b, ``ops/pinv.py::_pinv_exact_bwd_kernel`` over ``csrc/pinv.cu``'s batched
GEMM) replays the 6 forward iterations and keeps (z, x z, t3, a) of each in
device memory, 4 x 6 [b h, m, m] bf16 tensors (3.6 GB at b 64), then sweeps
back with 8 products per iteration. The variants, the same gradient:

- ``full``: kernel 2b as it is (stash 4);
- ``z+xz``: keep z and x z, recompute t3 and a in the sweep (2 more
  products per iteration);
- ``z``: keep z, recompute x z, t3 and a (3 more).

Each is timed forward + backward at b 64, h 8, m 384, 6 iterations, on a
unit-normal x as the script draws it, and its gradient held against
``full``'s: at the timed shape (relative errors of dL/dx and dL/ds) and, as
the script prints it, as a cosine at [2, 2, m, m]. ``full`` itself is held
against the plain version ``pinv_exact_bwd_ref`` at the timed shape. All
within kernel 2b's bars in ``chip_smoke.py`` (``_timing``): the probe exits
1 when one is out.

    python -m mirror_tpu_torch.scripts.exp_pinv_stash [--device cuda]
"""

import argparse
import sys

import torch

from ..ops import pinv
from . import _timing as T
from ..utils.platform import default_device

VARIANTS = {"full": 4, "z+xz": 2, "z": 1}
# products of [m, m] per call: the forward's 4 per iteration, and the
# backward's replay (its last z product skipped) and sweep, plus what the
# sweep recomputes
EXTRA = {4: 0, 2: 2, 1: 3}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--b", type=int, default=64)
    p.add_argument("--h", type=int, default=8)
    p.add_argument("--m", type=int, default=384)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--chain", type=int, default=6, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=3, help="timed samples (median)")
    p.add_argument("--device", default=default_device())
    return p.parse_args(argv)


def _grad(x, iters, stash):
    """dL/dx of L = sum(pinv(x)^2) through the variant's backward, with
    dL/ds's own share summed into it by autograd (as jax.grad does)."""
    leaf = x.detach().clone().requires_grad_()
    z = pinv.moore_penrose_pinv_stash(leaf, iters, stash)
    z.float().square().sum().backward()
    return leaf.grad


def _errors(gx, gs, ref_gx, ref_gs):
    """(relative Frobenius error of dL/dx, relative error of dL/ds)."""
    return (T.rel_err(gx, ref_gx),
            abs((gs - ref_gs).item()) / max(abs(ref_gs.item()), 1e-30))


def main(argv=None) -> int:
    a = parse_args(argv)
    device = T.device_from_arg(a.device)
    b, h, m, iters = a.b, a.h, a.m, a.iters
    x = T.randn(device, b, h, m, m, seed=0)
    small = T.randn(device, 2, 2, m, m, seed=0)

    g_small = {name: _grad(small, iters, stash) for name, stash in VARIANTS.items()}
    cos = {name: T.cosine(g, g_small["full"]) for name, g in g_small.items()}
    for name in list(VARIANTS)[1:]:
        print(f"# {name} grad cosine vs full: {cos[name]:.6f}", flush=True)

    # the backward's outputs at the timed shape, each variant against full
    s = pinv.global_scale(x)
    g = T.randn(device, b, h, m, m, seed=1)
    bwd = pinv._pinv_exact_bwd_kernel if device.type == "cuda" else None
    outs = {}
    for name, stash in VARIANTS.items():
        if bwd is not None:
            outs[name] = bwd(x, s, g, iters, stash)
        elif stash == 4:
            outs[name] = pinv.pinv_exact_bwd_ref(x, s, g, iters)
        else:
            outs[name] = pinv.pinv_exact_bwd_stash_ref(x, s, g, iters, stash)

    # full (kernel 2b) against its plain version on the same inputs
    plain_gx, plain_gs = pinv.pinv_exact_bwd_ref(x, s, g, iters)
    full_gx, full_gs = outs["full"]
    err_gx, err_gs = _errors(full_gx, full_gs, plain_gx, plain_gs)
    vs_plain = dict(err_gx=err_gx, err_gs=err_gs, cosine_gx=T.cosine(full_gx, plain_gx))
    del plain_gx
    ok = (vs_plain["err_gx"] <= T.BOUND_PINV_BWD and vs_plain["err_gs"] <= T.BOUND_PINV_BWD
          and vs_plain["cosine_gx"] >= T.BOUND_PINV_BWD_COS)
    print(f"# full vs plain: gx err {vs_plain['err_gx']:.3g}, gs err {vs_plain['err_gs']:.3g}, "
          f"gx cosine {vs_plain['cosine_gx']:.6f} (bars {T.BOUND_PINV_BWD:g}, "
          f"{T.BOUND_PINV_BWD_COS:g})", flush=True)

    per_product = 2 * b * h * m ** 3
    rows = []
    for name, stash in VARIANTS.items():
        products = 4 * iters + (12 + EXTRA[stash]) * iters - 1
        bound_ms, by = T.bound(3 * T.nbytes(x), products * per_product)
        fn = lambda stash=stash: _grad(x, iters, stash)  # noqa: E731
        with T.Launches() as launched:
            ms = T.median_ms(fn, device, a.chain, a.reps, warmup=1)
        gx, gs = outs[name]
        err_gx, err_gs = _errors(gx, gs, full_gx, full_gs)
        row_ok = (err_gx <= T.BOUND_PINV_BWD and err_gs <= T.BOUND_PINV_BWD
                  and cos[name] >= T.BOUND_PINV_BWD_COS)
        ok = ok and row_ok
        rows.append(dict(name=name, stash=stash, products=products, ms=ms, bound_ms=bound_ms,
                         bound_by=by, err_gx=err_gx, err_gs=err_gs, err_vs="full",
                         grad_cosine_small=cos[name],
                         bit_exact=bool(torch.equal(gx, full_gx)),
                         stash_gb=stash * iters * b * h * m * m * x.element_size() / 1e9,
                         launches=launched.counts,
                         **({"vs_plain": vs_plain} if name == "full" else {})))
        print(f"fwd+bwd  {name:5s}: {T.fmt(ms, '8.3f')} ms/call  ({products} products, bound "
              f"{bound_ms:.3f} ms by {by}; gx err {err_gx:.3g}, gs err {err_gs:.3g} vs full)",
              flush=True)
    T.emit("exp_pinv_stash", device, dict(b=b, h=h, m=m, iters=iters), rows, ok=ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
