"""The card's copy floor of device memory under the TPU probe's layouts.

Counterpart of ``scripts/exp_hbm_floor.py``: a plain copy (out = in) of
bf16 [b, h, n, d] under the script's launch shapes, beside elementwise
floors, each reported in GB/s (bytes read + bytes written over the time):

- torch elementwise ``x * 1.0001`` on a flat 64 Mi-element tensor and on
  [b, h, n, 96] and [b, h, n, 128] (the script's XLA floors);
- ``csrc/copy_floor.cu`` with a block per (gb batch rows, head): gb 8 / 4 /
  1 at d 96 and gb 8 at d 128 (``copy_floor``, :54); a block per head for
  the whole batch (``run_flat``, :103: 8 blocks, so it reads low from
  occupancy); a block per (8 rows, head, 384-row tile) (``run_ntile``,
  :126); gb 8 on the first 16 and 32 batch rows, so the same blocks on 16
  and 32 SMs: the rate one block reaches (``per_block_gbps``) when device
  memory is not the limit;
- ``dst.copy_(src)``, a device-to-device copy, as the library yardstick.

Each copy is held bit for bit against its plain version, ``x.clone()``. The
last line, beside the variants, names the best rate measured: the copy
floor against which the port's byte-bound kernels are read.

    python -m mirror_tpu_torch.scripts.exp_hbm_floor [--device cuda]
"""

import argparse
import sys

import torch

from ..ops import copy_floor as cf
from . import _timing as T

ROW_TILE = 384  # conv1d_pallas.ROW_TILE, the script's n tile


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--n", type=int, default=2304)
    p.add_argument("--d", type=int, default=96)
    p.add_argument("--d-wide", type=int, default=128)
    p.add_argument("--flat", type=int, default=64 * 1024 * 1024,
                   help="elements of the flat tensor of the elementwise floor")
    p.add_argument("--steps", type=int, default=20, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=5, help="timed samples (median)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    device = T.device_from_arg(a.device)
    b, h, n = a.batch, a.heads, a.n
    flat = T.randn(device, a.flat, seed=0)
    v96 = T.randn(device, b, h, n, a.d, seed=1)
    v128 = T.randn(device, b, h, n, a.d_wide, seed=2)
    dst96, dst128 = torch.empty_like(v96), torch.empty_like(v128)

    def copy(src, gb, tile=None):  # the kernel's call, and its grid's blocks
        sb, sh, sn, _ = src.shape
        blocks = -(-sb // gb) * sh * -(-sn // (tile or sn))
        return (lambda: cf.copy_floor(src, gb, tile)), blocks

    variants = [
        ("torch elementwise flat", flat, (lambda: flat * 1.0001, None), None),
        (f"torch elementwise [b,h,n,{a.d}]", v96, (lambda: v96 * 1.0001, None), None),
        (f"torch elementwise [b,h,n,{a.d_wide}]", v128, (lambda: v128 * 1.0001, None), None),
        (f"copy gb=8 d={a.d}", v96, copy(v96, 8), "kernel"),
        (f"copy gb=4 d={a.d}", v96, copy(v96, 4), "kernel"),
        (f"copy gb=1 d={a.d}", v96, copy(v96, 1), "kernel"),
        (f"copy gb=8 d={a.d_wide}", v128, copy(v128, 8), "kernel"),
        ("copy whole-b block, grid=h", v96, copy(v96, b), "kernel"),
        (f"copy n-tiled {ROW_TILE} blocks", v96, copy(v96, 8, ROW_TILE), "kernel"),
        *[(f"copy gb=8 d={a.d}, b={rows}", v96[:rows], copy(v96[:rows], 8), "kernel")
          for rows in (16, 32) if rows < b],
        (f"library dst.copy_(src) d={a.d}", v96, (lambda: dst96.copy_(v96), None), "library"),
        (f"library dst.copy_(src) d={a.d_wide}", v128, (lambda: dst128.copy_(v128), None),
         "library"),
    ]
    rows, ok = [], True
    for name, src, (fn, blocks), kind in variants:
        moved = 2 * T.nbytes(src)  # read once, written once
        bound_ms, by = T.bound(moved)
        with T.Launches() as launched:
            out = fn()
            exact = None
            if kind == "kernel":
                exact = bool(torch.equal(out, cf.copy_floor_ref(src)))
                ok = ok and exact
            del out
            ms = T.median_ms(fn, device, a.steps, a.reps)
        gbps = None if ms is None else moved / ms / 1e6
        row = dict(name=name, kind=kind or "elementwise", ms=ms, gbps=gbps, bound_ms=bound_ms,
                   bound_by=by, bit_exact=exact, launches=launched.counts)
        if blocks:
            row.update(blocks=blocks, per_block_gbps=None if gbps is None else gbps / blocks)
        rows.append(row)
        print(f"{name:34s} {T.fmt(ms, '8.4f')} ms  {T.fmt(gbps, '7.1f')} GB/s  "
              f"(bound {bound_ms:.4f} ms by {by})"
              + ("" if exact is None else f"  bit-exact {exact}")
              + ("" if not blocks or gbps is None
                 else f"  {blocks} blocks, {gbps / blocks:.1f} GB/s a block"), flush=True)
    rates = [r["gbps"] for r in rows if r["gbps"] is not None]
    best = max(rates) if rates else None
    print(f"best measured rate: {T.fmt(best, '.1f')} GB/s (nominal "
          f"{T.PEAK_BYTES / 1e9:.0f} GB/s)", flush=True)
    T.emit("exp_hbm_floor", device, dict(b=b, h=h, n=n, d=a.d, d_wide=a.d_wide, flat=a.flat),
           rows, best_gbps=best, nominal_gbps=T.PEAK_BYTES / 1e9)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
