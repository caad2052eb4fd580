"""The ViT attention core under the TPU probe's layouts and block shapes.

Counterpart of ``scripts/exp_vit_attn_kernel.py``: softmax(q k^T / sqrt(dh))
v at B 512, n 197, 12 heads of 64, from and to the natural [b, n, 768]
layout, all on ``csrc/vit_attn.cu`` (a block of 8 warps walks G
consecutive (image, head) pairs, loading each pair's keys and values once,
the next pair's while this one computes):

- ``xla``: the script's baseline ``attn_xla`` in plain torch (einsums in
  the compute dtype, the softmax in fp32);
- ``k1gG``: head-major [b h, n, dh] pairs, G a block, the relayout to and
  from head-major timed with it (the script's ``hm``). ``k2gG`` is the same
  CUDA instance: on the TPU k1 and k2 differ only in how Mosaic lowers a
  batched dot against unrolled dots, which has no counterpart here;
- ``k3gN``: the natural layout, N whole images a block (N x 12 pairs);
- ``k8``: kernel 8 as the model runs it (G 1: one block an SM, each
  walking its share of the pairs);
- ``library``: SDPA on the [b, h, n, dh] views.

Errors are against the plain version ``mha_natural_ref`` (fp32 scores and
softmax, the kernel's rounding points), held within 1e-2 relative
Frobenius, with the max abs difference to ``xla`` as the script prints it.

    python -m mirror_tpu_torch.scripts.exp_vit_attn_kernel [--device cuda]
"""

import argparse
import sys

import torch
import torch.nn.functional as F

from ..ops import vit_attn
from . import _timing as T

B, N, H, DH = 512, 197, 12, 64
D = H * DH


def attn_xla(q, k, v, heads: int = H):
    """The script's ``attn_xla``: the einsum formulation from and to [b, n, d]."""
    b, n, d = q.shape
    dh = d // heads
    q, k, v = (t.reshape(b, n, heads, dh) for t in (q, k, v))
    a = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    a = torch.softmax(a.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, n, d)


def make_headmajor(group: int, heads: int = H):
    def fn(q, k, v):
        b, n, d = q.shape
        dh = d // heads

        def hm(t):
            return t.view(b, n, heads, dh).transpose(1, 2).reshape(b * heads, n, dh)

        oz = vit_attn.mha_headmajor(hm(q), hm(k), hm(v), group)
        return oz.view(b, heads, n, dh).transpose(1, 2).reshape(b, n, d)
    return fn


def make_natural(images: int, heads: int = H):
    return lambda q, k, v: vit_attn.mha_natural(q, k, v, heads, images)


def library(q, k, v, heads: int = H):
    b, n, d = q.shape

    def by_head(t):
        return t.view(b, n, heads, d // heads).transpose(1, 2)

    return F.scaled_dot_product_attention(by_head(q), by_head(k), by_head(v))


VARIANTS = {
    "xla": attn_xla,
    "k1g8": make_headmajor(8),
    "k1g16": make_headmajor(16),
    "k1g32": make_headmajor(32),
    "k2g8": make_headmajor(8),
    "k2g16": make_headmajor(16),
    "k3g1": make_natural(1),
    "k3g2": make_natural(2),
    "k3g4": make_natural(4),
    "k3g8": make_natural(8),
    "k8": lambda q, k, v: vit_attn.mha_natural(q, k, v, H),
    "library": library,
}
SAME_INSTANCE = {"k2g8": "k1g8", "k2g16": "k1g16"}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--steps", type=int, default=24, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=3, help="timed samples (median)")
    p.add_argument("--variants", nargs="+", default=list(VARIANTS))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    device = T.device_from_arg(a.device)
    b = a.batch
    q, k, v = (T.randn(device, b, N, D, seed=i) for i in range(3))
    flops = 4 * b * H * N * N * DH
    bound_ms, by = T.bound(4 * T.nbytes(q), flops, 5 * b * H * N * N)
    ref = vit_attn.mha_natural_ref(q, k, v, H)
    xla = attn_xla(q, k, v)
    rows, ok = [], True
    for name in a.variants:
        fn = VARIANTS[name]
        with T.Launches() as launched:
            if name == "library":
                out = fn(q, k, v).transpose(1, 2).reshape(b, N, D)
            else:
                out = fn(q, k, v)
            err = T.rel_err(out, ref)
            diff = (out.float() - xla.float()).abs().max().item()
            ms = T.median_ms(lambda fn=fn: fn(q, k, v), device, a.steps, a.reps)
        kernel = name.startswith("k")
        if kernel:
            ok = ok and err <= T.BOUND_SINGLE_ROUNDING
        tflops = None if ms is None else flops / ms / 1e9
        row = dict(name=name, ms=ms, tflops=tflops, bound_ms=bound_ms, bound_by=by, err=err,
                   err_vs="plain", max_abs_diff_vs_xla=diff, launches=launched.counts)
        if name.startswith(("k1", "k2")):
            row["instance"] = ("vit_attn.cu head-major ([b h, n, dh], heads 1), G pairs a block,"
                               " relayout timed")
        if name in SAME_INSTANCE:
            row["same_instance_as"] = SAME_INSTANCE[name]
        rows.append(row)
        print(f"{name}: {T.fmt(ms, '7.4f')} ms  {T.fmt(tflops, '6.1f')} TFLOP/s  err "
              f"{err:.3g} vs plain, max|d| vs xla {diff:.2e}", flush=True)
    T.emit("exp_vit_attn_kernel", device, dict(b=b, n=N, heads=H, dh=DH), rows,
           bound_ms=bound_ms, bound_by=by)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
