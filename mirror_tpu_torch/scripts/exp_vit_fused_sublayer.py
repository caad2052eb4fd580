"""One ViT sub-layer in one launch, against the split the model runs.

Counterpart of ``scripts/exp_vit_fused_sublayer.py`` at its shapes (B 512,
n 197, 12 heads of 64, d 768, MLP 3072; weights with its ``make_weights``
keys and shapes from a seed), with its variant names:

- ``xla_attn``: the script's baseline in plain torch: the q, k and v
  products, kernel 8 (``vit_attn.mha_natural``), the out product;
- ``k5gG``: the q|k|v product, the attention and the out product in one
  launch of ``csrc/vit_fused.cu`` (a cluster an image, a CTA for every
  head or every two, G images in turn);
- ``xla_mlp``: fc1, ``F.gelu(approximate="none")`` in fp32, fc2;
- ``k7gG``: fc1, GELU and fc2 in one launch (a block G images of rows);
- ``xla_attn_blk`` / ``xla_mlp_blk``: the split path the model runs today,
  kernels 6 and 7 (``vit_attn.attn_block`` with W_qkv split, three
  launches; ``vit_attn.mlp_block``, three launches). The script's own
  ``xla_*_blk`` import ``attn_sublayer`` and ``mlp_sublayer`` from
  ``mirror_tpu/ops/vit_attn_pallas.py``, which defines ``attn_block`` and
  ``mlp_block`` instead, so they print ``FAILED ImportError`` there; k8
  and k9 compute exactly those two functions;
- ``k8gG`` / ``k9gG``: LN, the sub-layer and the residual in one launch;
- ``library_*``, one a group: the yardstick PyTorch calls for the same
  function, which the port never uses on its path (``torch.matmul``, SDPA,
  ``F.gelu``, ``F.layer_norm``).

Each row's ``err`` is the relative Frobenius error against the group's
plain version (``ops/vit_fused.py``, the TPU kernels' rounding points),
held within 1e-2 for the kernel variants, and for k8 and k9 also on what
the half-block adds to x (``err_added``: x dominates the output);
``max_abs_diff`` is against the group's baseline (``xla_*``), as the
script prints it.

    python -m mirror_tpu_torch.scripts.exp_vit_fused_sublayer [--device cuda]
"""

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import vit_attn, vit_fused
from . import _timing as T
from ..utils.platform import default_device

B, N, H, DH = 512, 197, 12, 64
D = H * DH
MLP = 4 * D
LN_EPS = 1e-12
# the script's make_weights: name -> shape (and ln_s, ln_b [1, D] fp32)
WEIGHTS = {"qkv": (D, 3 * D), "qkv_b": (1, 3 * D), "out": (D, D), "out_b": (1, D),
           "fc1": (D, MLP), "fc1_b": (1, MLP), "fc2": (MLP, D), "fc2_b": (1, D)}
MATRICES = ("qkv", "out", "fc1", "fc2")


def make_weights(device: torch.device, seed: int = 0, dtype=torch.bfloat16) -> dict:
    """The script's weights, drawn from a torch generator: the products'
    matrices N(0, 0.02^2) in ``dtype``; the biases the same draws rounded
    to ``dtype`` and kept fp32 (the kernels read fp32 vectors; the script
    adds its bf16 biases in fp32); LN scale 1 + such a draw, shift one,
    fp32."""
    g = torch.Generator(device=device).manual_seed(seed)

    def w(shape):
        return (torch.randn(*shape, generator=g, device=device) * 0.02).to(dtype)

    wts = {name: w(shape) for name, shape in WEIGHTS.items()}
    for name in WEIGHTS:
        if name not in MATRICES:
            wts[name] = wts[name].float()
    wts["ln_s"] = 1.0 + w((1, D)).float()
    wts["ln_b"] = w((1, D)).float()
    return wts


def weights_from_numpy(arrays: dict, device="cpu", dtype=torch.float32) -> dict:
    """The script's weight dict (numpy arrays, as ``np.asarray`` of its
    ``make_weights``) carried across: matrices in ``dtype``, the vectors
    fp32."""
    out = {}
    for name, a in arrays.items():
        t = torch.from_numpy(np.array(a, np.float32)).to(device)
        out[name] = t.to(dtype) if name in MATRICES else t.contiguous()
    return out


# --- the variants: fn(y, wts, heads) ---


def xla_attn(y, wts, heads: int = H):
    d = y.shape[-1]
    w, b = wts["qkv"], wts["qkv_b"][0]
    q, k, v = ((y @ w[:, i * d:(i + 1) * d] + b[i * d:(i + 1) * d]).to(y.dtype)
               for i in range(3))
    o = vit_attn.mha_natural(q, k, v, heads)
    return (o @ wts["out"] + wts["out_b"][0]).to(y.dtype)


def xla_mlp(y, wts, heads: int = H):
    h = (y @ wts["fc1"] + wts["fc1_b"][0]).float()
    h = F.gelu(h, approximate="none").to(y.dtype)
    return (h @ wts["fc2"] + wts["fc2_b"][0]).to(y.dtype)


def _split_qkv(wts, d):
    return [w.contiguous() for w in wts["qkv"].split(d, dim=1)]


def xla_attn_blk(x, wts, heads: int = H):
    """Kernel 6 as the model calls it (separate W_q, W_k, W_v; the three
    split copies are timed with it, 3.5 MB)."""
    return vit_attn.attn_block(x, wts["ln_s"], wts["ln_b"], *_split_qkv(wts, x.shape[-1]),
                               wts["qkv_b"], wts["out"], wts["out_b"], heads, LN_EPS)


def xla_mlp_blk(x, wts, heads: int = H):
    return vit_attn.mlp_block(x, wts["ln_s"], wts["ln_b"], wts["fc1"], wts["fc1_b"],
                              wts["fc2"], wts["fc2_b"], LN_EPS)


def make_k5(group: int):
    return lambda y, wts, heads=H: vit_fused.fused_attn(
        y, wts["qkv"], wts["qkv_b"], wts["out"], wts["out_b"], heads, group)


def make_k7(group: int):
    return lambda y, wts, heads=H: vit_fused.fused_mlp(
        y, wts["fc1"], wts["fc1_b"], wts["fc2"], wts["fc2_b"], group)


def make_k8(group: int):
    return lambda x, wts, heads=H: vit_fused.fused_attn_block(
        x, wts["ln_s"], wts["ln_b"], wts["qkv"], wts["qkv_b"], wts["out"], wts["out_b"], heads,
        LN_EPS, group)


def make_k9(group: int):
    return lambda x, wts, heads=H: vit_fused.fused_mlp_block(
        x, wts["ln_s"], wts["ln_b"], wts["fc1"], wts["fc1_b"], wts["fc2"], wts["fc2_b"], LN_EPS,
        group)


def library_attn(y, wts, heads: int = H):
    b, n, d = y.shape
    qkv = torch.matmul(y, wts["qkv"]) + wts["qkv_b"][0].to(y.dtype)
    q, k, v = (t.view(b, n, heads, d // heads).transpose(1, 2) for t in qkv.split(d, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
    return torch.matmul(o, wts["out"]) + wts["out_b"][0].to(y.dtype)


def library_mlp(y, wts, heads: int = H):
    h = F.gelu(torch.matmul(y, wts["fc1"]) + wts["fc1_b"][0].to(y.dtype), approximate="none")
    return torch.matmul(h, wts["fc2"]) + wts["fc2_b"][0].to(y.dtype)


def _layer_norm(x, wts):
    d = x.shape[-1]
    return F.layer_norm(x, (d,), wts["ln_s"].reshape(d).to(x.dtype),
                        wts["ln_b"].reshape(d).to(x.dtype), LN_EPS)


def library_attn_blk(x, wts, heads: int = H):
    return x + library_attn(_layer_norm(x, wts), wts, heads)


def library_mlp_blk(x, wts, heads: int = H):
    return x + library_mlp(_layer_norm(x, wts), wts, heads)


def plain_attn(y, wts, heads: int = H):
    return vit_fused.fused_attn_ref(y, wts["qkv"], wts["qkv_b"], wts["out"], wts["out_b"], heads)


def plain_mlp(y, wts, heads: int = H):
    return vit_fused.fused_mlp_ref(y, wts["fc1"], wts["fc1_b"], wts["fc2"], wts["fc2_b"])


def plain_attn_blk(x, wts, heads: int = H):
    return vit_fused.fused_attn_block_ref(x, wts["ln_s"], wts["ln_b"], wts["qkv"], wts["qkv_b"],
                                          wts["out"], wts["out_b"], heads, LN_EPS)


def plain_mlp_blk(x, wts, heads: int = H):
    return vit_fused.fused_mlp_block_ref(x, wts["ln_s"], wts["ln_b"], wts["fc1"], wts["fc1_b"],
                                         wts["fc2"], wts["fc2_b"], LN_EPS)


PLAIN = {"attn": plain_attn, "mlp": plain_mlp, "attn_blk": plain_attn_blk,
         "mlp_blk": plain_mlp_blk}
VARIANTS = {
    "xla_attn": ("attn", xla_attn),
    "k5g1": ("attn", make_k5(1)),
    "k5g2": ("attn", make_k5(2)),
    "k5g4": ("attn", make_k5(4)),
    "library_attn": ("attn", library_attn),
    "xla_mlp": ("mlp", xla_mlp),
    "k7g1": ("mlp", make_k7(1)),
    "k7g2": ("mlp", make_k7(2)),
    "k7g4": ("mlp", make_k7(4)),
    "library_mlp": ("mlp", library_mlp),
    "xla_attn_blk": ("attn_blk", xla_attn_blk),
    "k8g1": ("attn_blk", make_k8(1)),
    "k8g2": ("attn_blk", make_k8(2)),
    "library_attn_blk": ("attn_blk", library_attn_blk),
    "xla_mlp_blk": ("mlp_blk", xla_mlp_blk),
    "k9g1": ("mlp_blk", make_k9(1)),
    "k9g2": ("mlp_blk", make_k9(2)),
    "library_mlp_blk": ("mlp_blk", library_mlp_blk),
}


def work(group: str, b: int, wts: dict, heads: int = H) -> dict:
    """Bytes (each input read once, the output written once) and operations
    of a group's function at batch b."""
    rows, d = b * N, D
    act = 2 * rows * d * 2  # bf16 in and out
    ln = 10 * rows * d if group.endswith("_blk") else 0  # statistics, affine, residual
    if group.startswith("attn"):
        names = ("qkv", "qkv_b", "out", "out_b")
        mma = 2 * rows * d * 4 * d + 4 * b * heads * N * N * (d // heads)
        fp32 = 5 * b * heads * N * N + ln  # scale, max, exp, sum, divide
    else:
        names = ("fc1", "fc1_b", "fc2", "fc2_b")
        mma = 4 * rows * d * MLP
        fp32 = 10 * rows * MLP + ln  # bias and the erf GELU
    if group.endswith("_blk"):
        names += ("ln_s", "ln_b")
    return dict(bytes=act + T.nbytes(*(wts[k] for k in names)), mma=mma, fp32=fp32)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--steps", type=int, default=24, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=3, help="timed samples (median)")
    p.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    p.add_argument("--device", default=default_device())
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    device = T.device_from_arg(a.device)
    b = a.batch
    wts = make_weights(device)
    y = T.randn(device, b, N, D, seed=1)
    plains, baselines, rows, ok = {}, {}, [], True
    for name in a.variants:
        group, fn = VARIANTS[name]
        if group not in plains:
            plains[group] = PLAIN[group](y, wts)
        ref = plains[group]
        with T.Launches() as launched:
            out = fn(y, wts)
            ms = T.median_ms(lambda fn=fn: fn(y, wts), device, a.steps, a.reps)
        base = baselines.setdefault(group, out)
        w = work(group, b, wts)
        bound_ms, by = T.bound(w["bytes"], w["mma"], w["fp32"])
        tflops = None if ms is None else w["mma"] / ms / 1e9
        row = dict(name=name, group=group, ms=ms, tflops=tflops, bound_ms=bound_ms, bound_by=by,
                   err=T.rel_err(out, ref), err_vs="plain",
                   max_abs_diff=(out.float() - base.float()).abs().max().item(),
                   launches=launched.counts)
        if group.endswith("_blk"):
            row["err_added"] = T.rel_err(out.float() - y.float(), ref.float() - y.float())
        if name.startswith(("k5", "k8")) and device.type == "cuda":
            row["heads_per_cta"] = vit_fused.heads_per_cta(N, DH, H)
            row["max_active_clusters"] = vit_fused.max_clusters(N, DH, H, device.index or 0)
        if name.startswith("k"):
            ok = ok and row["err"] <= T.BOUND_SINGLE_ROUNDING \
                and row.get("err_added", 0.0) <= T.BOUND_SINGLE_ROUNDING
        rows.append(row)
        added = f", out - x {row['err_added']:.3g}" if "err_added" in row else ""
        print(f"{name}: {T.fmt(ms, '7.4f')} ms  {T.fmt(tflops, '6.1f')} TFLOP/s  bound "
              f"{bound_ms:.4f} ms ({by})  err {row['err']:.3g} vs plain{added}, max|d| vs "
              f"{group} baseline {row['max_abs_diff']:.2e}", flush=True)
    T.emit("exp_vit_fused_sublayer", device, dict(b=b, n=N, heads=H, dh=DH, d=D, mlp=MLP), rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
