"""The Nystrom softmax attention on wgmma against the shipped mma.sync kernels.

A probe beside ``csrc/softmax_attn.cu`` and ``csrc/softmax_attn_bwd.cu``
(kernels 3, 3b, 4 and 3c, 4b). It builds ``csrc/wgmma_variant/`` (the same
C entries, every product a warpgroup ``wgmma``, tiles unswizzled, each
product awaited in turn) with ``csrc/conv1d.cu`` (kernel 4b's conv
backward) into a library of its own under ``build/kernels/wgmma_variant/``
(the shipped library is untouched), and runs the wrappers of
``ops/nystrom_attn`` on either library. Each row is held against its plain
version (forward at BOUND_SINGLE_ROUNDING, backward at BOUND_BWD against
the JAX-shaped ``softmax_attn_bwd_ref``) and timed in the order shipped,
wgmma, wgmma, shipped (each the median of runs of calls, CUDA events; the
two readings of each build are averaged), with SDPA and its backward on
zero-padded k and v beside kernels 3 and 3c. It prints what ``-Xptxas -v``
says of the variant, one line a row and one JSON line. At the slice's
shape (b 16, h 8, dh 96, m 384, n 2117, pad 187):

    python -m mirror_tpu_torch.scripts.exp_attn_wgmma

Exits 1 if either build disagrees with a plain version beyond its bar.
"""

import argparse
import contextlib
import ctypes
import sys
from functools import partial

import torch
import torch.nn.functional as F

from ..ops import _common, nystrom_attn as na
from ..ops.conv1d import depthwise_conv_seq_bwd_ref
from . import _timing as T

VARIANT_DIR = _common.CSRC_DIR / "wgmma_variant"
OUT_DIR = _common.BUILD_DIR / "wgmma_variant"
SOURCES = (VARIANT_DIR / "softmax_attn.cu", VARIANT_DIR / "softmax_attn_bwd.cu",
           _common.CSRC_DIR / "conv1d.cu")
ENTRIES = ("mirror_softmax_attn", "mirror_softmax_attn_bwd")
SCRATCH = "mirror_conv1d_bwd_partial_elems"
B, H, DH, M, N, PAD, TAPS = 16, 8, 96, 384, 2117, 187, 33


def build() -> ctypes.CDLL:
    """The variant's library (one nvcc a source, all at once, then a link),
    its entries typed as the shipped library's; prints ptxas' report."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _common._nvcc()
    objects = [OUT_DIR / f"{src.stem}.o" for src in SOURCES]
    errs = _common._run_all([[nvcc, *_common.NVCC_FLAGS, "-Xptxas", "-v", f"-I{VARIANT_DIR}",
                              f"-I{_common.CSRC_DIR}", "-c", "-o", str(obj), str(src)]
                             for src, obj in zip(SOURCES, objects)])
    for src, err in zip(SOURCES[:2], errs):
        for line in err.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[ptxas] wgmma_variant/{src.name}: {line.split('info    :')[-1].strip()}")
    path = OUT_DIR / "libattn_wgmma.so"
    _common._run_all([[nvcc, *_common.NVCC_FLAGS, "-shared", "-o", str(path),
                       *map(str, objects)]])
    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        getattr(lib, name).argtypes = list(_common._SIGNATURES[name])
        getattr(lib, name).restype = ctypes.c_int
    getattr(lib, SCRATCH).argtypes = list(_common._SCRATCH_SIZES[SCRATCH])
    getattr(lib, SCRATCH).restype = ctypes.c_int64
    return lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The wrappers launch from ``lib`` inside the block (only the
    attention entries and the conv's scratch size are asked of it)."""
    _common.library()  # the shipped library, built and loaded first
    saved, _common._LIB = _common._LIB, lib
    try:
        yield
    finally:
        _common._LIB = saved


def forward(fn, *args):
    """A call of ``fn`` on fixed inputs."""
    return lambda: fn(*args)


def backward(fn, inputs, grad):
    """A call that runs autograd's backward of ``fn`` on fixed leaves; the
    forward runs here, once, so the residuals come from the library that is
    current now."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def rows(device):
    """{name: (make the kernel call, plain call, bar, make the SDPA call or
    None)}; a call is made inside the build that it is to run on."""
    def rn(*shape, scale=1.0, seed):
        return T.randn(device, *shape, scale=scale, seed=seed)

    q, k, v = (rn(B, H, N, DH, scale=DH ** -0.5, seed=1), rn(B, H, N, DH, seed=2),
               rn(B, H, N, DH, seed=3))
    q_l, k_l, w = (rn(B, H, M, DH, scale=DH ** -0.5, seed=4), rn(B, H, M, DH, seed=5),
                   rn(B, H, M, DH, seed=6))
    kern = rn(H, TAPS, scale=TAPS ** -0.5, seed=7)
    g3, g4 = rn(B, H, M, DH, seed=8), rn(B, H, N, DH, seed=9)
    k_pad = torch.cat([k.new_zeros(B, H, PAD, DH), k], 2)
    v_pad = torch.cat([v.new_zeros(B, H, PAD, DH), v], 2)
    bf16 = torch.bfloat16

    def kv(a, b, c):
        return na.softmax_matmul_landmark_kv(a, b, c, PAD)

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, scale=1.0)

    return {
        "3 kv": (partial(forward, kv, q_l, k, v),
                 lambda: na.softmax_attn_ref(q_l, k, v, PAD).to(bf16),
                 T.BOUND_SINGLE_ROUNDING, partial(forward, sdpa, q_l, k_pad, v_pad)),
        "3b q": (partial(forward, na.softmax_matmul_landmark_q, q, k_l, w),
                 lambda: na.softmax_attn_ref(q, k_l, w).to(bf16),
                 T.BOUND_SINGLE_ROUNDING, partial(forward, sdpa, q, k_l, w)),
        "4 conv": (partial(forward, na.fused_softmax_attn_conv, q, k_l, w, v, kern),
                   lambda: (na.softmax_attn_ref(q, k_l, w)
                            + na.depthwise_conv_seq_ref(v, kern)).to(bf16),
                   T.BOUND_SINGLE_ROUNDING, None),
        "3c kv bwd": (partial(backward, kv, (q_l, k, v), (g3,)),
                      lambda: na.softmax_attn_bwd_ref(q_l, k, v, g3, PAD),
                      T.BOUND_BWD, partial(backward, sdpa, (q_l, k_pad, v_pad), (g3,))),
        "4b conv bwd": (partial(backward, na.fused_softmax_attn_conv, (q, k_l, w, v, kern),
                                (g4,)),
                        lambda: (*na.softmax_attn_bwd_ref(q, k_l, w, g4),
                                 *depthwise_conv_seq_bwd_ref(v, kern, g4)),
                        T.BOUND_BWD, None),
    }


def in_build(lib):
    return contextlib.nullcontext() if lib is None else using(lib)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=20, help="calls per timed sample")
    p.add_argument("--reps", type=int, default=15, help="timed samples (median)")
    a = p.parse_args(argv)
    device = T.device_from_arg("cuda")
    builds = {"mma_sync": None, "wgmma": build()}  # None: the shipped library
    failed, result = [], []
    for name, (make, plain, bar, make_library) in rows(device).items():
        calls = {}
        for bname, lib in builds.items():
            with in_build(lib):
                calls[bname] = make()
        ref = plain()
        refs = ref if isinstance(ref, tuple) else (ref,)
        errs = {}
        for bname, call in calls.items():
            with in_build(builds[bname]):
                out = call()
            outs = out if isinstance(out, tuple) else (out,)
            errs[bname] = max(T.rel_err(o, r) for o, r in zip(outs, refs, strict=True))
        samples = {bname: [] for bname in builds}
        for bname in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
            with in_build(builds[bname]):
                samples[bname].append(T.median_ms(calls[bname], device, a.runs, a.reps))
        ms = {bname: sum(v) / len(v) for bname, v in samples.items()}
        lib_ms = (T.median_ms(make_library(), device, a.runs, a.reps)
                  if make_library is not None else None)
        ratio = ms["wgmma"] / ms["mma_sync"]
        result.append(dict(name=name, ms=ms, samples_ms=samples, rel_fro_err=errs, bar=bar,
                           library_ms=lib_ms, wgmma_over_mma_sync=ratio))
        lib_txt = f", SDPA {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"{name}: mma.sync {ms['mma_sync']:.4f} ms, wgmma {ms['wgmma']:.4f} ms "
              f"(x{ratio:.2f}){lib_txt}; rel Frobenius err mma.sync {errs['mma_sync']:.3g}, "
              f"wgmma {errs['wgmma']:.3g} (bar {bar:g})", flush=True)
        failed += [f"{name} {bname}" for bname, e in errs.items() if not e <= bar]
    T.emit("exp_attn_wgmma", device, dict(b=B, h=H, dh=DH, m=M, n=N, pad=PAD, taps=TAPS),
           result, failed=failed)
    if failed:
        print(f"beyond the bar: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
