"""Shared plumbing for the hand-written Hopper kernels.

Counterpart of ``mirror_tpu/ops/_common.py``. It holds three things:

- the build and load of the kernel library: each ``csrc/*.cu`` is compiled
  by its own ``nvcc`` for ``sm_90a`` (all started together), the objects are
  linked into one ``build/kernels/libmirror_kernels.so`` at first use, and
  the library is loaded with ``ctypes`` (plain C entry points, no PyTorch
  headers, so the build takes seconds);
- the device check every wrapper goes through: a CUDA tensor goes to the
  kernel, a CPU tensor goes to the plain PyTorch version. There is no other
  switch and no fallback: a kernel that fails to build or launch raises.
  The training ops launch their kernels only from their
  ``torch.autograd.Function``, forward and backward, so no output of a
  kernel is ever cut off from autograd. The ViT entries (``vit_attn``) are
  inference-only plain functions, like their TPU kernels, which have no
  VJP: they refuse a call that autograd would record;
- a launch counter per kernel, so a run can show which kernels its main
  path went through.

The TPU package's shard_map plumbing has no counterpart: every kernel here
works on the tensors of one device.
"""

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmirror_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
# what ptxas -v reported for each source at the last build (registers,
# shared memory, spills of each kernel), by file name
PTXAS_INFO: Dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every entry point in csrc/ (all return cudaError_t as int)
_SIGNATURES = {
    # q, k, q_l, k_l, attn2, lse (fp32), bh, n, dh, m, l, pad, stream
    "mirror_landmark_softmax": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q_l, k_l, lse (fp32), gql, gkl, ga2, dq, dk, dvec (fp32 scratch), bh, n,
    # dh, m, l, pad, stream
    "mirror_landmark_softmax_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P),
    # x, s, z, bh, m, stream
    "mirror_pinv_init": (_P, _P, _P, _I, _I, _P),
    # a, b, c, c2, prev, acc (fp32), bh, M, N, K, layout, epilogue, c0, c1,
    # d0, d1, stream
    "mirror_pinv_gemm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _P),
    # in, out, bh, m, c0, c1, stream
    "mirror_pinv_eye_axpby": (_P, _P, _I, _I, _F, _F, _P),
    # gx32, gz, z0, s, gx, gs_partial (fp32 [bh]), bh, m, stream
    "mirror_pinv_bwd_finish": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # q, k, w, v, kern, out, lse (fp32, or null), o_attn (or null), bh,
    # heads, r, c, dh, pad, ksize, stream
    "mirror_softmax_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, w, v, kern, g, lse (fp32), o, dq, dk, dw, dv, dkern (fp32), dvec
    # (fp32 scratch), partial (scratch), bh, heads, r, c, dh, ksize, stream
    "mirror_softmax_attn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _P),
    # img, kern, bias, out, b, H, W, C, stream
    "mirror_ppeg": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # img, kern, g, dimg, dkb (fp32 [50, C]: 49 taps then the bias),
    # partial (scratch), b, H, W, C, stream
    "mirror_ppeg_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, ln_s, ln_b (fp32), y, rows, d, eps, stream
    "mirror_vit_ln": (_P, _P, _P, _P, _I, _I, _F, _P),
    # a, b, bias (fp32), resid (residual epilogue only), c, M, N, K,
    # epilogue, stream
    "mirror_vit_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, out, b, n, heads, dh, ld_in, ld_out, group, scale, stream
    "mirror_vit_attn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # v, kern, out, bh, heads, n, d, ksize, stream
    "mirror_conv1d": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # v, kern, g, dv, dkern (fp32), partial (scratch), bh, heads, n, d, ksize,
    # stream
    "mirror_conv1d_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # kern, g, dv, bh, heads, n, d, ksize, stream (the backward's dv alone)
    "mirror_conv1d_bwd_dv": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # parts (fp32), nparts, count, out (fp32), stream
    "mirror_column_sum": (_P, _I, _L, _P, _P),
    # src, dst, b, h, n, d, gb, tile, stream
    "mirror_copy_floor": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, ln_s, ln_b, w, q, k, v, stats (fp32 [2, b n]), b, n, d, heads, dh,
    # eps, stream
    "mirror_ln_qkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # x, ln_s, ln_b, w, gq, gk, gv, gx, gw, gsb (fp32 [2, d]), scratch, b, n,
    # d, heads, dh, eps, stream
    "mirror_ln_qkv_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                          _P),
    # x, ln_s, ln_b (null: k5), wqkv, bqkv, wo, bo, out, b, n, heads, dh,
    # group, scale, eps, stream
    "mirror_vit_fused_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    # x, ln_s, ln_b (null: k7), w1, b1, w2, b2, out, rows, rows_per_block, d,
    # m, eps, stream
    "mirror_vit_fused_mlp": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
}
# Scratch sizes, in elements, as the kernels' own tilings need them (so the
# tile sizes are known only in csrc/), and what else only csrc/ knows; each
# returns a 64-bit count
_SCRATCH_SIZES = {
    # b, H, C
    "mirror_ppeg_bwd_partial_elems": (_I, _I, _I),
    # bh, n, ksize (the standalone conv's backward, and kernel 4b's conv)
    "mirror_conv1d_bwd_partial_elems": (_I, _I, _I),
    # b, n, d, heads, dh
    "mirror_ln_qkv_bwd_scratch_elems": (_I, _I, _I, _I, _I),
    # n, dh, heads: bytes of shared memory a CTA of the fused attention takes
    "mirror_vit_fused_attn_smem": (_I, _I, _I),
    # n, dh, heads: the heads a CTA of that kernel takes
    "mirror_vit_fused_attn_heads_per_cta": (_I, _I, _I),
    # n, dh, heads: clusters of that kernel the card holds at once
    "mirror_vit_fused_attn_clusters": (_I, _I, _I),
    # clusters of the fused MLP the card holds at once
    "mirror_vit_fused_mlp_clusters": (),
}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = collections.Counter()


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is "
                           "needed to build the kernel library")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds) -> list:
    """Run the commands at once, raise if any failed, else return each
    one's standard error."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed, errs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return errs


def build_library(force: bool = False) -> Path:
    """Compile csrc/*.cu into build/kernels/libmirror_kernels.so: one nvcc
    per source, all at once, then one link.

    Rebuilds when the sources or flags changed since the last build (a
    digest is kept beside the library), or when ``force``."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _source_digest()
    if not force and lib.exists() and stamp.exists() \
            and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    errs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
                     for src, obj in zip(sources, objects)])
    PTXAS_INFO.update((src.name, err) for src, err in zip(sources, errs))
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
    for obj in objects:
        obj.unlink()
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            for name, argtypes in _SCRATCH_SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int64
            _LIB = lib
        return _LIB


def launch(entry: str, *args) -> None:
    """Call C entry ``entry`` on the current stream; raise if the launch
    reports a CUDA error (a refused launch never runs, and a later
    synchronize would not say so)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def scratch_elems(entry: str, *args: int) -> int:
    """Elements of the scratch buffer that a kernel's tiling needs, or
    another count that only csrc/ knows, from the library's own ``entry``
    (one of ``_SCRATCH_SIZES``)."""
    return getattr(library(), entry)(*args)


def count_launch(kernel: str) -> None:
    """Called by a Function once per call that launched its kernel(s)."""
    _LAUNCHES[kernel] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def on_cuda(*tensors: torch.Tensor) -> bool:
    """The device check: True sends the call to the kernel, False to the
    plain version. Mixed devices are an error."""
    devices = {t.device.type for t in tensors}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed devices: {sorted(devices)}")


def check_kernel_input(name: str, t: torch.Tensor, shape, dtype=torch.bfloat16) -> None:
    """Raise unless ``t`` is what the CUDA kernels take: the given shape,
    dtype, contiguous, 16-byte aligned (the kernels load 16 bytes a
    thread)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def grad_or_zeros(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """An incoming gradient in ``like``'s dtype, contiguous; zeros for an
    output that nothing downstream used (autograd passes None)."""
    if g is None:
        return torch.zeros_like(like)
    return g.to(like.dtype).contiguous()
