"""Shared plumbing for the hand-written Hopper kernels.

Counterpart of ``mirror_tpu/ops/_common.py``. It holds three things:

- the build and load of the kernel library: every ``csrc/*.cu`` is compiled
  by ``nvcc`` for ``sm_90a`` into one ``build/kernels/libmirror_kernels.so``
  at first use and loaded with ``ctypes`` (plain C entry points, no PyTorch
  headers, so the build takes seconds);
- the device check every wrapper goes through: a CUDA tensor goes to the
  kernel, a CPU tensor goes to the plain PyTorch version. There is no other
  switch and no fallback: a kernel that fails to build or launch raises;
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
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point in csrc/ (all return cudaError_t as int)
_SIGNATURES = {
    # q, k, q_l, k_l, attn2, bh, n, dh, m, l, pad, stream
    "mirror_landmark_softmax": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, s, z, bh, m, stream
    "mirror_pinv_init": (_P, _P, _P, _I, _I, _P),
    # a, b, c, c2, bh, M, N, K, c0, c1, d0, d1, stream
    "mirror_pinv_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P),
    # q, k, w, v, kern, out, bh, heads, r, c, dh, pad, ksize, stream
    "mirror_softmax_attn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # img, kern, bias, out, b, H, W, C, stream
    "mirror_ppeg": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
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


def build_library(force: bool = False) -> Path:
    """Compile csrc/*.cu into build/kernels/libmirror_kernels.so.

    Rebuilds when the sources or flags changed since the last build (a
    digest is kept beside the library), or when ``force``."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _source_digest()
    if not force and lib.exists() and stamp.exists() \
            and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    sources = [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
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


def count_launch(kernel: str) -> None:
    """Called by a wrapper once per call that launched its kernel(s)."""
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
    dtype, contiguous, 16-byte aligned (the kernels load 16 bytes a thread),
    and no gradient asked for (the backward kernels are not ported yet, and
    a kernel's output carries no autograd history)."""
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name}: the CUDA kernels are forward only; run under torch.no_grad()"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
