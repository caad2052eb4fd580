"""ctypes binding of the C++ batch gather, ``native/mirror_loader.cpp``.

The port's own copy of ``mirror_tpu/data/native_loader.py`` over the same
unchanged source and C signatures: ``mirror_npy_shape`` reads a ``.npy``
header, ``mirror_gather_batch`` assembles a [B, T, D] float32 batch from
per-slide ``.npy`` files, each slide's rows drawn (with replacement iff it
has fewer than T) by a worker thread from its own seed, the JAX loader's
draws. The library is built with ``g++`` at first use into
``build/native/libmirror_loader.so`` (a per-process temporary file renamed
into place, so parallel builds do not collide) and rebuilt when the source
is newer. A build or load failure raises: the numpy path draws other
tokens from the same seeds, so falling back silently would change a run.
"""

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "mirror_loader.cpp"
LIBRARY = REPO / "build" / "native" / "libmirror_loader.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(SOURCE),
           "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native loader failed ({' '.join(cmd)}): "
                           f"{getattr(e, 'stderr', None) or e}") from e
    tmp.replace(LIBRARY)


def library() -> ctypes.CDLL:
    """The loaded library, built first where it is missing or older than
    its source. Raises RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
            _build()
        try:
            lib = ctypes.CDLL(str(LIBRARY))
        except OSError as e:
            raise RuntimeError(f"loading the native loader {LIBRARY} failed: {e}") from e
        lib.mirror_npy_shape.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                         ctypes.POINTER(ctypes.c_int64)]
        lib.mirror_npy_shape.restype = ctypes.c_int
        lib.mirror_gather_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.mirror_gather_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def npy_shape(path: str) -> Tuple[int, int]:
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = library().mirror_npy_shape(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise ValueError(f"mirror_npy_shape({path}) failed: {rc}")
    return rows.value, cols.value


def _gather(lib, paths: Sequence[str], n_tokens: int, feature_dim: int,
            seeds: Sequence[int], out: np.ndarray, num_threads: int) -> int:
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    c_seeds = (ctypes.c_uint64 * len(paths))(*[int(s) & (2**64 - 1) for s in seeds])
    return lib.mirror_gather_batch(c_paths, len(paths), n_tokens, feature_dim, c_seeds,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   num_threads)


def gather_batch(paths: Sequence[str], n_tokens: int, seeds: Sequence[int],
                 num_threads: int = 8) -> np.ndarray:
    """[len(paths), n_tokens, D] float32 from float32 C-order ``.npy``
    files, one seed a slide. Raises ValueError on content the gather
    rejects (another dtype, Fortran order), naming the first failing file."""
    lib = library()
    if len(seeds) != len(paths):
        raise ValueError(f"{len(seeds)} seeds for {len(paths)} paths")
    _, feature_dim = npy_shape(paths[0])
    out = np.empty((len(paths), n_tokens, feature_dim), np.float32)
    rc = _gather(lib, paths, n_tokens, feature_dim, seeds, out, num_threads)
    if rc != 0:
        culprit = ""
        for p, s in zip(paths, seeds):
            one = np.empty((1, n_tokens, feature_dim), np.float32)
            rc1 = _gather(lib, [p], n_tokens, feature_dim, [s], one, 1)
            if rc1 != 0:
                culprit = f" (first failing file: {p}, code {rc1})"
                break
        raise ValueError(f"mirror_gather_batch failed with code {rc}{culprit}")
    return out
