"""The JAX package's flax msgpack checkpoints, read with numpy and the
standard library.

``mirror_tpu/train/checkpoint.py::save_checkpoint_file`` writes its payload
with ``flax.serialization.msgpack_serialize``; the card's machine has no
``msgpack``, ``flax`` or ``ml_dtypes``, so :func:`msgpack_restore` decodes
the subset of msgpack that flax writes, as ``flax.serialization.
msgpack_restore`` returns it:

- maps (dicts, str keys), arrays (lists), str, bin, ints, floats, bool, nil;
- ext type 1, an ndarray as the msgpack triple (shape, dtype name, C-order
  bytes); 2, a complex as (real, imag); 3, a numpy scalar (an ndarray of
  shape ()). ``bfloat16``, which numpy lacks, is read as its 16-bit pattern
  and returned as a ``torch.bfloat16`` tensor;
- arrays above ``MAX_CHUNK_SIZE`` bytes, which flax splits into
  ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` maps
  of flat chunks, joined again.

Any other type byte or ext code raises, naming it. :func:`payload_from_jax`
turns the restored payload into the port's (``train/checkpoint.py``).
"""

import logging
import struct
from typing import Any, Dict

import numpy as np
import torch

from ..convert import state_dict_from_jax

_logger = logging.getLogger(__name__)

MAX_CHUNK_SIZE = 2**30  # flax.serialization's: larger arrays are written in chunks
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """One msgpack value at a time from ``data``; str as ``str``, or as
    ``bytes`` with ``raw`` (flax reads an ndarray's triple raw)."""

    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends at byte {len(self.buf)}, inside a value")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:  # bin 8 / 16 / 32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if 0xC7 <= b <= 0xC9:  # ext 8 / 16 / 32
            return self.ext(self.uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8 / 16 / 32 / 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8 / 16 / 32 / 64
            return int.from_bytes(self.take(1 << (b - 0xD0)), "big", signed=True)
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8 / 16 / 32
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16 / 32
            return [self.value() for _ in range(self.uint(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self.map(self.uint(2 << (b - 0xDE)))
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1}: not one flax writes")

    def str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = int.from_bytes(self.take(1), "big", signed=True)
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code}: not one flax writes (1, 2 or 3)")


def _ndarray(data) -> Any:
    """flax's ``_ndarray_from_bytes``: a read-only C-order array over the
    triple's bytes; bfloat16 as a ``torch.bfloat16`` tensor of its bits."""
    shape, name, buf = _Reader(data, raw=True).value()
    if name == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name.decode())
    except TypeError as e:
        raise ValueError(f"array dtype {name.decode()!r}: numpy has no such type") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _unchunk(node: Dict) -> Any:
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if torch.is_tensor(chunks[0]):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(node: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps under maps."""
    if isinstance(node, dict):
        if _CHUNKED in node:
            return _unchunk(node)
        for key, value in node.items():
            if isinstance(value, dict):
                node[key] = _unchunk_leaves(value)
    return node


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore`` of ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack data has {len(reader.buf) - reader.pos} bytes after its "
                         "value")
    return _unchunk_leaves(out)


def is_msgpack_file(path: str) -> bool:
    """Whether ``path`` starts as a flax checkpoint does: a msgpack map
    (fixmap 0x81-0x8f, map 16 or map 32). A torch file starts with a zip's
    ``PK`` or a pickle's 0x80."""
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def _float_leaves(tree: Any) -> Any:
    """bfloat16 leaves as float32 numpy (exact), the rest as numpy."""
    if isinstance(tree, dict):
        return {k: _float_leaves(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.float().numpy()
    return np.asarray(tree)


def _port_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX param tree as the port's flat state_dict of tensors (copies:
    the arrays read from the file are read-only views of its bytes)."""
    return {k: torch.tensor(v) for k, v in state_dict_from_jax(_float_leaves(params)).items()}


def payload_from_jax(payload: Dict[str, Any], path: str = "") -> Dict[str, Any]:
    """The JAX package's payload (``CheckpointSaver._payload``) as the
    port's: ``state_dict`` and ``ema_state_dict`` (as ``state_dict_ema``,
    where not empty) become the port's flat keys through
    ``convert.state_dict_from_jax``, as tensors; ``epoch``, ``arch``,
    ``metric``, ``args`` and ``version`` are carried. The optax
    ``opt_state`` has no counterpart in the port's optimizer layout and is
    dropped, saying so; ``--resume`` refuses such a file."""
    out = {
        "epoch": int(payload.get("epoch", 0)),
        "arch": payload.get("arch", ""),
        "state_dict": _port_state_dict(payload["state_dict"]),
        "metric": payload.get("metric"),
        "args": payload.get("args", ""),
        "version": payload.get("version", 2),
    }
    if payload.get("ema_state_dict"):
        out["state_dict_ema"] = _port_state_dict(payload["ema_state_dict"])
    if payload.get("opt_state") is not None:
        _logger.info("%s: the JAX optimizer state (opt_state) is dropped; the port reads the "
                     "weights%s", path or "checkpoint",
                     " and the EMA weights" if "state_dict_ema" in out else "")
    return out


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """:func:`payload_from_jax` of the msgpack file at ``path``."""
    with open(path, "rb") as f:
        return payload_from_jax(msgpack_restore(f.read()), path)
