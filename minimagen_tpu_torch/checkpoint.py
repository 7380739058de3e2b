"""Checkpoint reading (counterpart of ``minimagen_tpu/training.py::load_unet_checkpoint``).

The JAX package writes parameters with ``flax.serialization``: msgpack, with
each array as extension type 1 holding msgpack ``[shape, dtype name, raw
bytes]``. :func:`msgpack_restore` decodes that format in pure Python, into a
nested dict of numpy arrays; bfloat16 arrays come back as float32 (exact:
a bfloat16 is the top half of a float32). The same reader opens
``assets/t5_tiny/flax_model.msgpack``.

:func:`unet_state_dict` carries a JAX U-Net parameter tree over to the
port's ``state_dict``: names joined with dots, ``kernel`` renamed ``weight``,
convolution kernels HWIO -> OIHW and dense kernels (in, out) -> (out, in).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_SCALAR = 3


def _array(payload: bytes) -> np.ndarray:
    shape, dtype, raw = msgpack_restore(payload)
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(out)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _array(payload)
        if code == _EXT_SCALAR:
            return _array(payload)[()]
        if code == _EXT_COMPLEX:
            re, im = msgpack_restore(payload)
            return complex(re, im)
        raise ValueError(f"unknown msgpack extension type {code}")

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.take(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])).decode("utf-8")
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def msgpack_restore(data: bytes) -> Any:
    """Decode flax-serialized msgpack bytes into nested dicts of numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def read_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def unet_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX U-Net parameter tree -> the port's ``UnetModel`` state_dict."""
    sd = {}
    for path, leaf in _flatten(tree):
        arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if path[-1] == "kernel":
            path = path[:-1] + ("weight",)
            if arr.ndim == 4:  # HWIO -> OIHW
                arr = arr.permute(3, 2, 0, 1)
            elif arr.ndim == 2:  # (in, out) -> (out, in)
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
        sd[".".join(path)] = arr.contiguous()
    return sd


def load_unet_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Load a flax-serialized U-Net checkpoint into `model`; every key of the
    file and of the model must match (``strict``)."""
    model.load_state_dict(unet_state_dict(read_msgpack(path)), strict=True)
