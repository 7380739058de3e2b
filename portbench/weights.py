"""The weights that both sides load: seeded on the card, or read from a
flax-msgpack checkpoint by the benchmark's own reader.

Names and shapes are those of the reference U-Net (``reference/unet.py``),
which are the program's too. :class:`SeededWeights` draws every random leaf
from a few large ``torch.randn`` calls on the card, one per chunk of about a
gigabyte, each from a ``torch.Generator`` seeded from the run's seed and the
chunk, so any chunk can be drawn again alike after the program is gone.
Kernels are normal with variance 1/fan_in, the learned null embeddings
normal(1), norm scales one and biases zero. :class:`CheckpointWeights` reads
the committed bf16 checkpoints.
"""
from __future__ import annotations

import hashlib
import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .reference import unet as ref

CHUNK_ELEMENTS = 1 << 28
ONES = ("gamma", "g", "scale")
NULLS = ("null_kv", "null_text_embed", "null_text_hidden")


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for `tags` of the run seeded by `seed`."""
    digest = hashlib.sha256(":".join(map(str, (int(seed), *tags))).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaf_specs(unet_cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the U-Net, in module order."""
    with torch.device("meta"):
        net = ref.Unet(unet_cfg)
    return [(n, tuple(p.shape)) for n, p in net.named_parameters()]


def _std(name: str, shape: Tuple[int, ...]) -> float:
    """0 for a constant leaf, else the normal's standard deviation."""
    last = name.rsplit(".", 1)[-1]
    if last in NULLS:
        return 1.0
    if last == "weight" and len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        return fan_in ** -0.5
    return 0.0


class SeededWeights:
    """Random weights of a cascade, drawn on `device` from `seed`."""

    def __init__(self, unet_cfgs, seed: int, device):
        self.seed, self.device = seed, torch.device(device)
        self.specs = [leaf_specs(c) for c in unet_cfgs]
        self.chunks = []  # per U-Net: lists of leaf indices, each list one draw
        for specs in self.specs:
            chunks, cur, n = [], [], 0
            for i, (name, shape) in enumerate(specs):
                if _std(name, shape) == 0.0:
                    continue
                size = int(np.prod(shape))
                if cur and n + size > CHUNK_ELEMENTS:
                    chunks.append(cur)
                    cur, n = [], 0
                cur.append(i)
                n += size
            if cur:
                chunks.append(cur)
            self.chunks.append(chunks)

    def _chunk(self, u: int, c: int) -> Dict[str, torch.Tensor]:
        specs = self.specs[u]
        idx = self.chunks[u][c]
        sizes = [int(np.prod(specs[i][1])) for i in idx]
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "w", u, c))
        flat = torch.randn(sum(sizes), generator=gen, device=self.device)
        out = {}
        for i, part in zip(idx, flat.split(sizes)):
            name, shape = specs[i]
            out[name] = part.view(shape).mul_(_std(name, shape))
        return out

    def state_dict(self, u: int) -> Dict[str, torch.Tensor]:
        """Every leaf of U-Net `u`, float32 on the card."""
        sd = {}
        for c in range(len(self.chunks[u])):
            sd.update(self._chunk(u, c))
        for name, shape in self.specs[u]:
            if name not in sd:
                fill = 1.0 if name.rsplit(".", 1)[-1] in ONES else 0.0
                sd[name] = torch.full(shape, fill, device=self.device)
        return {name: sd[name] for name, _ in self.specs[u]}

    def blocks(self, u: int) -> Iterator[Dict[str, torch.Tensor]]:
        """The leaves of U-Net `u` a chunk at a time (constant leaves last)."""
        for c in range(len(self.chunks[u])):
            yield self._chunk(u, c)
        consts = {}
        for name, shape in self.specs[u]:
            if _std(name, shape) == 0.0:
                fill = 1.0 if name.rsplit(".", 1)[-1] in ONES else 0.0
                consts[name] = torch.full(shape, fill, device=self.device)
        yield consts


# --------------------------------------------------------------------------- #
# flax msgpack (the committed checkpoints)                                     #
# --------------------------------------------------------------------------- #
def _array(payload: bytes) -> np.ndarray:
    shape, dtype, raw = msgpack_loads(payload)
    if dtype == "bfloat16":
        return (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()


def msgpack_loads(data: bytes):
    """Decode msgpack with flax's array extension (type 1)."""
    view, pos = memoryview(data), 0

    def take(n):
        nonlocal pos
        out = view[pos:pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        pos += n
        return bytes(out)

    def num(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def ext(n):
        code = num(">b")
        payload = take(n)
        if code not in (1, 3):
            raise ValueError(f"msgpack extension {code} is not an array")
        return _array(payload)

    def value():
        b = num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return {value(): value() for _ in range(b & 0x0F)}
        if b <= 0x9F:
            return [value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return take(b & 0x1F).decode()
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in (0xC4, 0xC5, 0xC6):
            return take(num({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):
            return ext(num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return num(fixed[b])
        if 0xD4 <= b <= 0xD8:
            return ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return take(num({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])).decode()
        if b in (0xDC, 0xDD):
            return [value() for _ in range(num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return {value(): value() for _ in range(num(">H" if b == 0xDE else ">I"))}
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    out = value()
    if pos != len(view):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def flax_to_torch(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """A flax U-Net tree -> (torch name, array): ``kernel`` becomes
    ``weight``, conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in)."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(flax_to_torch(v, path))
            continue
        a = np.asarray(v, np.float32)
        if k == "kernel":
            path = prefix + ("weight",)
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[".".join(path)] = np.ascontiguousarray(a)
    return out


class CheckpointWeights:
    """The U-Nets of a checkpoint directory (``unet_<i>_ema_bf16.ckpt``)."""

    def __init__(self, directory: str, unet_cfgs, device):
        self.device = torch.device(device)
        self.paths = [os.path.join(directory, f"unet_{i}_ema_bf16.ckpt")
                      for i in range(len(unet_cfgs))]
        self.specs = [leaf_specs(c) for c in unet_cfgs]

    def state_dict(self, u: int) -> Dict[str, torch.Tensor]:
        with open(self.paths[u], "rb") as f:
            arrays = flax_to_torch(msgpack_loads(f.read()))
        want = dict(self.specs[u])
        if set(arrays) != set(want):
            raise ValueError(f"{self.paths[u]}: leaves differ from the configuration's "
                             f"({sorted(set(arrays) ^ set(want))[:4]} ...)")
        return {name: torch.as_tensor(arrays[name], device=self.device)
                for name, _ in self.specs[u]}

    def blocks(self, u: int) -> Iterator[Dict[str, torch.Tensor]]:
        yield self.state_dict(u)


def weights_for(config: Dict, unet_cfgs, seed: int, device, root: str):
    """The configuration's weights: seeded, or read from its checkpoint."""
    kind = config["weights"]["kind"]
    if kind == "seeded":
        return SeededWeights(unet_cfgs, seed, device)
    if kind == "checkpoint":
        return CheckpointWeights(os.path.join(root, config["weights"]["directory"]),
                                 unet_cfgs, device)
    raise ValueError(f"unknown weights kind {kind!r}")
