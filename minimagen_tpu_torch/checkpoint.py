"""Checkpoint reading and writing (counterpart of the checkpoint IO of
``minimagen_tpu/training.py:299-356``).

The JAX package writes parameters with ``flax.serialization``: msgpack, with
each array as extension type 1 holding msgpack ``[shape, dtype name, raw
bytes]``. :func:`msgpack_restore` decodes that format in pure Python, into a
nested dict of numpy arrays; bfloat16 arrays come back as float32 (exact:
a bfloat16 is the top half of a float32). The same reader opens
``assets/t5_tiny/flax_model.msgpack``. :func:`msgpack_serialize` and
:func:`write_msgpack` are the encoder: the same format from nested dicts of
tensors and numpy arrays, bfloat16 kept as ``"bfloat16"``. Flax splits
arrays above 1 GiB into chunks; no array of the repo's cascades is that
large, and neither side here chunks.

:func:`unet_state_dict` carries a JAX U-Net parameter tree over to the
port's ``state_dict``: names joined with dots, ``kernel`` renamed ``weight``,
convolution kernels HWIO -> OIHW and dense kernels (in, out) -> (out, in);
:func:`flax_unet_tree` is its inverse (no JAX leaf is named ``weight``).

:func:`save_unet_checkpoint` writes one U-Net as the JAX package's
``save_unet_checkpoint`` does; :func:`save_train_state` and
:func:`load_train_state` write and restore a whole train state (the step,
the parameters, optax's chain or ``MultiSteps`` state and the EMA) in the
layout of ``flax.serialization.to_state_dict`` of the JAX ``TrainState``,
so either package restores the other's files.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Iterable, List, Mapping, Tuple, Union

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


# --------------------------------------------------------------------------- #
# writing                                                                      #
# --------------------------------------------------------------------------- #
def _header(small: int, codes: Tuple[int, int, int], n: int, fix_max: int) -> bytes:
    """A msgpack length header: the fix form `small | n` up to `fix_max`,
    else the 8/16/32-bit form of `codes` (None where a form does not exist)."""
    if n <= fix_max and small is not None:
        return bytes([small | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _array_payload(a: Union[np.ndarray, torch.Tensor]) -> Tuple[bytes, memoryview]:
    """flax's ndarray payload: msgpack ``[shape, dtype name, raw]`` as its
    header bytes and the raw little-endian buffer."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, arr = "bfloat16", t.view(torch.int16).numpy()
        else:
            arr = t.numpy()
            name = arr.dtype.name
    else:
        arr = np.asarray(a)
        arr = arr if arr.flags.c_contiguous else arr.copy()  # keeps 0-d arrays 0-d
        name = arr.dtype.name
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    parts: List[bytes] = []
    _pack([list(arr.shape), name], parts.append)
    head = b"\x93" + b"".join(parts)[1:]  # the 2-array header becomes a 3-array one
    raw = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size else memoryview(b"")
    return head + bytes(_header(None, (0xC4, 0xC5, 0xC6), raw.nbytes, -1)), raw


def _pack(obj: Any, write: Callable[[bytes], Any]) -> None:
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, (np.generic,)):
        if 0 <= obj <= 0x7F:
            write(bytes([obj]))
        elif -32 <= obj < 0:
            write(struct.pack(">b", obj))
        elif obj > 0:
            for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                     (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
                if obj <= limit:
                    write(bytes([code]) + struct.pack(fmt, obj))
                    break
        else:
            for code, fmt, limit in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                                     (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
                if -limit <= obj:
                    write(bytes([code]) + struct.pack(fmt, obj))
                    break
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        write(_header(0xA0, (0xD9, 0xDA, 0xDB), len(data), 31) + data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        write(_header(None, (0xC4, 0xC5, 0xC6), len(data), -1) + data)
    elif isinstance(obj, Mapping):  # keys sorted, as flax writes them
        write(_header(0x80, (None, 0xDE, 0xDF), len(obj), 15))
        for k, v in sorted(obj.items()):
            _pack(k, write)
            _pack(v, write)
    elif isinstance(obj, (list, tuple)):
        write(_header(0x90, (None, 0xDC, 0xDD), len(obj), 15))
        for v in obj:
            _pack(v, write)
    elif isinstance(obj, (np.ndarray, torch.Tensor, np.generic)):
        scalar = isinstance(obj, np.generic)
        head, raw = _array_payload(np.asarray(obj) if scalar else obj)
        n = len(head) + raw.nbytes
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        ext = (bytes([fixed[n]]) if n in fixed
               else _header(None, (0xC7, 0xC8, 0xC9), n, -1))
        write(ext + bytes([_EXT_SCALAR if scalar else _EXT_NDARRAY]) + head)
        write(raw)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def msgpack_serialize(obj: Any) -> bytes:
    """Encode nested dicts/lists of tensors, numpy arrays, numbers, strings
    and None as flax-serialized msgpack bytes."""
    parts: List[bytes] = []
    _pack(obj, parts.append)
    return b"".join(bytes(p) for p in parts)


def write_msgpack(path: str, obj: Any) -> None:
    """:func:`msgpack_serialize` straight into a file (no whole-file buffer)."""
    with open(path, "wb") as f:
        _pack(obj, f.write)


def _nest(flat: Iterable[Tuple[Tuple[str, ...], Any]]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def flax_unet_tree(state: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """The port's U-Net ``state_dict`` (or a module's) -> a JAX parameter
    tree of CPU tensors: ``weight`` -> ``kernel``, OIHW -> HWIO, (out, in)
    -> (in, out); dtypes kept. The inverse of :func:`unet_state_dict`."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    flat = []
    for name, t in state.items():
        path = tuple(name.split("."))
        t = t.detach().cpu()
        if path[-1] == "weight":
            path = path[:-1] + ("kernel",)
            t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
        flat.append((path, t.contiguous()))
    return _nest(flat)


def save_unet_checkpoint(path: str, state: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> None:
    """Write one U-Net's parameters (a module, or its ``state_dict`` names
    -> tensors) as the JAX package's ``save_unet_checkpoint`` does."""
    write_msgpack(path, flax_unet_tree(state))


def _unet_trees(names: List[Tuple[int, str]], tensors: List[torch.Tensor]) -> Dict[str, Any]:
    """{'unet_i': tree} of flat per-parameter `tensors` named by `names`
    ((stage, state_dict name) in the same order)."""
    per: Dict[int, Dict[str, torch.Tensor]] = {}
    for (i, name), t in zip(names, tensors):
        per.setdefault(i, {})[name] = t
    return {f"unet_{i}": flax_unet_tree(sd) for i, sd in sorted(per.items())}


def _int32(v: int) -> np.ndarray:
    return np.asarray(v, np.int32)


def train_state_dict(state) -> Dict[str, Any]:
    """A port ``TrainState`` as ``flax.serialization.to_state_dict`` of the
    JAX ``TrainState`` (``minimagen_tpu/parallel/mesh.py:249``) lays it out:
    step, params, opt_state (the chain's ``(clip, (adam, lr))`` states, or
    ``MultiStepsState`` around them) and ema_params."""
    names, opt = state.names, state.opt_state
    adam = {"0": {}, "1": {"0": {"count": _int32(opt.count), "mu": _unet_trees(names, opt.mu),
                                 "nu": _unet_trees(names, opt.nu)}, "1": {}}}
    if opt.acc_grads is not None:
        adam = {"mini_step": _int32(opt.mini_step), "gradient_step": _int32(opt.gradient_step),
                "inner_opt_state": adam, "acc_grads": _unet_trees(names, opt.acc_grads),
                "skip_state": {}}
    ema = None if state.ema_params is None else _unet_trees(names, state.ema_params)
    return {"step": _int32(state.step), "params": _unet_trees(names, state.params),
            "opt_state": adam, "ema_params": ema}


def save_train_state(path: str, state) -> None:
    """Write the full train state (parameters, Adam's moments, the step and
    the EMA) as the JAX package's ``save_train_state`` does."""
    write_msgpack(path, train_state_dict(state))


def _restore_trees(trees: Any, state, dst: List[torch.Tensor], what: str) -> None:
    """Each whole tensor of `trees` into `dst`, or on a mesh into this
    process's block where `dst` holds one."""
    if not isinstance(trees, dict):
        raise ValueError(f"{what}: the file holds no parameter trees")
    per = {k: unet_state_dict(v) for k, v in trees.items()}
    want = {f"unet_{i}" for i, _ in state.names}
    if set(per) != want:
        raise ValueError(f"{what}: the file holds {sorted(per)}, the state {sorted(want)}")
    for idx, ((i, name), shape, t) in enumerate(zip(state.names, state.shapes, dst)):
        src = per[f"unet_{i}"].pop(name, None)
        if src is None or tuple(src.shape) != tuple(shape):
            raise ValueError(f"{what}: unet_{i}.{name} is missing or has another shape")
        if tuple(t.shape) != tuple(src.shape):
            src = state.plan.part(idx, src, state.mesh, t.shape)
        with torch.no_grad():
            t.copy_(src)
    extra = [f"{k}.{n}" for k, sd in per.items() for n in sd]
    if extra:
        raise ValueError(f"{what}: the file holds parameters the state lacks: {extra[:5]}")


def load_train_state(path: str, state):
    """Restore a full train state written by either package into `state`
    (its structure, dtypes and devices kept; values copied in place; on a
    mesh each process keeps its blocks); returns `state`."""
    tree = read_msgpack(path)
    if set(tree) != {"step", "params", "opt_state", "ema_params"}:
        raise ValueError(f"{path} is not a train state: keys {sorted(tree)}")
    opt = state.opt_state
    saved = tree["opt_state"]
    if ("inner_opt_state" in saved) != (opt.acc_grads is not None):
        raise ValueError(f"{path}: gradient accumulation differs between the file and the state")
    if opt.acc_grads is not None:
        opt.mini_step, opt.gradient_step = int(saved["mini_step"]), int(saved["gradient_step"])
        _restore_trees(saved["acc_grads"], state, opt.acc_grads, "acc_grads")
        saved = saved["inner_opt_state"]
    adam = saved["1"]["0"]
    opt.count = int(adam["count"])
    _restore_trees(adam["mu"], state, opt.mu, "mu")
    _restore_trees(adam["nu"], state, opt.nu, "nu")
    _restore_trees(tree["params"], state, state.param_targets(), "params")
    if (tree["ema_params"] is None) != (state.ema_params is None):
        raise ValueError(f"{path}: the EMA is in one of the file and the state only")
    if state.ema_params is not None:
        _restore_trees(tree["ema_params"], state, state.ema_params, "ema_params")
    state.step = int(tree["step"])
    return state
