"""ctypes loader of the framework-free preprocessing library (counterpart
of ``minimagen_tpu/data/native.py``).

``native/preprocess.cpp`` (antialiased Catmull-Rom resize with min-max
renormalisation, threaded over a batch; a plain C interface) is compiled
with ``g++`` at first use into the gitignored ``build/minimagen_tpu_torch/``
(never into ``native/``). Where no compiler or source is at hand,
:func:`available` is False and callers take their numpy path, as the JAX
loader's do; this is host data preparation, not a device kernel.
``MINIMAGEN_TPU_DISABLE_NATIVE`` set to anything turns the library off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "preprocess.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "minimagen_tpu_torch")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """The built library, named by the source's hash (a changed source
    builds anew)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libminimagen_native_{digest}.so")


def _build() -> Optional[str]:
    """Compile the library if it is not built yet; None on failure."""
    try:
        path = library_path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", SOURCE,
                        "-shared", "-lpthread", "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
        return path
    except (OSError, subprocess.SubprocessError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MINIMAGEN_TPU_DISABLE_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i32, f32p, u8p = ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
        lib.mm_preprocess_batch.restype = ctypes.c_int
        lib.mm_preprocess_batch.argtypes = [
            u8p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(i32), ctypes.POINTER(i32),
            i32, i32, i32, i32, f32p, i32]
        lib.mm_resize_image.restype = ctypes.c_int
        lib.mm_resize_image.argtypes = [u8p, i32, i32, i32, f32p, i32, i32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def resize_image_u8(img: np.ndarray, side: int, renorm: bool = True) -> Optional[np.ndarray]:
    """One (h, w, c) uint8 image -> (side, side, c) float32 in [0, 1]
    (min-max renormalised when `renorm`); None without the library."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    out = np.empty((side, side, c), np.float32)
    rc = lib.mm_resize_image(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), side,
                             1 if renorm else 0)
    return out if rc == 0 else None


def resize_batch_u8(images: List[np.ndarray], side: int, renorm: bool = True,
                    n_threads: int = 0) -> Optional[np.ndarray]:
    """(h_i, w_i, c) uint8 images -> one (n, side, side, c) float32 batch,
    threaded over images in C++; None without the library."""
    lib = _load()
    if lib is None or not images:
        return None
    c = images[0].shape[2]
    flat = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    sizes = np.array([im.size for im in flat], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    heights = np.array([im.shape[0] for im in flat], np.int32)
    widths = np.array([im.shape[1] for im in flat], np.int32)
    buf = np.concatenate([im.reshape(-1) for im in flat])
    out = np.empty((len(flat), side, side, c), np.float32)
    rc = lib.mm_preprocess_batch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(flat), c, side, 1 if renorm else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return out if rc == 0 else None
