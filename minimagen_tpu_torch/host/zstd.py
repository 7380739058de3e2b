"""ctypes loader of the host zstd decoder ``zstd_decode.c``.

The C source (RFC 8878, libc only, every frame's XXH64 content checksum
verified) is compiled with the host's C compiler (``$CC``, else ``cc``) at
first use into the gitignored ``build/minimagen_tpu_torch/`` at the root of
the checkout, named by a hash of the source and flags, and loaded with
``ctypes``. A failed build raises :class:`ZstdBuildError`: there is no
quiet fall-back to the pure-Python decoder, which is far slower
(``orbax_format.zstd_decompress(..., plain=True)`` is that decoder, the
plain version the tests hold this one against).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "zstd_decode.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "minimagen_tpu_torch")
CFLAGS = ("-O3", "-std=c11", "-fPIC", "-shared", "-Wall", "-Wextra")
E_DST_SMALL = -6  # zstd_decode.c: the content does not fit the output buffer

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class ZstdError(ValueError):
    """Input that is no valid zstd data, or uses what the decoders refuse."""


class ZstdBuildError(RuntimeError):
    """The host decoder did not compile or load."""


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CFLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libmmt_zstd_{digest}.so")


def library() -> ctypes.CDLL:
    """The loaded decoder, compiled first if this source was not built yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [os.environ.get("CC", "cc"), *CFLAGS, SOURCE, "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", None) or str(e)
                raise ZstdBuildError(f"building the host zstd decoder failed ({' '.join(cmd)}):"
                                     f"\n{detail}") from e
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise ZstdBuildError(f"loading {path} failed: {e}") from e
        i64, u64, size, p = ctypes.c_int64, ctypes.c_uint64, ctypes.c_size_t, ctypes.c_void_p
        lib.mmt_zstd_decompress.restype = i64
        lib.mmt_zstd_decompress.argtypes = [ctypes.c_char_p, size, p, size]
        lib.mmt_zstd_content_size.restype = i64
        lib.mmt_zstd_content_size.argtypes = [ctypes.c_char_p, size]
        lib.mmt_zstd_error.restype = ctypes.c_char_p
        lib.mmt_zstd_error.argtypes = [i64]
        lib.mmt_xxh64.restype = u64
        lib.mmt_xxh64.argtypes = [ctypes.c_char_p, size, u64]
        _lib = lib
        return lib


def _raise(lib: ctypes.CDLL, code: int) -> None:
    raise ZstdError(lib.mmt_zstd_error(code).decode())


def decompress(data, size: Optional[int] = None) -> bytearray:
    """The content of zstd `data` (frames, skippable frames skipped), every
    content checksum verified, in the buffer it was decoded into (no
    copy). `size` is the content's length where the caller knows it; else
    the frames' headers give it, or the output buffer grows until the
    content fits."""
    lib = library()
    data = data if isinstance(data, bytes) else bytes(data)
    if size is None:
        size = lib.mmt_zstd_content_size(data, len(data))
        if size < -1:
            _raise(lib, size)
    known = size >= 0
    cap = size if known else max(4 * len(data), 1 << 16)
    while True:
        out = bytearray(cap)
        buf = (ctypes.c_char * cap).from_buffer(out) if cap else None
        n = lib.mmt_zstd_decompress(data, len(data), ctypes.addressof(buf) if cap else None, cap)
        if n == E_DST_SMALL and not known:
            cap *= 2
            continue
        if n < 0:
            _raise(lib, n)
        del buf
        del out[n:]
        return out


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of `data` (the host decoder's, for the tests)."""
    data = data if isinstance(data, bytes) else bytes(data)
    return int(library().mmt_xxh64(data, len(data), seed))
