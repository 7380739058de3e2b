"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

One ``nvcc`` call compiles every source for ``sm_90a`` into one shared
library with a plain C interface, which ``ctypes`` loads. The library lives
in ``build/minimagen_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``), is built at first use, and is rebuilt only when a hash of the
sources and flags changes. Nothing here includes PyTorch's headers, so the
build takes well under a minute on the card (including PyTorch's headers
costs minutes per file). ``ptxas``'s register and spill report of the last
build is kept in ``build.log`` beside the library.

Every C entry point launches on PyTorch's current stream and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0 and counts the
launch in :data:`LAUNCHES`, so a run can show which kernels its main path went
through.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "minimagen_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points: name -> argtypes (all return int status)
_ATTN_FWD = [_P] * 6 + [_I] * 6 + [_P]   # q k v bias o lse, b h n j d dtype, stream
_ATTN_BWD = [_P] * 11 + [_I] * 6 + [_P]  # q k v bias o do lse dq dk dv scratch, ...
SIGNATURES = {
    "mmt_mqa_forward": _ATTN_FWD,
    "mmt_mha_forward": _ATTN_FWD,
    "mmt_mqa_backward": _ATTN_BWD,
    "mmt_mha_backward": _ATTN_BWD,
    "mmt_group_norm_forward": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I, _I, _P],
    "mmt_group_norm_backward": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _P],
    "mmt_depth_to_space_bias": [_P, _P, _P] + [_I] * 6 + [_P],  # y2 bias out, b h w f c dtype
}
# helpers that launch nothing: name -> argtypes (return int)
QUERIES = {"mmt_group_norm_scratch_floats": [_I, _I, _I, _I],
           "mmt_group_norm_bwd_scratch_floats": [_I, _I, _I, _I]}

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "mqa_forward", "mha_forward", "group_norm_forward",
    "mqa_backward", "mha_backward", "group_norm_backward", "depth_to_space_bias")}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_library = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> List[str]:
    """The CUDA sources and headers, sorted."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_digest() -> str:
    """sha256 over the flags and every source's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libminimagen_tpu_torch_{source_digest()}.so")


def nvcc_executable() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def nvcc_command(output: str) -> List[str]:
    cu = [p for p in sources() if p.endswith(".cu")]
    return [nvcc_executable(), *NVCC_FLAGS, "-o", output, *cu]


def build() -> str:
    """Compile the library unless a build of the current sources exists;
    returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in {**SIGNATURES, **QUERIES}.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mmt_error_string.argtypes = [ctypes.c_int]
            lib.mmt_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def current_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, *args) -> None:
    """Call entry point ``mmt_<kernel>``; raise on a non-zero CUDA status,
    else count the launch."""
    lib = library()
    status = getattr(lib, f"mmt_{kernel}")(*args)
    if status != 0:
        msg = lib.mmt_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({status})")
    LAUNCHES[kernel] += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32/bfloat16 CUDA tensor
    on one device, of one dtype."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype not in DTYPE_CODES or t.dtype != first.dtype:
            raise ValueError(f"{name}: inputs must share one dtype of float32/bfloat16, "
                             f"got {[x.dtype for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
