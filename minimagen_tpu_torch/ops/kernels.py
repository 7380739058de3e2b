"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

One ``nvcc`` per source, all started together, compiles the sources for
``sm_90a``, and one more links them into a shared library with a plain C
interface, which ``ctypes`` loads. The library lives
in ``build/minimagen_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``), is built at first use, and is rebuilt only when a hash of the
sources and flags changes. Nothing here includes PyTorch's headers, so the
build takes well under a minute on the card (including PyTorch's headers
costs minutes per file). ``ptxas``'s register and spill report of the last
build is kept in ``build.log`` beside the library.

Every C entry point launches on PyTorch's current stream and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0 and counts the
launch in :data:`LAUNCHES` (and, by the inputs' type, in
:data:`LAUNCHES_BY_DTYPE`), so a run can show which kernels its main path went
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
from typing import Dict, List, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "minimagen_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points: name -> argtypes (all return int status)
_ATTN_FWD = [_P] * 7 + [_I] * 6 + [_P]   # q k v bias o lse scratch, b h n j d dtype, stream
_ATTN_BWD = [_P] * 11 + [_I] * 6 + [_P]  # q k v bias o do lse dq dk dv scratch, ...
SIGNATURES = {
    "mmt_mqa_forward": _ATTN_FWD,
    "mmt_mha_forward": _ATTN_FWD,
    "mmt_mqa_backward": _ATTN_BWD,
    "mmt_mha_backward": _ATTN_BWD,
    # x gamma beta scale shift, ss_stride, y mean rstd scratch, scratch_floats, b hw c groups,
    # eps, silu dtype, plan, stream
    "mmt_group_norm_forward": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I, _I, _P, _P],
    # x dy gamma beta scale shift, ss_stride, mean rstd dx dgamma dbeta dscale dshift scratch,
    # scratch_floats, ticket, b hw c groups silu dtype, plan, stream
    "mmt_group_norm_backward": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "mmt_depth_to_space_bias": [_P, _P, _P] + [_I] * 6 + [_P],  # y2 bias out, b h w f c dtype
}
# helpers that launch nothing: name -> argtypes (return int)
QUERIES = {"mmt_group_norm_plan": [_I] * 8 + [_P],  # backward b hw c groups dtype vec form, out
           "mmt_mha_backward_row_splits": [_I, _I, _I, _I],
           "mmt_tf32_backward_row_splits": [_I] * 5}  # b h n j shared_kv

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "mqa_forward", "mha_forward", "group_norm_forward",
    "mqa_backward", "mha_backward", "group_norm_backward", "depth_to_space_bias")}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the same counts split by the inputs' type: "float32" / "bfloat16" -> kernel -> launches
LAUNCHES_BY_DTYPE: Dict[str, Dict[str, int]] = {
    str(dtype).split(".")[-1]: dict.fromkeys(LAUNCHES, 0) for dtype in DTYPE_CODES}

_lock = threading.Lock()
_library = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, *LAUNCHES_BY_DTYPE.values()):
        for name in counts:
            counts[name] = 0


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


def nvcc_commands(output: str) -> Tuple[List[List[str]], List[str]]:
    """The compile of each ``.cu`` source into an object beside `output`,
    and the link of those objects into the library `output`."""
    nvcc = nvcc_executable()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    compiles, objects = [], []
    for src in (p for p in sources() if p.endswith(".cu")):
        obj = f"{output}.{os.path.basename(src)}.o"
        compiles.append([nvcc, *compile_flags, "-c", "-o", obj, src])
        objects.append(obj)
    return compiles, [nvcc, *NVCC_FLAGS, "-o", output, *objects]


def build() -> str:
    """Compile the library unless a build of the current sources exists
    (the sources in parallel, then the link); returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    compiles, link = nvcc_commands(tmp)
    logs = [f"{tmp}.{os.path.basename(cmd[-1])}.log" for cmd in compiles]
    procs = []
    for cmd, log in zip(compiles, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT))
    codes = [p.wait() for p in procs]
    text = "".join(open(log).read() for log in logs)
    if not any(codes):
        proc = subprocess.run(link, capture_output=True, text=True)
        codes.append(proc.returncode)
        text += proc.stdout + proc.stderr
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(text)
    for path in [*logs, *(cmd[cmd.index("-o") + 1] for cmd in compiles)]:
        if os.path.exists(path):
            os.remove(path)
    if any(codes):
        raise RuntimeError(f"nvcc failed ({codes}):\n{text}")
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
    """The raw handle of PyTorch's current stream on t's card (t a CUDA
    tensor)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch(kernel: str, *args, dtype: torch.dtype) -> None:
    """Call entry point ``mmt_<kernel>`` on inputs of `dtype`; raise on a
    non-zero CUDA status, else count the launch."""
    lib = library()
    status = getattr(lib, f"mmt_{kernel}")(*args)
    if status != 0:
        msg = lib.mmt_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({status})")
    LAUNCHES[kernel] += 1
    LAUNCHES_BY_DTYPE[str(dtype).split(".")[-1]][kernel] += 1


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
