"""Exact ``resize_right`` resampling (counterpart of
``minimagen_tpu/ops/resize_right.py``).

The per-dimension resampling matrices are the JAX package's, built in float64
numpy with the cubic kernel (a=-0.5), antialiasing for downscaling and the
pad-mode boundary folded into the columns; the resize is one matrix product
per resized dimension, smallest scale first.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_SUPPORT = 4.0  # cubic kernel support


def cubic_kernel(x: np.ndarray) -> np.ndarray:
    """resize_right's cubic (a = -0.5, the MATLAB/Keys kernel)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1.0)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1.0) & (ax <= 2.0)))


def _pad_index(i: np.ndarray, n: int, pad_mode: str) -> np.ndarray:
    """Source rows of (possibly out-of-range) taps; -1 drops a tap."""
    if pad_mode == "constant":
        return np.where((i < 0) | (i >= n), -1, i)
    if pad_mode == "edge":
        return np.clip(i, 0, n - 1)
    if pad_mode == "reflect":
        if n == 1:
            return np.zeros_like(i)
        period = 2 * (n - 1)
        m = np.mod(i, period)
        return np.where(m < n, m, period - m)
    if pad_mode == "symmetric":
        period = 2 * n
        m = np.mod(i, period)
        return np.where(m < n, m, period - 1 - m)
    raise ValueError(f"unsupported pad_mode {pad_mode!r}")


@lru_cache(maxsize=64)
def resize_matrix(in_sz: int, out_sz: int, scale: float, pad_mode: str = "reflect",
                  antialiasing: bool = True) -> np.ndarray:
    """Dense (out_sz, in_sz) float64 resampling matrix for one dimension.
    Callers must not write to the cached array."""
    eps = float(np.finfo(np.float32).eps)
    grid = (np.arange(out_sz, dtype=np.float64) / scale
            + (in_sz - 1) / 2.0 - (out_sz - 1) / (2.0 * scale))
    if antialiasing and scale < 1.0:
        support = _SUPPORT / scale

        def kernel(x):
            return scale * cubic_kernel(scale * x)
    else:
        support = _SUPPORT
        kernel = cubic_kernel
    left = np.ceil(grid - support / 2.0 - eps).astype(np.int64)
    width = int(math.ceil(support - eps))
    fov = left[:, None] + np.arange(width)[None, :]
    weights = kernel(grid[:, None] - fov)
    ssum = weights.sum(axis=1, keepdims=True)
    ssum[ssum == 0] = 1.0
    weights = weights / ssum
    src = _pad_index(fov, in_sz, pad_mode)
    mat = np.zeros((out_sz, in_sz), dtype=np.float64)
    rows = np.broadcast_to(np.arange(out_sz)[:, None], fov.shape)
    keep = src >= 0
    np.add.at(mat, (rows[keep], src[keep]), weights[keep])
    return mat


def resize(image: torch.Tensor, scale_factors=None, out_shape: Optional[Sequence[int]] = None,
           *, dims: Tuple[int, int] = (-2, -1), pad_mode: str = "reflect",
           antialiasing: bool = True) -> torch.Tensor:
    """resize_right-equivalent separable resize over two spatial dims (a
    scalar scale applies to both; out size defaults to ``ceil(scale * in)``)."""
    ndim = image.ndim
    dims = tuple(d % ndim for d in dims)
    in_szs = [image.shape[d] for d in dims]
    if scale_factors is None and out_shape is None:
        raise ValueError("either scale_factors or out_shape must be given")
    if scale_factors is None:
        scales = [o / i for o, i in zip(out_shape, in_szs)]
    elif isinstance(scale_factors, (list, tuple)):
        scales = [float(s) for s in scale_factors]
    else:
        scales = [float(scale_factors)] * len(dims)
    if out_shape is None:
        out_shape = [math.ceil(s * i) for s, i in zip(scales, in_szs)]

    out = image
    for k in sorted(range(len(dims)), key=lambda i: scales[i]):
        if scales[k] == 1.0 and out_shape[k] == in_szs[k]:
            continue
        mat = resize_matrix(in_szs[k], int(out_shape[k]), scales[k], pad_mode, antialiasing)
        wdtype = out.dtype if out.dtype in (torch.float32, torch.float64) else torch.float32
        w = torch.as_tensor(mat, dtype=wdtype, device=out.device)
        moved = out.movedim(dims[k], 0)
        res = torch.tensordot(w, moved, dims=([1], [0]))
        out = res.movedim(0, dims[k])
    return out
