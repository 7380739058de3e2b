"""Fused GroupNorm -> time scale-shift -> SiLU (counterpart of
``minimagen_tpu/ops/group_norm.py``).

The Pallas kernel ``_fwd_kernel`` (:89) is ``csrc/group_norm.cu`` here
(design notes there). Beside it is the plain version, which copies the cast
order of the JAX package's ``_xla_forward_reference`` (:296-312): float32
statistics, the normalised value cast to the activation dtype, then gamma,
beta, scale-shift and SiLU in the activation dtype.

:func:`group_norm_silu` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

ScaleShift = Optional[Tuple[torch.Tensor, torch.Tensor]]


def group_norm_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                          groups: int, eps: float = 1e-5,
                          scale_shift: ScaleShift = None,
                          silu: bool = False) -> torch.Tensor:
    """x (b, h, w, c) NHWC; gamma, beta (c,); scale_shift a pair of tensors
    broadcasting to (b, 1, 1, c), applied as ``y * (scale + 1) + shift``."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups).float()
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c).to(x.dtype)
    out = out * gamma.to(x.dtype) + beta.to(x.dtype)
    if scale_shift is not None:
        scale, shift = scale_shift
        out = out * (scale + 1.0) + shift
    return F.silu(out) if silu else out


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                    groups: int, eps: float = 1e-5, scale_shift: ScaleShift = None,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm + optional time scale-shift + optional SiLU (see
    :func:`group_norm_silu_plain` for the arguments)."""
    b, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible into {groups} groups")
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, groups=groups, eps=eps,
                                     scale_shift=scale_shift, silu=silu)
    x = x.contiguous()
    gamma = gamma.to(x.dtype).contiguous().reshape(c)
    beta = beta.to(x.dtype).contiguous().reshape(c)
    kernels.require_cuda("group_norm_forward", x, gamma, beta)
    scale = shift = None
    ss_stride = 0
    if scale_shift is not None:
        # read the halves of the time MLP's output in place: rows of c
        # contiguous values, one row per sample
        scale, shift = (t.to(x.dtype).expand(b, 1, 1, c) for t in scale_shift)
        if scale.stride(-1) != 1 or shift.stride(-1) != 1 or scale.stride(0) != shift.stride(0):
            scale, shift = scale.contiguous(), shift.contiguous()
        ss_stride = scale.stride(0)
    lib = kernels.library()
    n_scratch = lib.mmt_group_norm_scratch_floats(b, h * w, c, groups)
    floats = torch.empty(2 * b * groups + n_scratch, device=x.device, dtype=torch.float32)
    mean, rstd = floats[: b * groups], floats[b * groups: 2 * b * groups]
    y = torch.empty_like(x)
    kernels.launch(
        "group_norm_forward", x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if scale is None else scale.data_ptr(), None if shift is None else shift.data_ptr(),
        ss_stride, y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        floats[2 * b * groups:].data_ptr(), n_scratch, b, h * w, c, groups, float(eps),
        int(silu), kernels.DTYPE_CODES[x.dtype], kernels.current_stream(x))
    return y
