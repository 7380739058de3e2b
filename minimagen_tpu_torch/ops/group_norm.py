"""Fused GroupNorm -> time scale-shift -> SiLU, forward and backward
(counterpart of ``minimagen_tpu/ops/group_norm.py``).

The Pallas kernels ``_fwd_kernel`` (:89) and ``_bwd_kernel`` (:156) are
``csrc/group_norm.cu`` here (design notes there). Beside them are the plain
versions: the forward copies the cast order of the JAX package's
``_xla_forward_reference`` (:296-312): float32 statistics, the normalised
value cast to the activation dtype, then gamma, beta, scale-shift and SiLU in
the activation dtype; the backward is the float32 closed form of its
``_fused_bwd`` (:263-290).

:class:`GroupNormSiLU` is the ``autograd.Function``: its forward keeps the
group mean and rstd, its backward gives dx, dgamma/dbeta (in the dtype of
the parameters it was given) and the per-sample dscale/dshift.
:func:`group_norm_silu` builds that graph only when a gradient is wanted.
It takes the plain versions only for tensors on the CPU; for CUDA tensors it
launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import kernels
from .flash_attention import acc_dtype, needs_grad

ScaleShift = Optional[Tuple[torch.Tensor, torch.Tensor]]


def group_norm_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                          groups: int, eps: float = 1e-5,
                          scale_shift: ScaleShift = None,
                          silu: bool = False) -> torch.Tensor:
    """x (b, h, w, c) NHWC; gamma, beta (c,); scale_shift a pair of tensors
    broadcasting to (b, 1, 1, c), applied as ``y * (scale + 1) + shift``."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups).to(acc_dtype(x.dtype))
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c).to(x.dtype)
    out = out * gamma.to(x.dtype) + beta.to(x.dtype)
    if scale_shift is not None:
        scale, shift = scale_shift
        out = out * (scale + 1.0) + shift
    return F.silu(out) if silu else out


def group_stats_plain(x: torch.Tensor, groups: int, eps: float = 1e-5):
    """The (b, groups) mean and rstd the forward normalises with."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups).to(acc_dtype(x.dtype))
    mean = xg.mean(dim=(1, 2, 4))
    var = (xg - mean[:, None, None, :, None]).square().mean(dim=(1, 2, 4))
    return mean, torch.rsqrt(var + eps)


def group_norm_silu_bwd_plain(x, gamma, beta, scale, shift, mean, rstd, g, *, groups: int,
                              silu: bool):
    """The backward in float32 (float64 for float64 inputs), the closed form
    of the JAX package's ``_fused_bwd``: x, g (b, h, w, c); gamma, beta (c,);
    scale, shift None or broadcasting to (b, 1, 1, c); mean, rstd (b, groups).
    Returns (dx in x's dtype, dgamma (c,), dbeta (c,), dscale (b, c),
    dshift (b, c)); the last two are None without scale/shift."""
    b, h, w, c = x.shape
    f = acc_dtype(x.dtype)
    cpg = c // groups
    per_channel = lambda t: t.to(f).repeat_interleave(cpg, dim=1)[:, None, None, :]  # noqa: E731
    xhat = (x.to(f) - per_channel(mean)) * per_channel(rstd)
    y1 = xhat * gamma.to(f) + beta.to(f)
    g32 = g.to(f)
    if scale is not None:
        s1 = scale.to(f).expand(b, 1, 1, c) + 1.0
        t = shift.to(f).expand(b, 1, 1, c)
    else:
        s1 = torch.ones(b, 1, 1, c, dtype=f, device=x.device)
        t = torch.zeros(b, 1, 1, c, dtype=f, device=x.device)
    if silu:
        y2 = y1 * s1 + t
        sig = torch.sigmoid(y2)
        dy2 = g32 * (sig * (1.0 + y2 * (1.0 - sig)))
    else:
        dy2 = g32
    dss_t = dy2.sum(dim=(1, 2))
    dss_s = (dy2 * y1).sum(dim=(1, 2))
    dy1 = dy2 * s1
    dbeta = dy1.sum(dim=(0, 1, 2))
    dgamma = (dy1 * xhat).sum(dim=(0, 1, 2))
    dxhat = dy1 * gamma.to(f)
    grp = lambda z: z.reshape(b, h, w, groups, cpg)  # noqa: E731
    m1 = grp(dxhat).mean(dim=(1, 2, 4))
    m2 = grp(dxhat * xhat).mean(dim=(1, 2, 4))
    dx = per_channel(rstd) * (dxhat - per_channel(m1) - xhat * per_channel(m2))
    if scale is None:
        dss_s = dss_t = None
    return dx.to(x.dtype), dgamma, dbeta, dss_s, dss_t


# --------------------------------------------------------------------------- #
# kernel launches                                                              #
# --------------------------------------------------------------------------- #
def _scale_shift_rows(scale, shift, x):
    """Scale/shift (b, 1, 1, c) of x's dtype as rows of c contiguous values
    one stride apart (the halves of the time MLP's output, read in place)."""
    if scale is None:
        return None, None, 0
    if scale.stride(-1) != 1 or shift.stride(-1) != 1 or scale.stride(0) != shift.stride(0):
        scale, shift = scale.contiguous(), shift.contiguous()
    return scale, shift, scale.stride(0)


def _check_scale_shift(scale, shift, x):
    b, _, _, c = x.shape
    for t in (scale, shift):
        if t is not None and (tuple(t.shape) != (b, 1, 1, c) or t.dtype != x.dtype
                              or t.device != x.device):
            raise ValueError(f"group_norm: scale/shift must be (b, 1, 1, c) of x's dtype on its "
                             f"device, got {tuple(t.shape)} {t.dtype}")


def group_norm_forward_kernel(x, gamma, beta, scale, shift, *, groups: int, eps: float,
                              silu: bool):
    """Launch the forward kernel; x (b, h, w, c) contiguous, gamma/beta (c,)
    and scale/shift (b, 1, 1, c) or None, all of x's dtype. Returns
    (y, mean, rstd), the statistics (b, groups) float32."""
    b, h, w, c = x.shape
    kernels.require_cuda("group_norm_forward", x, gamma, beta)
    _check_scale_shift(scale, shift, x)
    scale, shift, ss_stride = _scale_shift_rows(scale, shift, x)
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
    return y, mean.view(b, groups), rstd.view(b, groups)


def group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, *, groups: int,
                               silu: bool):
    """Launch the backward kernel; arguments as for the forward plus the
    forward's mean/rstd and the output cotangent g (b, h, w, c) contiguous.
    Returns (dx, dgamma, dbeta, dscale, dshift) like the plain version, the
    parameter and scale-shift gradients float32."""
    b, h, w, c = x.shape
    kernels.require_cuda("group_norm_backward", x, gamma, beta, g)
    _check_scale_shift(scale, shift, x)
    if tuple(g.shape) != tuple(x.shape) or tuple(mean.shape) != (b, groups) \
            or tuple(rstd.shape) != (b, groups):
        raise ValueError("group_norm_backward: cotangent or statistics do not match x")
    scale, shift, ss_stride = _scale_shift_rows(scale, shift, x)
    lib = kernels.library()
    n_scratch = lib.mmt_group_norm_bwd_scratch_floats(b, h * w, c, groups)
    f32 = dict(device=x.device, dtype=torch.float32)
    scratch = torch.empty(n_scratch, **f32)
    dgamma, dbeta = torch.empty(c, **f32), torch.empty(c, **f32)
    dscale = dshift = None
    if scale is not None:
        dscale, dshift = torch.empty(b, c, **f32), torch.empty(b, c, **f32)
    dx = torch.empty_like(x)
    kernels.launch(
        "group_norm_backward", x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if scale is None else scale.data_ptr(), None if shift is None else shift.data_ptr(),
        ss_stride, mean.contiguous().data_ptr(), rstd.contiguous().data_ptr(), dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), None if dscale is None else dscale.data_ptr(),
        None if dshift is None else dshift.data_ptr(), scratch.data_ptr(), n_scratch, b, h * w,
        c, groups, int(silu), kernels.DTYPE_CODES[x.dtype], kernels.current_stream(x))
    return dx, dgamma, dbeta, dscale, dshift


# --------------------------------------------------------------------------- #
# autograd and dispatch                                                        #
# --------------------------------------------------------------------------- #
class GroupNormSiLU(torch.autograd.Function):
    """GroupNorm + optional scale-shift + optional SiLU with the fused
    backward. x (b, h, w, c); gamma, beta (c,) of any float dtype (cast to
    x's at use); scale, shift None or (b, 1, 1, c) of x's dtype."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, groups, eps, silu):
        gamma_x, beta_x = gamma.to(x.dtype), beta.to(x.dtype)
        if x.device.type == "cpu":
            ss = None if scale is None else (scale, shift)
            y = group_norm_silu_plain(x, gamma_x, beta_x, groups=groups, eps=eps,
                                      scale_shift=ss, silu=silu)
            mean, rstd = group_stats_plain(x, groups, eps)
        else:
            x = x.contiguous()
            y, mean, rstd = group_norm_forward_kernel(
                x, gamma_x.contiguous(), beta_x.contiguous(), scale, shift, groups=groups,
                eps=eps, silu=silu)
        ctx.save_for_backward(x, gamma_x, beta_x, scale, shift, mean, rstd)
        ctx.groups, ctx.silu = groups, silu
        ctx.param_dtypes = (gamma.dtype, beta.dtype)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, beta, scale, shift, mean, rstd = ctx.saved_tensors
        kw = dict(groups=ctx.groups, silu=ctx.silu)
        if x.device.type == "cpu":
            dx, dgamma, dbeta, dscale, dshift = group_norm_silu_bwd_plain(
                x, gamma, beta, scale, shift, mean, rstd, g, **kw)
        else:
            dx, dgamma, dbeta, dscale, dshift = group_norm_backward_kernel(
                x, gamma, beta, scale, shift, mean, rstd, g.contiguous(), **kw)
        if scale is not None:
            dscale = dscale.reshape(scale.shape).to(scale.dtype)
            dshift = dshift.reshape(shift.shape).to(shift.dtype)
        return (dx, dgamma.to(ctx.param_dtypes[0]), dbeta.to(ctx.param_dtypes[1]), dscale,
                dshift, None, None, None)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                    groups: int, eps: float = 1e-5, scale_shift: ScaleShift = None,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm + optional time scale-shift + optional SiLU (see
    :func:`group_norm_silu_plain` for the arguments)."""
    b, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible into {groups} groups")
    scale = shift = None
    if scale_shift is not None:
        scale, shift = (t.to(x.dtype).expand(b, 1, 1, c) for t in scale_shift)
    if needs_grad(x, gamma, beta, scale, shift):
        return GroupNormSiLU.apply(x, gamma, beta, scale, shift, groups, eps, silu)
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, groups=groups, eps=eps,
                                     scale_shift=scale_shift, silu=silu)
    return group_norm_forward_kernel(
        x.contiguous(), gamma.to(x.dtype).contiguous(), beta.to(x.dtype).contiguous(),
        scale, shift, groups=groups, eps=eps, silu=silu)[0]
