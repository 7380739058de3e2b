"""Fused GroupNorm -> time scale-shift -> SiLU, forward and backward
(counterpart of ``minimagen_tpu/ops/group_norm.py``).

The Pallas kernels ``_fwd_kernel`` (:89) and ``_bwd_kernel`` (:156) are
``csrc/group_norm.cu`` here (design notes there): per call a plan, made once
per shape and cached, picks the streaming form (two launches) or the
cluster form (one launch) and the vector width. Beside them are the plain
versions (and ``group_stats_tiles_plain``, the streaming form's statistics
modelled on the CPU): the forward copies the cast order of the JAX package's
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

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
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


def group_stats_tiles_plain(x: torch.Tensor, groups: int, tile_pixels: int,
                            tiles_per_part: Optional[int] = None, eps: float = 1e-5):
    """The streaming form's (b, groups) mean and rstd: per tile of
    `tile_pixels` pixels (the last may be shorter) and group, the two-pass
    mean and centred M2; the tiles of each run of `tiles_per_part` (one run
    of all tiles by default) merged with Chan's formula in tile order, then
    the runs in order, as ``csrc/group_norm.cu`` (``gn_fwd_stats_kernel``,
    ``merge_parts``) does. E[x^2] - mean^2 is never formed."""
    b, h, w, c = x.shape
    f = acc_dtype(x.dtype)
    xg = x.reshape(b, h * w, groups, c // groups).to(f)
    tiles = -(-(h * w) // tile_pixels)
    per_part = tiles_per_part or tiles

    def merge(into, part):
        n, mean, m2 = into
        nb, mb, m2b = part
        nn = n + nb
        d = mb - mean
        return nn, mean + d * (nb / nn), (m2 + m2b) + d * d * (n * nb / nn)

    zero = torch.zeros(b, groups, dtype=f, device=x.device)
    total = (0.0, zero, zero)
    for p0 in range(0, tiles, per_part):
        run = (0.0, zero, zero)
        for t in range(p0, min(tiles, p0 + per_part)):
            tile = xg[:, t * tile_pixels:(t + 1) * tile_pixels]
            nb = float(tile.shape[1] * (c // groups))
            tmean = tile.sum(dim=(1, 3)) / nb
            run = merge(run, (nb, tmean, (tile - tmean[:, None, :, None]).square().sum(dim=(1, 3))))
        total = merge(total, run)
    n, mean, m2 = total
    return mean, torch.rsqrt(m2 / n + eps)


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
# A call's plan (csrc/group_norm.cu::Plan, 16 ints): the fields read here
PLAN_INTS, PLAN_FORM, PLAN_NV, PLAN_PARTS, PLAN_TILE_PIXELS, PLAN_TILES_PER_PART = 16, 0, 1, 4, 6, 9
PLAN_SCRATCH = 12
FORMS = {None: 0, "cluster": 1, "stream": 2}
FORM_NAMES = {1: "cluster", 2: "stream"}
_plans = {}    # (backward, device, sizes, dtype, vector bytes, form) -> ctypes int array
_tickets = {}  # (device, stream) -> the backward's int32 ticket, left 0 by every call


def vector_bytes(c: int, itemsize: int, *tensors: torch.Tensor) -> int:
    """The widest vector (16, 8, 4 or 2 bytes, at least one element) that
    divides a row of c channels and every tensor's address."""
    bits = c * itemsize | 16
    for t in tensors:
        bits |= t.data_ptr()
    return max(itemsize, bits & -bits)


def plan(backward: bool, shape, dtype: torch.dtype, device: int, groups: int,
         vec_bytes: int = 16, form: Optional[str] = None):
    """The kernels' plan of a call on card `device` (form, vector width,
    grid, scratch), made once per shape by ``mmt_group_norm_plan`` (which
    asks the card whether a cluster fits) and cached."""
    b, h, w, c = shape
    key = (backward, device, b, h * w, c, groups, dtype, vec_bytes, form)
    arr = _plans.get(key)
    if arr is None:
        arr = (ctypes.c_int * PLAN_INTS)()
        status = kernels.library().mmt_group_norm_plan(
            int(backward), b, h * w, c, groups, kernels.DTYPE_CODES[dtype], vec_bytes,
            FORMS[form], ctypes.addressof(arr))
        if status != 0:
            raise ValueError(f"group_norm: no {form or 'kernel'} form for {tuple(shape)} "
                             f"{dtype} with {groups} groups")
        _plans[key] = arr
    return arr


def plan_info(backward: bool, x: torch.Tensor, groups: int, form: Optional[str] = None) -> dict:
    """The form, vector width, blocks per (sample, slice), and the streaming
    statistics' tile pixels and tiles per block that the kernels take for x
    (b, h, w, c) on its card."""
    arr = plan(bool(backward), x.shape, x.dtype, x.get_device(), groups,
               vector_bytes(x.shape[-1], x.element_size(), x), form)
    return dict(form=FORM_NAMES[arr[PLAN_FORM]], vector=arr[PLAN_NV], parts=arr[PLAN_PARTS],
                tile_pixels=arr[PLAN_TILE_PIXELS], tiles_per_part=arr[PLAN_TILES_PER_PART])


def _ticket(device: int, stream: int) -> torch.Tensor:
    t = _tickets.get((device, stream))
    if t is None:
        t = _tickets[(device, stream)] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def group_norm_forward_kernel(x, gamma, beta, scale, shift, *, groups: int, eps: float,
                              silu: bool, form: Optional[str] = None):
    """Launch the forward kernels; x (b, h, w, c) contiguous, gamma/beta (c,)
    and scale/shift (b, 1, 1, c) or None, all of x's dtype. Returns
    (y, mean, rstd), the statistics (b, groups) float32. `form` ("cluster"
    or "stream") overrides the rule, for tests and measurements."""
    b, h, w, c = x.shape
    kernels.require_cuda("group_norm_forward", x, gamma, beta)
    _check_scale_shift(scale, shift, x)
    scale, shift, ss_stride = _scale_shift_rows(scale, shift, x)
    y = torch.empty_like(x)
    p = plan(False, x.shape, x.dtype, x.get_device(), groups,
             vector_bytes(c, x.element_size(), x, y), form)
    # mean, rstd, then the scratch, in (b, groups) planes of float32 (views
    # cost more host time than a whole allocation)
    n_scratch, plane = p[PLAN_SCRATCH], b * groups
    floats = torch.empty(2 + -(-n_scratch // plane), b, groups, device=x.device,
                         dtype=torch.float32)
    at = floats.data_ptr()
    kernels.launch(
        "group_norm_forward", x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), _ptr(scale),
        _ptr(shift), ss_stride, y.data_ptr(), at, at + 4 * plane, at + 8 * plane, n_scratch, b,
        h * w, c, groups, float(eps), int(silu), kernels.DTYPE_CODES[x.dtype],
        ctypes.addressof(p), kernels.current_stream(x), dtype=x.dtype)
    return y, floats[0], floats[1]


def group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, *, groups: int,
                               silu: bool, form: Optional[str] = None):
    """Launch the backward kernels; arguments as for the forward plus the
    forward's mean/rstd and the output cotangent g (b, h, w, c) contiguous.
    Returns (dx, dgamma, dbeta, dscale, dshift) like the plain version, the
    parameter and scale-shift gradients float32 views of one buffer."""
    b, h, w, c = x.shape
    kernels.require_cuda("group_norm_backward", x, gamma, beta, g)
    _check_scale_shift(scale, shift, x)
    if tuple(g.shape) != tuple(x.shape) or tuple(mean.shape) != (b, groups) \
            or tuple(rstd.shape) != (b, groups):
        raise ValueError("group_norm_backward: cotangent or statistics do not match x")
    scale, shift, ss_stride = _scale_shift_rows(scale, shift, x)
    dx = torch.empty_like(x)
    device = x.get_device()
    p = plan(True, x.shape, x.dtype, device, groups,
             vector_bytes(c, x.element_size(), x, g, dx), form)
    # rows of c float32: dgamma, dbeta, (with scale-shift) b of dscale and b
    # of dshift, then the scratch
    n_scratch, ss_rows = p[PLAN_SCRATCH], (0 if scale is None else b)
    rows = torch.empty(2 + 2 * ss_rows + -(-n_scratch // c), c, device=x.device,
                       dtype=torch.float32)
    at = rows.data_ptr()
    stream = kernels.current_stream(x)
    kernels.launch(
        "group_norm_backward", x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        _ptr(scale), _ptr(shift), ss_stride, mean.contiguous().data_ptr(),
        rstd.contiguous().data_ptr(), dx.data_ptr(), at, at + 4 * c,
        None if scale is None else at + 8 * c, None if scale is None else at + 4 * (2 + b) * c,
        at + 4 * (2 + 2 * ss_rows) * c, n_scratch, _ticket(device, stream).data_ptr(), b, h * w,
        c, groups, int(silu), kernels.DTYPE_CODES[x.dtype], ctypes.addressof(p), stream,
        dtype=x.dtype)
    if scale is None:
        return dx, rows[0], rows[1], None, None
    return dx, rows[0], rows[1], rows[2:2 + b], rows[2 + b:2 + 2 * b]


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
        with span("group_norm.backward"):
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
