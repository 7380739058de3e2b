"""Fused attention, forward and backward: CUDA kernels and their plain
PyTorch versions.

Counterpart of ``minimagen_tpu/ops/flash_attention.py``. Its Pallas kernels
``_mqa_kernel`` (:92), ``_mha_kernel`` (:97), ``_mha_bias_kernel`` (:349),
``_mqa_bwd_kernel`` (:174) and ``_mha_bias_bwd_kernel`` (:394) are
``csrc/flash_attention.cu`` here (design notes there). Beside each kernel is
its plain version, which the CPU tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against on the card.

:class:`MQAFlash` and :class:`MHAFlash` are the ``autograd.Function``s, the
counterparts of the JAX package's ``custom_vjp``s: the forward keeps the
rows' log-sum-exp and the backward rebuilds the probabilities from it. Both
take an optional float32 logit bias (b, 1, 1, j), the mask-derived bias of
``minimagen_tpu/ops/attention.py::_mask_bias``; its cotangent is zero, as in
the JAX package (:484-487). The wrappers build the autograd graph only when
a gradient is wanted, so sampling launches the same forward as before.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import kernels

NEG_INF = -1e30  # large negative for masking pre-softmax logits (f32-safe)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type plain versions compute in: float64 for float64 inputs (the
    gradient checks), else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _softmax_f32(sim: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis in float32 (or float64); `mask` True = attend."""
    sim = sim.to(acc_dtype(sim.dtype))
    if mask is not None:
        sim = torch.where(mask, sim, torch.full_like(sim, NEG_INF))
    return torch.softmax(sim, dim=-1)


def mqa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None,
              attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-query attention: q (b, h, n, d) pre-scaled; one K/V head shared
    by all heads, k, v (b, j, d); `mask` (b, j) True = keep; `attn_bias`
    broadcasts against the (b, h, n, j) logits. Logits and softmax in
    float32, probabilities cast to v's dtype for the second product."""
    f = acc_dtype(q.dtype)
    sim = torch.einsum("bhnd,bjd->bhnj", q.to(f), k.to(f))
    if attn_bias is not None:
        sim = sim + attn_bias
    attn = _softmax_f32(sim, None if mask is None else mask[:, None, None, :])
    out = torch.einsum("bhnj,bjd->bhnd", attn.to(v.dtype), v)
    return out.to(q.dtype)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None,
              attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention: q (b, h, n, d) pre-scaled; k, v (b, h, j, d);
    `mask` (b, j) True = keep; `attn_bias` broadcasts against the logits.
    Softmax in float32."""
    f = acc_dtype(q.dtype)
    sim = torch.einsum("bhnd,bhjd->bhnj", q.to(f), k.to(f))
    if attn_bias is not None:
        sim = sim + attn_bias
    attn = _softmax_f32(sim, None if mask is None else mask[:, None, None, :])
    out = torch.einsum("bhnj,bhjd->bhnd", attn.to(v.dtype), v)
    return out.to(q.dtype)


def _bwd_plain(q, k, v, g, attn_bias, kv: str):
    """The closed-form attention backward in float32 (float64 for float64
    inputs): the JAX package's ``_mqa_bwd`` (:262-271) and ``_mha_bwd``
    (:320-330). `kv` is the einsum label of k/v: "bjd" (one shared head)
    or "bhjd"."""
    f = acc_dtype(q.dtype)
    q32, k32, v32, g32 = q.to(f), k.to(f), v.to(f), g.to(f)
    s = torch.einsum(f"bhnd,{kv}->bhnj", q32, k32)
    if attn_bias is not None:
        s = s + attn_bias
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum(f"bhnd,{kv}->bhnj", g32, v32)
    dv = torch.einsum(f"bhnj,bhnd->{kv}", p, g32)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum(f"bhnj,{kv}->bhnd", ds, k32)
    dk = torch.einsum(f"bhnj,bhnd->{kv}", ds, q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mqa_bwd_plain(q, k, v, g, attn_bias: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`mqa_plain` for output cotangent `g`."""
    return _bwd_plain(q, k, v, g, attn_bias, "bjd")


def mha_bwd_plain(q, k, v, g, attn_bias: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`mha_plain` for output cotangent `g`."""
    return _bwd_plain(q, k, v, g, attn_bias, "bhjd")


# --------------------------------------------------------------------------- #
# kernel launches                                                              #
# --------------------------------------------------------------------------- #
def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(kind: str, q, k, v, bias):
    """Shapes, devices, types and (for the tensor maps) 16-byte alignment a
    kernel takes; returns the bias as a contiguous float32 (b, j) row per
    sample, or None."""
    b, h, _, d = q.shape
    j = k.shape[-2]
    kv_shape = (b, j, d) if kind == "mqa" else (b, h, j, d)
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError(f"{kind}: k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if d != 64:
        raise ValueError(f"{kind}: the kernel takes head_dim 64, got {d}")
    kernels.require_cuda(kind, q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{kind}: q, k and v must start on a 16-byte boundary")
    if bias is None:
        return None
    if tuple(bias.shape) not in ((b, 1, 1, j), (b, j)) or bias.dtype != torch.float32 \
            or bias.device != q.device:
        raise ValueError(f"{kind}: the kernel takes a float32 bias of shape (b, 1, 1, j) on "
                         f"q's device, got {tuple(bias.shape)} {bias.dtype}")
    return bias.reshape(b, j).contiguous()


def _pad64(x: int) -> int:
    return -(-x // 64) * 64


def _qbatch_rows(kind: str, b: int, h: int, n: int):
    """The backward kernels' q-batches and their rows: multi-query a sample
    and its h * n rows across heads, multi-head a (sample, head) and its n."""
    return (b, h * n) if kind == "mqa" else (b * h, n)


def forward_scratch_floats(kind: str, dtype: torch.dtype, b: int, h: int, n: int, j: int,
                           d: int = 64) -> int:
    """Float32 scratch of the forward kernel: none in bf16; in float32 K in
    big and small tf32 parts (the layout of k) and V transposed, its keys
    padded to a multiple of 64, in both parts (csrc launch_forward_f32)."""
    if dtype == torch.bfloat16:
        return 0
    qbatch, _ = _qbatch_rows(kind, b, h, n)
    return 2 * qbatch * j * d + 2 * qbatch * d * _pad64(j)


def attention_forward_kernel(kind: str, q, k, v, bias=None, with_lse: bool = False):
    """Launch the forward kernel ("mqa" or "mha"); returns (out, lse), lse
    the float32 (b, h, n) log-sum-exp of each row's logits when asked for."""
    bias = _check(kind, q, k, v, bias)
    b, h, n, d = q.shape
    j = k.shape[-2]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, n, device=q.device, dtype=torch.float32) if with_lse else None
    floats = forward_scratch_floats(kind, q.dtype, b, h, n, j, d)
    scratch = torch.empty(floats, device=q.device, dtype=torch.float32) if floats else None
    kernels.launch(f"{kind}_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                   out.data_ptr(), _ptr(lse), _ptr(scratch), b, h, n, j, d,
                   kernels.DTYPE_CODES[q.dtype], kernels.current_stream(q), dtype=q.dtype)
    return out, lse


MAX_ROW_SPLITS = 4  # csrc/flash_attention.cu kMaxRowSplits: float32 dk/dv slices per sample


def backward_scratch_floats(kind: str, dtype: torch.dtype, b: int, h: int, n: int, j: int,
                            d: int = 64, splits: int = 1) -> int:
    """Float32 scratch of the backward kernel. Both types first keep the
    rows' D = rowsum(dO * O) and a copy of the lse, each q-batch's rows
    rounded up to 32 and the whole to 64 floats, so that every box the dk/dv
    pass loads starts 16-byte aligned, as TMA needs. Then dk/dv partial
    sums. The bf16 kernels keep dk/dv in registers: the multi-query one sums
    over all heads and keeps at most MAX_ROW_SPLITS slices per sample; the
    multi-head one writes dk/dv directly and keeps `splits` slices per
    (sample, head) only where its dk/dv pass splits the rows (`splits` > 1,
    from :func:`mha_row_splits`). The float32 kernels sum dk/dv in registers
    too (over the heads for multi-query) and keep `splits` slices per
    q-batch (:func:`tf32_row_splits`) only where `splits` > 1, and the
    inputs follow in big and small tf32 parts: q and dO, k and v as laid
    out, then K^T, Q^T and dO^T with their keys or rows padded to a multiple
    of 64 (csrc launch_backward_f32)."""
    qbatch, rows = _qbatch_rows(kind, b, h, n)
    lse_d = 2 * _pad64(qbatch * -(-rows // 32) * 32)
    if dtype == torch.bfloat16:
        if kind == "mqa":
            return lse_d + 2 * MAX_ROW_SPLITS * b * j * d
        return lse_d + (2 * splits * b * h * j * d if splits > 1 else 0)
    slices = 2 * splits * qbatch * j * d if splits > 1 else 0
    split = 4 * qbatch * rows * d + 4 * qbatch * j * d + 2 * qbatch * d * _pad64(j) \
        + 4 * qbatch * d * _pad64(rows)
    return lse_d + slices + split


def mha_row_splits(q: torch.Tensor, j: int) -> int:
    """Row splits the bf16 multi-head backward takes for q (b, h, n, 64) and
    j keys on q's card (at most MAX_ROW_SPLITS)."""
    b, h, n, _ = q.shape
    with torch.cuda.device(q.device):
        return kernels.library().mmt_mha_backward_row_splits(b, h, n, j)


def tf32_row_splits(kind: str, q: torch.Tensor, j: int) -> int:
    """Row splits the float32 backward's dk/dv pass takes for q (b, h, n,
    64) and j keys on q's card (at most MAX_ROW_SPLITS)."""
    b, h, n, _ = q.shape
    with torch.cuda.device(q.device):
        return kernels.library().mmt_tf32_backward_row_splits(b, h, n, j, int(kind == "mqa"))


def attention_backward_kernel(kind: str, q, k, v, bias, out, g, lse):
    """Launch the backward kernel; returns (dq, dk, dv) in the inputs' dtype."""
    bias = _check(kind, q, k, v, bias)
    kernels.require_cuda(kind, q, out, g)
    b, h, n, d = q.shape
    j = k.shape[-2]
    if tuple(out.shape) != tuple(q.shape) or tuple(g.shape) != tuple(q.shape) \
            or lse is None or tuple(lse.shape) != (b, h, n):
        raise ValueError(f"{kind}: output, cotangent or lse do not match q {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.float32:
        splits = tf32_row_splits(kind, q, j)
    else:
        splits = mha_row_splits(q, j) if kind == "mha" else 1
    scratch = torch.empty(backward_scratch_floats(kind, q.dtype, b, h, n, j, splits=splits),
                          device=q.device, dtype=torch.float32)
    kernels.launch(f"{kind}_backward", q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                   out.data_ptr(), g.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), scratch.data_ptr(), b, h, n, j, d,
                   kernels.DTYPE_CODES[q.dtype], kernels.current_stream(q), dtype=q.dtype)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# autograd                                                                     #
# --------------------------------------------------------------------------- #
_PLAIN = {"mqa": (mqa_plain, mqa_bwd_plain), "mha": (mha_plain, mha_bwd_plain)}


def _forward(ctx, kind, q, k, v, bias):
    if q.device.type == "cpu":
        out, lse = _PLAIN[kind][0](q, k, v, attn_bias=bias), None
    else:
        out, lse = attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
    ctx.kind = kind
    ctx.save_for_backward(q, k, v, bias, out, lse)
    return out


def _backward(ctx, g):
    q, k, v, bias, out, lse = ctx.saved_tensors
    with span("attention.backward"):
        if q.device.type == "cpu":
            dq, dk, dv = _PLAIN[ctx.kind][1](q, k, v, g, attn_bias=bias)
        else:
            dq, dk, dv = attention_backward_kernel(ctx.kind, q, k, v, bias, out,
                                                   g.contiguous(), lse)
    return dq, dk, dv, None  # the bias is mask-derived: zero cotangent


class MQAFlash(torch.autograd.Function):
    """Multi-query attention with the fused backward: q (b, h, n, 64)
    pre-scaled; k, v (b, j, 64); bias None or float32 (b, 1, 1, j)."""

    @staticmethod
    def forward(ctx, q, k, v, bias=None):
        return _forward(ctx, "mqa", q, k, v, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _backward(ctx, g)


class MHAFlash(torch.autograd.Function):
    """Multi-head attention with the fused backward: q (b, h, n, 64)
    pre-scaled; k, v (b, h, j, 64); bias None or float32 (b, 1, 1, j)."""

    @staticmethod
    def forward(ctx, q, k, v, bias=None):
        return _forward(ctx, "mha", q, k, v, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _backward(ctx, g)


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def mqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused multi-query attention: q (b, h, n, 64) pre-scaled; k, v (b, j, 64);
    optional float32 logit bias (b, 1, 1, j)."""
    if needs_grad(q, k, v):
        return MQAFlash.apply(q, k, v, bias)
    if q.device.type == "cpu":
        return mqa_plain(q, k, v, attn_bias=bias)
    return attention_forward_kernel("mqa", q, k, v, bias)[0]


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused multi-head attention: q (b, h, n, 64) pre-scaled; k, v (b, h, j, 64);
    optional float32 logit bias (b, 1, 1, j)."""
    if needs_grad(q, k, v):
        return MHAFlash.apply(q, k, v, bias)
    if q.device.type == "cpu":
        return mha_plain(q, k, v, attn_bias=bias)
    return attention_forward_kernel("mha", q, k, v, bias)[0]
