"""Fused attention forward: CUDA kernels and their plain PyTorch versions.

Counterpart of ``minimagen_tpu/ops/flash_attention.py``. Its Pallas kernels
``_mqa_kernel`` (:92) and ``_mha_kernel`` (:97) are ``csrc/flash_attention.cu``
here (design notes there). Beside each kernel is its plain version, which the
CPU tests hold against the JAX package and ``chip_smoke.py`` holds the kernel
against on the card.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels

NEG_INF = -1e30  # large negative for masking pre-softmax logits (f32-safe)


def _softmax_f32(sim: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last axis in float32; `mask` True = attend."""
    sim = sim.float()
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
    sim = torch.einsum("bhnd,bjd->bhnj", q.float(), k.float())
    if attn_bias is not None:
        sim = sim + attn_bias
    attn = _softmax_f32(sim, None if mask is None else mask[:, None, None, :])
    out = torch.einsum("bhnj,bjd->bhnd", attn.to(v.dtype), v)
    return out.to(q.dtype)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention: q (b, h, n, d) pre-scaled; k, v (b, h, j, d);
    `mask` (b, j) True = keep. Softmax in float32."""
    sim = torch.einsum("bhnd,bhjd->bhnj", q.float(), k.float())
    attn = _softmax_f32(sim, None if mask is None else mask[:, None, None, :])
    out = torch.einsum("bhnj,bhjd->bhnd", attn.to(v.dtype), v)
    return out.to(q.dtype)


def _launch_attention(kernel: str, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, kv_shape) -> torch.Tensor:
    b, h, n, d = q.shape
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError(f"{kernel}: k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if d != 64:
        raise ValueError(f"{kernel}: the kernel takes head_dim 64, got {d}")
    kernels.require_cuda(kernel, q, k, v)
    out = torch.empty_like(q)
    kernels.launch(kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, h, n, kv_shape[-2], d, kernels.DTYPE_CODES[q.dtype],
                   kernels.current_stream(q))
    return out


def mqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused multi-query attention: q (b, h, n, 64) pre-scaled; k, v (b, j, 64)."""
    if q.device.type == "cpu":
        return mqa_plain(q, k, v)
    b, _, _, d = q.shape
    return _launch_attention("mqa_forward", q, k, v, (b, k.shape[1], d))


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused multi-head attention: q (b, h, n, 64) pre-scaled; k, v (b, h, j, 64)."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v)
    b, h, _, d = q.shape
    return _launch_attention("mha_forward", q, k, v, (b, h, k.shape[2], d))
