"""Attention dispatch (counterpart of ``minimagen_tpu/ops/attention.py``).

The U-Net's two attention flavours take already-projected q/k/v:

- multi-query self-attention: per-head queries, one K/V head shared by all;
- multi-head cross-attention over context tokens.

Every call goes to the fused kernels of ``flash_attention.py``. A mask (and,
for multi-query attention, a bias of one row per sample) becomes the
additive float32 logit bias of ``_mask_bias`` (0 keep, NEG_INF drop), which
the kernels take, as the JAX package's training graphs do
(``minimagen_tpu/ops/attention.py:109-117,248-251``). On the CPU a masked or
biased call runs the plain version as it is. The softmax is float32 whatever
the activation dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import NEG_INF, mha_flash, mha_plain, mqa_flash, mqa_plain

__all__ = ["NEG_INF", "mask_bias", "multi_query_attention", "multi_head_attention"]


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(b, j) boolean mask (True = keep) -> additive float32 logit bias
    (b, 1, 1, j). NEG_INF absorbs any finite logit in float32, so the
    softmax is the same as the where-replacement's."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask.bool(), zero, NEG_INF)[:, None, None, :]


def _kernel_bias(mask, attn_bias, b: int, j: int) -> Optional[torch.Tensor]:
    """The (b, 1, 1, j) float32 bias a kernel takes for `mask` and
    `attn_bias`; raises for a bias that varies over heads or queries."""
    bias = None if mask is None else mask_bias(mask)
    if attn_bias is not None:
        if attn_bias.dim() != 4 or attn_bias.shape[1] != 1 or attn_bias.shape[2] != 1:
            raise ValueError(f"the attention kernels take a bias of one row per sample "
                             f"(b, 1, 1, j), got {tuple(attn_bias.shape)}")
        extra = attn_bias.float().expand(b, 1, 1, j)
        bias = extra if bias is None else bias + extra
    return bias


def multi_query_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None,
                          attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (b, h, n, d) pre-scaled; shared k, v (b, j, d); mask (b, j) True=keep.
    Returns (b, h, n, d) in q's dtype."""
    if mask is None and attn_bias is None:
        return mqa_flash(q, k, v)
    if q.device.type == "cpu":
        return mqa_plain(q, k, v, mask=mask, attn_bias=attn_bias)
    return mqa_flash(q, k, v, _kernel_bias(mask, attn_bias, q.shape[0], k.shape[-2]))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (b, h, n, d) pre-scaled; k, v (b, h, j, d); mask (b, j) True=keep."""
    if mask is None:
        return mha_flash(q, k, v)
    if q.device.type == "cpu":
        return mha_plain(q, k, v, mask=mask)
    return mha_flash(q, k, v, mask_bias(mask))
