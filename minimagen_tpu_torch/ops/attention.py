"""Attention dispatch (counterpart of ``minimagen_tpu/ops/attention.py``).

The U-Net's two attention flavours take already-projected q/k/v:

- multi-query self-attention: per-head queries, one K/V head shared by all;
- multi-head cross-attention over context tokens.

Unmasked calls (the U-Net's only kind) go to the fused kernels of
``flash_attention.py``; masked or biased calls run the plain versions. The
softmax is float32 whatever the activation dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import NEG_INF, mha_flash, mha_plain, mqa_flash, mqa_plain

__all__ = ["NEG_INF", "multi_query_attention", "multi_head_attention"]


def multi_query_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None,
                          attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (b, h, n, d) pre-scaled; shared k, v (b, j, d); mask (b, j) True=keep.
    Returns (b, h, n, d) in q's dtype."""
    if mask is None and attn_bias is None:
        return mqa_flash(q, k, v)
    return mqa_plain(q, k, v, mask=mask, attn_bias=attn_bias)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (b, h, n, d) pre-scaled; k, v (b, h, j, d); mask (b, j) True=keep."""
    if mask is None:
        return mha_flash(q, k, v)
    return mha_plain(q, k, v, mask=mask)
