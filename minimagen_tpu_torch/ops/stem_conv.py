"""The U-Net's CrossEmbed stem (counterpart of
``minimagen_tpu/ops/stem_conv.py::cross_embed_reference``).

Parallel convolutions with kernel sizes 3/7/15, concatenated on channels.
The JAX package computes this outside Pallas, so here it is ``F.conv2d``.
Its space-to-depth rewrite and depth-to-space kernel are not ported (see
ROADMAP).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def cross_embed_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[Optional[torch.Tensor]],
                          stride: int) -> torch.Tensor:
    """x (b, h, w, c) NHWC; weights OIHW. Returns NHWC."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
    fmaps = []
    for w, b in zip(weights, biases):
        pad = (w.shape[-1] - stride) // 2
        fmaps.append(F.conv2d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                              stride=stride, padding=pad))
    return torch.cat(fmaps, dim=1).permute(0, 2, 3, 1)
