"""Image resizing for cascade conditioning (counterpart of
``minimagen_tpu/ops/resize.py``): the exact resize_right path only."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .resize_right import resize as _resize_right


def resize_image_to(image: torch.Tensor, target_image_size: int,
                    clamp_range: Optional[Tuple[float, float]] = None,
                    pad_mode: str = "reflect") -> torch.Tensor:
    """Resize (b, h, w, c) NHWC images to a square `target_image_size`
    (scalar scale ``target / h`` for both dims, like the reference)."""
    h, w = image.shape[1:3]
    if h == target_image_size and w == target_image_size:
        return image
    out = _resize_right(image, scale_factors=target_image_size / h, dims=(1, 2),
                        pad_mode=pad_mode)
    if clamp_range is not None:
        out = out.clamp(clamp_range[0], clamp_range[1])
    return out
