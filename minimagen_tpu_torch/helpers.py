"""Import-path shim for ``minimagen.helpers`` (the reference's helpers.py)."""
from .ops.helpers import (  # noqa: F401
    cast_tuple,
    default,
    exists,
    extract,
    identity,
    log,
    maybe,
    normalize_neg_one_to_one,
    prob_mask_like,
    right_pad_dims_to,
    unnormalize_zero_to_one,
)
from .ops.resize import resize_image_to  # noqa: F401
