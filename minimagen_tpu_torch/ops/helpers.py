"""Functional helpers (counterpart of ``minimagen_tpu/ops/helpers.py``).

Randomness takes an explicit ``torch.Generator`` where the JAX package takes
a ``jax.random`` key; the two give different numbers from the same seed.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch


def exists(val: Any) -> bool:
    return val is not None


def default(val: Any, d: Any) -> Any:
    """`val` unless it is None; then `d` (or `d()` if callable)."""
    if exists(val):
        return val
    return d() if callable(d) else d


def identity(t, *args, **kwargs):
    return t


def maybe(fn: Callable) -> Callable:
    """`fn` applied only to an input that is not None (reference
    helpers.py:81-95)."""

    def inner(x):
        return x if not exists(x) else fn(x)

    return inner


def log(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Natural log of `t` clamped below at `eps` (reference helpers.py:74-78)."""
    return torch.log(t.clamp(min=eps))


def cast_tuple(val: Any, length: Optional[int] = None) -> tuple:
    """Casts input to a tuple, repeating scalars to `length`."""
    if isinstance(val, list):
        val = tuple(val)
    output = val if isinstance(val, tuple) else ((val,) * default(length, 1))
    if exists(length) and len(output) != length:
        raise ValueError(f"tuple of length {len(output)} != {length}")
    return output


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep scalars from the (T,) buffer `a` at the (b,)
    integer timesteps `t`, shaped (b, 1, ..., 1) with `ndim` dims."""
    out = a[t.long()]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def right_pad_dims_to(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pad `t` with trailing singleton dims up to `x.ndim`."""
    padding_dims = x.ndim - t.ndim
    if padding_dims <= 0:
        return t
    return t.reshape(*t.shape, *((1,) * padding_dims))


def normalize_neg_one_to_one(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return img * 2.0 - 1.0


def unnormalize_zero_to_one(normed_img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return (normed_img + 1.0) * 0.5


def prob_mask_like(shape: Sequence[int], prob: float, *,
                   generator: Optional[torch.Generator] = None,
                   device="cuda") -> torch.Tensor:
    """Boolean mask with `prob` probability of True, drawn from `generator`.
    prob 0 and 1 draw nothing."""
    if prob == 1:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if prob == 0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return torch.rand(shape, generator=generator, device=device) < prob


def abs_quantile_bisect(x: torch.Tensor, q: float, iters: int = 22) -> torch.Tensor:
    """Per-row quantile of ``|x|`` by CDF bisection.

    ``x`` (b, n); returns (b,) float32 ``s`` with ``mean(|x| <= s) >= q``,
    within ``max|x| / 2**iters`` of the smallest such value. Used for the
    dynamic-thresholding scale of large images, as the JAX package does.
    """
    ax = x.abs().float()
    hi = ax.amax(dim=-1)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        done = (ax <= mid[:, None]).float().mean(dim=-1) >= q
        lo, hi = torch.where(done, lo, mid), torch.where(done, mid, hi)
    return hi
