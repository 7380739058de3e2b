"""The work a module does, reckoned from the shapes that enter it.

Operations are the matrix-product FLOPs of the benchmark's own plain
reference modules (``portbench/reference/unet.py``) at those shapes, counted
by ``torch.utils.flop_counter.FlopCounterMode`` on the ``meta`` device, so a
count is the same whatever kernel the program runs. Bytes count each input,
weight and output once. Nothing here reads what the program launches.

The bound of a call is the larger of FLOPs / the bf16 dense peak and bytes /
the memory peak of one NVIDIA H100 SXM (NVIDIA's data sheet); ``bound``
says which of the two it was.
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import unet as ref

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
PEAK_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM


def counted_flops(fn, *args, **kwargs) -> int:
    """Matrix-product FLOPs of ``fn(*args, **kwargs)`` on meta tensors."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


@functools.lru_cache(maxsize=None)
def _meta_unet(cfg_items: Tuple) -> ref.Unet:
    with torch.device("meta"):
        return ref.Unet(_thaw(cfg_items))


def _freeze(d: Dict) -> Tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in d.items()))


def _thaw(items: Tuple) -> Dict:
    return dict(items)


@functools.lru_cache(maxsize=None)
def _unet_flops(cfg_items: Tuple, rows: int, size: int, text_len: int) -> int:
    cfg = _thaw(cfg_items)
    net = _meta_unet(cfg_items)
    lowres = _meta(rows, size, size, 3) if cfg["lowres_cond"] else None
    return counted_flops(
        net, _meta(rows, size, size, 3), torch.zeros(rows, dtype=torch.long, device="meta"),
        text_embeds=_meta(rows, text_len, cfg["text_embed_dim"]),
        text_mask=torch.ones(rows, text_len, dtype=torch.bool, device="meta"),
        text_keep_mask=torch.ones(rows, dtype=torch.bool, device="meta"),
        lowres_cond_img=lowres,
        lowres_noise_times=torch.zeros(rows, dtype=torch.long, device="meta"))


def unet_forward_flops(unet_cfg: Dict, rows: int, size: int, text_len: int) -> int:
    """FLOPs of one U-Net forward over `rows` images of `size` pixels."""
    return _unet_flops(_freeze(unet_cfg), rows, size, text_len)


@functools.lru_cache(maxsize=None)
def attention_flops(kind: str, dim: int, rows: int, n: int,
                    context: Optional[Tuple[int, int]] = None, heads: int = 8) -> int:
    """FLOPs of one ``Attention`` (self, multi-query) or ``CrossAttention``
    module call: `rows` x `n` tokens of width `dim`, `context` (tokens,
    width) for cross-attention."""
    with torch.device("meta"):
        if kind == "self":
            module = ref.Attention(dim, heads=heads)
            return counted_flops(module, _meta(rows, n, dim))
        module = ref.CrossAttention(dim, context[1], heads=heads)
        return counted_flops(module, _meta(rows, n, dim), _meta(rows, *context))


def bound_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds on the card, "flops" or "bytes", whichever bounds)."""
    f, b = flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (f, "flops") if f >= b else (b, "bytes")


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def attention_bound(calls: List[Tuple]) -> Tuple[float, str]:
    """Summed bound seconds of attention module calls, each given as
    (kind, x shape (b, n, dim), context shape (j, width) or None, activation
    itemsize, parameter bytes, heads, has context norm), and which bound
    holds most of it. Bytes: x in, the output (x's shape) out, the context
    in, every parameter once."""
    total, by = 0.0, Counter()
    for (kind, x, ctx, itemsize, pbytes, heads, _), count in Counter(calls).items():
        b, n, dim = x
        flops = attention_flops(kind, dim, b, n, ctx, heads)
        nbytes = 2 * _numel(x) * itemsize + (b * _numel(ctx) * itemsize if ctx else 0) + pbytes
        sec, which = bound_seconds(flops, nbytes)
        total += count * sec
        by[which] += count * sec
    return total, by.most_common(1)[0][0] if by else "none"


def group_norm_bound(calls: List[Tuple]) -> Tuple[float, str]:
    """Summed bound seconds of GroupNorm module calls, each given as
    (x shape (b, h, w, c), activation itemsize, parameter bytes, with a
    time scale-shift): x in, y out, the (b, c) scale and shift in, the
    parameters once; no matrix product."""
    total = 0.0
    for (x, itemsize, pbytes, ss), count in Counter(calls).items():
        nbytes = 2 * _numel(x) * itemsize + pbytes + (2 * x[0] * x[-1] * itemsize if ss else 0)
        total += count * bound_seconds(0, nbytes)[0]
    return total, "bytes"
