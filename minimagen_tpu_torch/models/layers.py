"""U-Net building blocks (counterpart of ``minimagen_tpu/models/layers.py``).

Activations are NHWC, as in the JAX package; a convolution views its input
as NCHW with channels-last strides, so no copy is made around it. Module and
parameter names are the flax names (``kernel`` becomes ``weight``), so a JAX
parameter tree maps onto a ``state_dict`` by name (``checkpoint.py``).

Parameters may be held in another dtype than the activations (float32
master weights for training, as the JAX package keeps): every module casts
its parameters to the activation dtype at use, as flax does with ``dtype=``.
With float32 parameters that hold bfloat16 values, a bfloat16 forward is
bit-equal to one with bfloat16 parameters. Initialisation follows flax:
dense and convolution kernels ``lecun_normal`` (a normal truncated at two
standard deviations, variance 1/fan_in), biases zeros, norms ones and zeros,
learned null embeddings ``normal(1.0)``. Normalisation statistics and
softmaxes are float32 whatever the activation dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention, multi_query_attention
from ..ops.group_norm import group_norm_silu
from ..ops.stem_conv import cross_embed_conv

ATTN_DIM_HEAD = 64
NUM_TIME_TOKENS = 2
RESNET_GROUPS = 8

ScaleShift = Optional[Tuple[torch.Tensor, torch.Tensor]]


# flax's lecun_normal: truncated_normal(-2, 2) scaled by sqrt(1 / fan_in) over
# the standard deviation of that truncated normal
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    std = fan_in ** -0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def _cast(p: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    return None if p is None else p.to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` with flax's init that casts its parameters to the
    input's dtype at use."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight, self.in_features)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) with flax's init that casts its parameters to
    the input's dtype at use."""

    def reset_parameters(self) -> None:
        kh, kw = self.kernel_size
        lecun_normal_(self.weight, self.in_channels // self.groups * kh * kw)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv(Conv2d):
    """:class:`Conv2d` on NHWC activations."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _norm_f32(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over the last axis, stats in float32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class LayerNorm(nn.Module):
    """Scale-only LayerNorm over the trailing axis."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_f32(x, self.eps) * self.gamma.to(x.dtype)


class ChanLayerNorm(nn.Module):
    """Channel LayerNorm; in NHWC the same normalisation as LayerNorm."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_f32(x, self.eps) * self.g.to(x.dtype)


class AffineLayerNorm(nn.Module):
    """LayerNorm with learned scale and bias."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_f32(x, self.eps) * self.gamma.to(x.dtype) + self.beta.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with float32 statistics, optionally fused with the Block's
    time scale-shift and SiLU (``ops.group_norm.group_norm_silu``)."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, scale_shift: ScaleShift = None,
                silu: bool = False) -> torch.Tensor:
        return group_norm_silu(x, self.scale, self.bias, groups=self.groups, eps=self.eps,
                               scale_shift=scale_shift, silu=silu)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, dtype=torch.float32) -> torch.Tensor:
    """(b,) positions -> (b, dim) [sin | cos] embedding."""
    half_dim = dim // 2
    emb_scale = math.log(10000) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb_scale)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1).to(dtype)


def _pad_mask_front(mask: torch.Tensor, pad: int) -> torch.Tensor:
    """Prepend `pad` always-attendable (True) positions to a (b, j) mask."""
    ones = torch.ones(mask.shape[0], pad, dtype=torch.bool, device=mask.device)
    return torch.cat([ones, mask.bool()], dim=1)


class Attention(nn.Module):
    """Multi-query self-attention: per-head queries, one K/V head shared by
    all heads, a learned null K/V prepended, optional extra context K/V."""

    def __init__(self, dim: int, dim_head: int = ATTN_DIM_HEAD, heads: int = 8,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner_dim = dim_head * heads
        self.norm = LayerNorm(dim)
        self.to_q = Dense(dim, inner_dim, bias=False)
        self.to_kv = Dense(dim, dim_head * 2, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        if context_dim is not None:
            self.context_norm = AffineLayerNorm(context_dim)
            self.to_context = Dense(context_dim, dim_head * 2)
        self.to_out = Dense(inner_dim, dim, bias=False)
        self.out_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        x = self.norm(x)
        q = self.to_q(x).reshape(b, n, h, dh).transpose(1, 2) * dh ** -0.5
        k, v = self.to_kv(x).chunk(2, dim=-1)
        null_k, null_v = self.null_kv.to(k.dtype)
        k = torch.cat([null_k.expand(b, 1, dh), k], dim=-2)
        v = torch.cat([null_v.expand(b, 1, dh), v], dim=-2)
        if context is not None:
            ck, cv = self.to_context(self.context_norm(context)).chunk(2, dim=-1)
            k = torch.cat([ck, k], dim=-2)
            v = torch.cat([cv, v], dim=-2)
        if mask is not None:
            mask = _pad_mask_front(mask, k.shape[-2] - mask.shape[-1])
        out = multi_query_attention(q.contiguous(), k, v, mask=mask, attn_bias=attn_bias)
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        return self.out_norm(self.to_out(out))


class CrossAttention(nn.Module):
    """Multi-head cross-attention over context tokens with a per-head
    learned null K/V."""

    def __init__(self, dim: int, context_dim: Optional[int] = None,
                 dim_head: int = ATTN_DIM_HEAD, heads: int = 8, norm_context: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner_dim = dim_head * heads
        context_dim = dim if context_dim is None else context_dim
        self.norm = LayerNorm(dim)
        if norm_context:
            self.norm_context = LayerNorm(context_dim)
        self.to_q = Dense(dim, inner_dim, bias=False)
        self.to_kv = Dense(context_dim, inner_dim * 2, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_out = Dense(inner_dim, dim, bias=False)
        self.out_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        x = self.norm(x)
        if hasattr(self, "norm_context"):
            context = self.norm_context(context)
        q = self.to_q(x).reshape(b, n, h, dh).transpose(1, 2)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        j = k.shape[1]
        k = k.reshape(b, j, h, dh).transpose(1, 2)
        v = v.reshape(b, j, h, dh).transpose(1, 2)
        null_k, null_v = self.null_kv.to(k.dtype)
        k = torch.cat([null_k.expand(b, h, 1, dh), k], dim=-2)
        v = torch.cat([null_v.expand(b, h, 1, dh), v], dim=-2)
        q = q * dh ** -0.5
        if mask is not None:
            mask = _pad_mask_front(mask, 1)
        out = multi_head_attention(q.contiguous(), k, v, mask=mask)
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        return self.out_norm(self.to_out(out))


class Block(nn.Module):
    """GroupNorm -> (scale-shift) -> SiLU -> 3x3 conv."""

    def __init__(self, dim: int, dim_out: int, groups: int = RESNET_GROUPS, norm: bool = True):
        super().__init__()
        if norm:
            self.groupnorm = GroupNorm(groups, dim)
        self.project = Conv(dim, dim_out, 3, padding=1)

    def forward(self, x: torch.Tensor, scale_shift: ScaleShift = None) -> torch.Tensor:
        if hasattr(self, "groupnorm"):
            x = self.groupnorm(x, scale_shift=scale_shift, silu=True)
        else:
            if scale_shift is not None:
                scale, shift = scale_shift
                x = x * (scale + 1.0) + shift
            x = F.silu(x)
        return self.project(x)


class ResnetBlock(nn.Module):
    """Two Blocks with a time scale-shift on the second, an optional
    cross-attention on the flattened pixels between them, and a 1x1-conv
    residual when the channel count changes."""

    def __init__(self, dim: int, dim_out: int, cond_dim: Optional[int] = None,
                 time_cond_dim: Optional[int] = None, groups: int = RESNET_GROUPS):
        super().__init__()
        if time_cond_dim is not None:
            self.time_mlp = Dense(time_cond_dim, dim_out * 2)
        self.block1 = Block(dim, dim_out, groups=groups)
        if cond_dim is not None:
            self.cross_attn = CrossAttention(dim=dim_out, context_dim=cond_dim)
        self.block2 = Block(dim_out, dim_out, groups=groups)
        if dim != dim_out:
            self.res_conv = Conv(dim, dim_out, 1)

    def forward(self, x: torch.Tensor, time_emb: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        scale_shift = None
        if hasattr(self, "time_mlp") and time_emb is not None:
            t = self.time_mlp(F.silu(time_emb))[:, None, None, :]
            scale_shift = t.chunk(2, dim=-1)
        hid = self.block1(x)
        if hasattr(self, "cross_attn"):
            if cond is None:
                raise ValueError("ResnetBlock configured with cond_dim requires cond tokens")
            c = hid.shape[-1]
            hid = hid + self.cross_attn(hid.reshape(b, h * w, c), context=cond).reshape(b, h, w, c)
        hid = self.block2(hid, scale_shift=scale_shift)
        return hid + (self.res_conv(x) if hasattr(self, "res_conv") else x)


class ChanFeedForward(nn.Module):
    """ChanLayerNorm -> 1x1 expand -> exact GELU -> ChanLayerNorm -> 1x1 project."""

    def __init__(self, dim: int, mult: int = 2):
        super().__init__()
        hidden_dim = int(dim * mult)
        self.norm_in = ChanLayerNorm(dim)
        self.expand = Dense(dim, hidden_dim, bias=False)
        self.norm_mid = ChanLayerNorm(hidden_dim)
        self.project = Dense(hidden_dim, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.expand(self.norm_in(x)))
        return self.project(self.norm_mid(x))


class TransformerBlock(nn.Module):
    """Residual multi-query self-attention over the pixels, then a residual
    channel feed-forward."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, ff_mult: int = 2,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn = Attention(dim=dim, heads=heads, dim_head=dim_head, context_dim=context_dim)
        self.ff = ChanFeedForward(dim=dim, mult=ff_mult)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x + self.attn(x.reshape(b, h * w, c), context=context).reshape(b, h, w, c)
        return x + self.ff(x)


class CrossEmbedLayer(nn.Module):
    """Inception-style stem: parallel convs of several kernel sizes with
    geometrically split channel counts, concatenated; a stride-1 stem runs
    as one space-to-depth conv (``ops/stem_conv.py``)."""

    def __init__(self, dim_in: int, kernel_sizes: Sequence[int], dim_out: Optional[int] = None,
                 stride: int = 2):
        super().__init__()
        if any((k % 2) != (stride % 2) for k in kernel_sizes):
            raise ValueError("kernel sizes must share the stride's parity")
        dim_out = dim_in if dim_out is None else dim_out
        self.stride = stride
        kernel_sizes = sorted(kernel_sizes)
        dim_scales = [int(dim_out / (2 ** i)) for i in range(1, len(kernel_sizes))]
        dim_scales = [*dim_scales, dim_out - sum(dim_scales)]
        self.num_convs = len(kernel_sizes)
        for i, (kernel, dim_scale) in enumerate(zip(kernel_sizes, dim_scales)):
            self.add_module(f"conv_{i}", Conv2d(dim_in, dim_scale, kernel, stride=stride,
                                                padding=(kernel - stride) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, f"conv_{i}") for i in range(self.num_convs)]
        return cross_embed_conv(x, [c.weight for c in convs], [c.bias for c in convs],
                                stride=self.stride)


class Downsample(nn.Module):
    """4x4 stride-2 conv halving the spatial dims."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = Conv(dim_in, dim_out, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample + 3x3 conv."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = Conv(dim_in, dim_out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
        return self.conv(x)


class ParallelSum(nn.Module):
    """Sum of a 3x3 conv and a 1x1 conv."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv3 = Conv(dim_in, dim_out, 3, padding=1)
        self.conv1 = Conv(dim_in, dim_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(x) + self.conv1(x)
