"""The plain reference U-Net: MinImagen's conditional U-Net in plain PyTorch.

A frozen copy of the port's module tree (same module and parameter names,
same shapes, NHWC activations), with every fused or hand-written piece in
its textbook form: attention as two einsums and a float32 softmax, GroupNorm
as mean and variance over the group, the stem as three convolutions
concatenated. It imports nothing of the program. It runs in float32; the
benchmark turns TF32 off before it runs.

``set_low_precision(model, fn)`` routes the inputs and weights of every
dense layer and convolution through ``fn`` (the control: a lower precision
than the configuration states, see ``portbench/compare.py``; or the weights
alone, for the look behind a reading in ``portbench/calibrate.py``). The rounding
passes gradients straight through, so the control also trains.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ATTN_DIM_HEAD = 64
NUM_TIME_TOKENS = 2
RESNET_GROUPS = 8
MAX_TEXT_LEN = 256
NEG_INF = -1e30

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _rounded(x: torch.Tensor, fn: Rounding) -> torch.Tensor:
    if fn is None:
        return x
    return x + (fn(x) - x).detach()  # straight-through


class Dense(nn.Linear):
    lowp: Rounding = None
    lowp_inputs = True

    def forward(self, x):
        return F.linear(_rounded(x, self.lowp if self.lowp_inputs else None),
                        _rounded(self.weight, self.lowp), self.bias)


class Conv2d(nn.Conv2d):
    """NCHW convolution (the stem's)."""
    lowp: Rounding = None
    lowp_inputs = True

    def forward(self, x):
        return self._conv_forward(_rounded(x, self.lowp if self.lowp_inputs else None),
                                  _rounded(self.weight, self.lowp), self.bias)


class Conv(Conv2d):
    """Convolution on NHWC activations."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _norm(x, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return _norm(x) * self.gamma


class ChanLayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return _norm(x) * self.g


class AffineLayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return _norm(x) * self.gamma + self.beta


class GroupNorm(nn.Module):
    def __init__(self, groups, dim, eps=1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, scale_shift=None, silu=False):
        b, h, w, c = x.shape
        xg = x.reshape(b, h, w, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
        out = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        out = out * self.scale + self.bias
        if scale_shift is not None:
            scale, shift = scale_shift
            out = out * (scale + 1.0) + shift
        return F.silu(out) if silu else out


def sinusoidal_pos_emb(t, dim):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([args.sin(), args.cos()], dim=-1)


def attention(q, k, v, mask=None):
    """q (b, h, n, d) pre-scaled; k, v (b, j, d) shared or (b, h, j, d);
    mask (b, j) True = keep."""
    kv = "bjd" if k.dim() == 3 else "bhjd"
    sim = torch.einsum(f"bhnd,{kv}->bhnj", q, k)
    if mask is not None:
        sim = sim.masked_fill(~mask[:, None, None, :], NEG_INF)
    return torch.einsum(f"bhnj,{kv}->bhnd", sim.softmax(dim=-1), v)


def _pad_mask_front(mask, pad):
    return torch.cat([torch.ones(mask.shape[0], pad, dtype=torch.bool, device=mask.device),
                      mask.bool()], dim=1)


class Attention(nn.Module):
    """Multi-query self-attention with a learned null K/V."""

    def __init__(self, dim, dim_head=ATTN_DIM_HEAD, heads=8, context_dim=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = LayerNorm(dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(dim, dim_head * 2, bias=False)
        self.null_kv = nn.Parameter(torch.zeros(2, dim_head))
        if context_dim is not None:
            self.context_norm = AffineLayerNorm(context_dim)
            self.to_context = Dense(context_dim, dim_head * 2)
        self.to_out = Dense(inner, dim, bias=False)
        self.out_norm = LayerNorm(dim)

    def forward(self, x, context=None):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        x = self.norm(x)
        q = self.to_q(x).reshape(b, n, h, dh).transpose(1, 2) * dh ** -0.5
        k, v = self.to_kv(x).chunk(2, dim=-1)
        k = torch.cat([self.null_kv[0].expand(b, 1, dh), k], dim=-2)
        v = torch.cat([self.null_kv[1].expand(b, 1, dh), v], dim=-2)
        if context is not None:
            ck, cv = self.to_context(self.context_norm(context)).chunk(2, dim=-1)
            k, v = torch.cat([ck, k], dim=-2), torch.cat([cv, v], dim=-2)
        out = attention(q, k, v).transpose(1, 2).reshape(b, n, h * dh)
        return self.out_norm(self.to_out(out))


class CrossAttention(nn.Module):
    """Multi-head cross-attention over the context with a per-head null K/V."""

    def __init__(self, dim, context_dim, dim_head=ATTN_DIM_HEAD, heads=8):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = LayerNorm(dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(context_dim, inner * 2, bias=False)
        self.null_kv = nn.Parameter(torch.zeros(2, dim_head))
        self.to_out = Dense(inner, dim, bias=False)
        self.out_norm = LayerNorm(dim)

    def forward(self, x, context, mask=None):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        x = self.norm(x)
        q = self.to_q(x).reshape(b, n, h, dh).transpose(1, 2) * dh ** -0.5
        k, v = self.to_kv(context).chunk(2, dim=-1)
        j = k.shape[1]
        k = k.reshape(b, j, h, dh).transpose(1, 2)
        v = v.reshape(b, j, h, dh).transpose(1, 2)
        k = torch.cat([self.null_kv[0].expand(b, h, 1, dh), k], dim=-2)
        v = torch.cat([self.null_kv[1].expand(b, h, 1, dh), v], dim=-2)
        if mask is not None:
            mask = _pad_mask_front(mask, 1)
        out = attention(q, k, v, mask).transpose(1, 2).reshape(b, n, h * dh)
        return self.out_norm(self.to_out(out))


class Block(nn.Module):
    """GroupNorm -> (scale-shift) -> SiLU -> 3x3 conv."""

    def __init__(self, dim, dim_out, groups=RESNET_GROUPS):
        super().__init__()
        self.groupnorm = GroupNorm(groups, dim)
        self.project = Conv(dim, dim_out, 3, padding=1)

    def forward(self, x, scale_shift=None):
        return self.project(self.groupnorm(x, scale_shift, silu=True))


class ResnetBlock(nn.Module):
    def __init__(self, dim, dim_out, cond_dim=None, time_cond_dim=None, groups=RESNET_GROUPS):
        super().__init__()
        if time_cond_dim is not None:
            self.time_mlp = Dense(time_cond_dim, dim_out * 2)
        self.block1 = Block(dim, dim_out, groups)
        if cond_dim is not None:
            self.cross_attn = CrossAttention(dim_out, cond_dim)
        self.block2 = Block(dim_out, dim_out, groups)
        if dim != dim_out:
            self.res_conv = Conv(dim, dim_out, 1)

    def forward(self, x, time_emb=None, cond=None):
        b, h, w, _ = x.shape
        scale_shift = None
        if hasattr(self, "time_mlp") and time_emb is not None:
            scale_shift = self.time_mlp(F.silu(time_emb))[:, None, None, :].chunk(2, dim=-1)
        hid = self.block1(x)
        if hasattr(self, "cross_attn"):
            c = hid.shape[-1]
            hid = hid + self.cross_attn(hid.reshape(b, h * w, c), cond).reshape(b, h, w, c)
        hid = self.block2(hid, scale_shift)
        return hid + (self.res_conv(x) if hasattr(self, "res_conv") else x)


class ChanFeedForward(nn.Module):
    def __init__(self, dim, mult=2):
        super().__init__()
        self.norm_in = ChanLayerNorm(dim)
        self.expand = Dense(dim, dim * mult, bias=False)
        self.norm_mid = ChanLayerNorm(dim * mult)
        self.project = Dense(dim * mult, dim, bias=False)

    def forward(self, x):
        return self.project(self.norm_mid(F.gelu(self.expand(self.norm_in(x)))))


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads=8, dim_head=ATTN_DIM_HEAD):
        super().__init__()
        self.attn = Attention(dim, heads=heads, dim_head=dim_head)
        self.ff = ChanFeedForward(dim)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x + self.attn(x.reshape(b, h * w, c)).reshape(b, h, w, c)
        return x + self.ff(x)


class CrossEmbedLayer(nn.Module):
    """Stride-1 convolutions of kernel 3, 7 and 15 concatenated on channels."""

    def __init__(self, dim_in, dim_out, kernel_sizes=(3, 7, 15)):
        super().__init__()
        scales = [int(dim_out / (2 ** i)) for i in range(1, len(kernel_sizes))]
        scales.append(dim_out - sum(scales))
        self.num_convs = len(kernel_sizes)
        for i, (k, s) in enumerate(zip(sorted(kernel_sizes), scales)):
            self.add_module(f"conv_{i}", Conv2d(dim_in, s, k, padding=(k - 1) // 2))

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)
        return torch.cat([getattr(self, f"conv_{i}")(xc) for i in range(self.num_convs)],
                         dim=1).permute(0, 2, 3, 1)


class Downsample(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.conv = Conv(dim_in, dim_out, 4, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.conv = Conv(dim_in, dim_out, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class ParallelSum(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.conv3 = Conv(dim_in, dim_out, 3, padding=1)
        self.conv1 = Conv(dim_in, dim_out, 1)

    def forward(self, x):
        return self.conv3(x) + self.conv1(x)


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def layer_params(cfg: Dict) -> List[Tuple]:
    """Per resolution: ((dim_in, dim_out), blocks, attn, cross_attn)."""
    dims = [cfg["dim"], *(cfg["dim"] * m for m in cfg["dim_mults"])]
    n = len(dims) - 1
    return list(zip(zip(dims[:-1], dims[1:]), _tuple(cfg["num_resnet_blocks"], n),
                    _tuple(cfg["layer_attns"], n), _tuple(cfg["layer_cross_attns"], n)))


class Unet(nn.Module):
    """The U-Net of a config dict with MinImagen's keys (``dim``,
    ``dim_mults``, ``num_resnet_blocks``, ``layer_attns``,
    ``layer_cross_attns``, ``attn_heads``, ``memory_efficient``,
    ``attend_at_middle``) plus ``lowres_cond`` and ``text_embed_dim``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        dim, heads = cfg["dim"], cfg.get("attn_heads", 8)
        lowres = cfg["lowres_cond"]
        cond_dim = dim
        tcd = dim * 4 * (2 if lowres else 1)
        for prefix in ("to_", "to_lowres_") if lowres else ("to_",):
            self.add_module(f"{prefix}time_hiddens", Dense(dim, tcd))
            self.add_module(f"{prefix}time_cond", Dense(tcd, tcd))
            self.add_module(f"{prefix}time_tokens", Dense(tcd, cond_dim * NUM_TIME_TOKENS))
        self.text_to_cond = Dense(cfg["text_embed_dim"], cond_dim)
        self.null_text_embed = nn.Parameter(torch.zeros(1, MAX_TEXT_LEN, cond_dim))
        self.text_nonattn_norm = AffineLayerNorm(cond_dim)
        self.text_nonattn_dense1 = Dense(cond_dim, tcd)
        self.text_nonattn_dense2 = Dense(tcd, tcd)
        self.null_text_hidden = nn.Parameter(torch.zeros(1, tcd))
        self.norm_cond = AffineLayerNorm(cond_dim)
        self.init_conv = CrossEmbedLayer(3 * (2 if lowres else 1), dim)

        lp = layer_params(cfg)
        last, mem = len(lp) - 1, cfg["memory_efficient"]
        for i, ((din, dout), nb, attn, cross) in enumerate(lp):
            cur = dout if mem else din
            if mem:
                self.add_module(f"down{i}_pre", Downsample(din, dout))
            self.add_module(f"down{i}_init_block", ResnetBlock(
                cur, cur, cond_dim if cross else None, tcd))
            for j in range(nb):
                self.add_module(f"down{i}_block{j}", ResnetBlock(cur, cur, None, tcd))
            if attn:
                self.add_module(f"down{i}_attn", TransformerBlock(cur, heads))
            if not mem:
                self.add_module(f"down{i}_post", (ParallelSum if i == last else Downsample)(din, dout))
        mid = dim * cfg["dim_mults"][-1]
        self.mid_block1 = ResnetBlock(mid, mid, cond_dim, tcd)
        if cfg["attend_at_middle"]:
            self.mid_attn = Attention(mid, heads=heads)
        self.mid_block2 = ResnetBlock(mid, mid, cond_dim, tcd)
        for r, ((din, dout), nb, attn, cross) in enumerate(reversed(lp)):
            skip = dout if mem else din
            self.add_module(f"up{r}_init_block", ResnetBlock(
                dout + skip, dout, cond_dim if cross else None, tcd))
            for j in range(nb):
                self.add_module(f"up{r}_block{j}", ResnetBlock(dout + skip, dout, None, tcd))
            if attn:
                self.add_module(f"up{r}_attn", TransformerBlock(dout, heads))
            if r != last or mem:
                self.add_module(f"up{r}_upsample", Upsample(dout, din))
        self.final_res_block = ResnetBlock(dim, dim, None, tcd)
        self.final_conv = Conv(dim, 3, 3, padding=1)

    def _time(self, times, prefix):
        hid = F.silu(getattr(self, f"{prefix}time_hiddens")(
            sinusoidal_pos_emb(times, self.cfg["dim"])))
        tokens = getattr(self, f"{prefix}time_tokens")(hid)
        return (getattr(self, f"{prefix}time_cond")(hid),
                tokens.reshape(tokens.shape[0], NUM_TIME_TOKENS, -1))

    def forward(self, x, time, *, text_embeds, text_mask, text_keep_mask,
                lowres_cond_img=None, lowres_noise_times=None):
        """Noise predicted in x (b, s, s, 3) at integer times (b,)."""
        t, time_tokens = self._time(time, "to_")
        if self.cfg["lowres_cond"]:
            lt, ltok = self._time(lowres_noise_times, "to_lowres_")
            t, time_tokens = t + lt, torch.cat([time_tokens, ltok], dim=-2)
        b = x.shape[0]
        tokens = self.text_to_cond(text_embeds)[:, :MAX_TEXT_LEN]
        pad = MAX_TEXT_LEN - tokens.shape[1]
        tokens = F.pad(tokens, (0, 0, 0, pad))
        mask = torch.cat([text_mask.bool(), text_mask.new_zeros(b, pad, dtype=torch.bool)], 1)
        keep = mask[:, :MAX_TEXT_LEN, None] & text_keep_mask[:, None, None]
        tokens = torch.where(keep, tokens, self.null_text_embed)
        hid = self.text_nonattn_dense2(F.silu(self.text_nonattn_dense1(
            self.text_nonattn_norm(tokens.mean(dim=-2)))))
        t = t + torch.where(text_keep_mask[:, None], hid, self.null_text_hidden)
        c = self.norm_cond(torch.cat([time_tokens, tokens], dim=-2))

        lp = layer_params(self.cfg)
        last, mem = len(lp) - 1, self.cfg["memory_efficient"]
        if lowres_cond_img is not None:
            x = torch.cat([x, lowres_cond_img], dim=-1)
        x = self.init_conv(x)
        hiddens = []
        for i, (_, nb, attn, _) in enumerate(lp):
            if mem:
                x = getattr(self, f"down{i}_pre")(x)
            x = getattr(self, f"down{i}_init_block")(x, t, c)
            for j in range(nb):
                x = getattr(self, f"down{i}_block{j}")(x, t)
                hiddens.append(x)
            if attn:
                x = getattr(self, f"down{i}_attn")(x)
            hiddens.append(x)
            if not mem:
                x = getattr(self, f"down{i}_post")(x)
        x = self.mid_block1(x, t, c)
        if self.cfg["attend_at_middle"]:
            b_, h, w, ch = x.shape
            tok = x.reshape(b_, h * w, ch)
            x = (tok + self.mid_attn(tok)).reshape(b_, h, w, ch)
        x = self.mid_block2(x, t, c)
        s = 2 ** -0.5
        for r, (_, nb, attn, _) in enumerate(reversed(lp)):
            x = getattr(self, f"up{r}_init_block")(torch.cat([x, hiddens.pop() * s], -1), t, c)
            for j in range(nb):
                x = getattr(self, f"up{r}_block{j}")(torch.cat([x, hiddens.pop() * s], -1), t)
            if attn:
                x = getattr(self, f"up{r}_attn")(x)
            if r != last or mem:
                x = getattr(self, f"up{r}_upsample")(x)
        return self.final_conv(self.final_res_block(x, t))


def set_low_precision(model: nn.Module, fn: Rounding, inputs: bool = True) -> None:
    """Round every dense layer's and convolution's inputs (unless `inputs`
    is False) and weights with `fn` (None: full float32)."""
    for m in model.modules():
        if isinstance(m, (Dense, Conv2d)):
            m.lowp, m.lowp_inputs = fn, inputs


def bf16_rounding(x: torch.Tensor) -> torch.Tensor:
    """Rounding to bfloat16 and back."""
    return x.to(torch.bfloat16).to(x.dtype)


def fp8_rounding(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 (e4m3) rounding, as an fp8 GEMM takes its
    operands."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def unet_configs(config: Dict) -> Sequence[Dict]:
    """The U-Net configs of a benchmark configuration file, each with its
    place in the cascade (``lowres_cond``) and the encoder's width."""
    return [dict(u, lowres_cond=i > 0, text_embed_dim=config["text_embed_dim"])
            for i, u in enumerate(config["unets"])]
