"""Conditional denoising U-Net (counterpart of ``minimagen_tpu/models/unet.py``).

``UnetConfig`` keeps the reference's 13 JSON keys and presets, copied from
the JAX package. ``UnetModel`` is the same topology: CrossEmbed stem -> down
path (cross-attention ResnetBlock, N ResnetBlocks, TransformerBlock per
resolution) -> middle -> mirrored up path with 2^-0.5-scaled skip concats ->
final ResnetBlock and 3x3 conv. Module names are the flax names, so a JAX
parameter tree loads by name. Encoder-feature caching: a forward can return
its stem + down-path features ``(x, hiddens)`` and a later forward can take
them in place of recomputing them (:meth:`UnetModel.forward`);
:func:`encoder_cache_shapes` gives their shapes without running the net.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, ClassVar, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.helpers import cast_tuple, default
from .layers import (
    ATTN_DIM_HEAD,
    NUM_TIME_TOKENS,
    RESNET_GROUPS,
    AffineLayerNorm,
    Attention,
    Conv,
    CrossEmbedLayer,
    Dense,
    Downsample,
    ParallelSum,
    ResnetBlock,
    TransformerBlock,
    Upsample,
    sinusoidal_pos_emb,
)
from .t5 import get_encoded_dim

MAX_TEXT_LEN = 256
# (down-path output, hiddens) of an earlier forward: see UnetModel.forward
EncoderCache = Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]


@dataclass(frozen=True)
class UnetConfig:
    """The reference Unet's 13 constructor parameters."""

    dim: int = 128
    dim_mults: Tuple[int, ...] = (1, 2, 4)
    channels: int = 3
    channels_out: Optional[int] = None
    cond_dim: Optional[int] = None
    text_embed_dim: Optional[int] = None
    num_resnet_blocks: Union[int, Tuple[int, ...]] = 1
    layer_attns: Union[bool, Tuple[bool, ...]] = True
    layer_cross_attns: Union[bool, Tuple[bool, ...]] = True
    attn_heads: int = 8
    lowres_cond: bool = False
    memory_efficient: bool = False
    attend_at_middle: bool = False

    defaults: ClassVar[Dict[str, Any]] = {}

    _JSON_KEYS: ClassVar[Tuple[str, ...]] = (
        "dim", "dim_mults", "channels", "channels_out", "cond_dim", "text_embed_dim",
        "num_resnet_blocks", "layer_attns", "layer_cross_attns", "attn_heads",
        "lowres_cond", "memory_efficient", "attend_at_middle",
    )

    def __post_init__(self):
        for f in ("dim_mults", "num_resnet_blocks", "layer_attns", "layer_cross_attns"):
            v = getattr(self, f)
            if isinstance(v, list):
                object.__setattr__(self, f, tuple(v))
        if self.text_embed_dim is None:
            object.__setattr__(self, "text_embed_dim", get_encoded_dim("t5_small"))

    def to_dict(self) -> Dict[str, Any]:
        """Dict with exactly the reference `unet_<i>_params_*.json` keys."""
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in ((k, getattr(self, k)) for k in self._JSON_KEYS)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UnetConfig":
        return cls(**{k: v for k, v in d.items() if k in cls._JSON_KEYS})

    def cast_model_parameters(self, *, lowres_cond: bool, text_embed_dim: int,
                              channels: int, channels_out: Optional[int]) -> "UnetConfig":
        """Re-derive the config for its position in a cascade."""
        if (lowres_cond == self.lowres_cond and channels == self.channels
                and text_embed_dim == self.text_embed_dim and channels_out == self.channels_out):
            return self
        return dataclasses.replace(self, lowres_cond=lowres_cond, text_embed_dim=text_embed_dim,
                                   channels=channels, channels_out=channels_out)

    @property
    def resolved_channels_out(self) -> int:
        return default(self.channels_out, self.channels)

    @property
    def resolved_cond_dim(self) -> int:
        return default(self.cond_dim, self.dim)

    @property
    def time_cond_dim(self) -> int:
        return self.dim * 4 * (2 if self.lowres_cond else 1)

    def layer_params(self):
        """Per-resolution ((dim_in, dim_out), n_blocks, groups, attn, cross_attn)."""
        dims = [self.dim, *(self.dim * m for m in self.dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)
        return list(zip(in_out, cast_tuple(self.num_resnet_blocks, n),
                        cast_tuple(RESNET_GROUPS, n), cast_tuple(self.layer_attns, n),
                        cast_tuple(self.layer_cross_attns, n)))


def _preset(name: str, defaults: Dict[str, Any]):
    """A UnetConfig preset class that applies its own `defaults` (the JAX
    package's fix of the reference's preset mix-up)."""

    def __init__(self, **kwargs):  # noqa: ANN001
        UnetConfig.__init__(self, **{**defaults, **kwargs})

    return type(name, (UnetConfig,), {"defaults": defaults, "__init__": __init__})


Base = _preset("Base", dict(
    dim=512, dim_mults=(1, 2, 3, 4), num_resnet_blocks=3,
    layer_attns=(False, True, True, True), layer_cross_attns=(False, True, True, True),
    memory_efficient=False,
))
Super = _preset("Super", dict(
    dim=128, dim_mults=(1, 2, 4, 8), num_resnet_blocks=(2, 4, 8, 8),
    layer_attns=(False, False, False, True), layer_cross_attns=(False, False, False, True),
    memory_efficient=True,
))
BaseTest = _preset("BaseTest", dict(
    dim=8, dim_mults=(1, 2), num_resnet_blocks=1,
    layer_attns=False, layer_cross_attns=False, memory_efficient=False,
))
SuperTest = _preset("SuperTest", dict(
    dim=8, dim_mults=(1, 2), num_resnet_blocks=(1, 2),
    layer_attns=False, layer_cross_attns=False, memory_efficient=True,
))


# the reference's class name: its presets and JSON files name configs "Unet"
Unet = UnetConfig


class UnetModel(nn.Module):
    """The U-Net built from a :class:`UnetConfig`, computing in `dtype`
    with its parameters held in `param_dtype` (default: `dtype`) and cast at
    use. Images are NHWC."""

    def __init__(self, config: UnetConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.remat = remat
        cond_dim, tcd = cfg.resolved_cond_dim, cfg.time_cond_dim

        for prefix in ("to_", "to_lowres_") if cfg.lowres_cond else ("to_",):
            self.add_module(f"{prefix}time_hiddens", Dense(cfg.dim, tcd))
            self.add_module(f"{prefix}time_cond", Dense(tcd, tcd))
            self.add_module(f"{prefix}time_tokens", Dense(tcd, cond_dim * NUM_TIME_TOKENS))

        self.text_to_cond = Dense(cfg.text_embed_dim, cond_dim)
        self.null_text_embed = nn.Parameter(torch.randn(1, MAX_TEXT_LEN, cond_dim))
        self.text_nonattn_norm = AffineLayerNorm(cond_dim)
        self.text_nonattn_dense1 = Dense(cond_dim, tcd)
        self.text_nonattn_dense2 = Dense(tcd, tcd)
        self.null_text_hidden = nn.Parameter(torch.randn(1, tcd))
        self.norm_cond = AffineLayerNorm(cond_dim)

        in_channels = cfg.channels * (2 if cfg.lowres_cond else 1)
        self.init_conv = CrossEmbedLayer(in_channels, (3, 7, 15), dim_out=cfg.dim, stride=1)

        layer_params = cfg.layer_params()
        last = len(layer_params) - 1
        mem_eff = cfg.memory_efficient
        for ind, ((dim_in, dim_out), nblocks, groups, attn, cross) in enumerate(layer_params):
            cur = dim_out if mem_eff else dim_in
            if mem_eff:
                self.add_module(f"down{ind}_pre", Downsample(dim_in, dim_out))
            self.add_module(f"down{ind}_init_block", ResnetBlock(
                cur, cur, cond_dim=cond_dim if cross else None, time_cond_dim=tcd, groups=groups))
            for j in range(nblocks):
                self.add_module(f"down{ind}_block{j}",
                                ResnetBlock(cur, cur, time_cond_dim=tcd, groups=groups))
            if attn:
                self.add_module(f"down{ind}_attn", TransformerBlock(
                    cur, heads=cfg.attn_heads, dim_head=ATTN_DIM_HEAD))
            if not mem_eff:
                post = ParallelSum if ind == last else Downsample
                self.add_module(f"down{ind}_post", post(dim_in, dim_out))

        mid_dim = cfg.dim * cfg.dim_mults[-1]
        mid_groups = layer_params[-1][2]
        self.mid_block1 = ResnetBlock(mid_dim, mid_dim, cond_dim=cond_dim, time_cond_dim=tcd,
                                      groups=mid_groups)
        if cfg.attend_at_middle:
            self.mid_attn = Attention(mid_dim, heads=cfg.attn_heads, dim_head=ATTN_DIM_HEAD)
        self.mid_block2 = ResnetBlock(mid_dim, mid_dim, cond_dim=cond_dim, time_cond_dim=tcd,
                                      groups=mid_groups)

        for rev, ((dim_in, dim_out), nblocks, groups, attn, cross) in enumerate(
                reversed(layer_params)):
            skip = dim_out if mem_eff else dim_in
            self.add_module(f"up{rev}_init_block", ResnetBlock(
                dim_out + skip, dim_out, cond_dim=cond_dim if cross else None,
                time_cond_dim=tcd, groups=groups))
            for j in range(nblocks):
                self.add_module(f"up{rev}_block{j}", ResnetBlock(
                    dim_out + skip, dim_out, time_cond_dim=tcd, groups=groups))
            if attn:
                self.add_module(f"up{rev}_attn", TransformerBlock(
                    dim_out, heads=cfg.attn_heads, dim_head=ATTN_DIM_HEAD))
            if rev != last or mem_eff:
                self.add_module(f"up{rev}_upsample", Upsample(dim_out, dim_in))

        self.final_res_block = ResnetBlock(cfg.dim, cfg.dim, time_cond_dim=tcd,
                                           groups=layer_params[0][2])
        self.final_conv = Conv(cfg.dim, cfg.resolved_channels_out, 3, padding=1)
        self.to(default(param_dtype, dtype))

    def _block(self, name: str):
        """Sub-module `name`; with `remat`, a ResnetBlock or TransformerBlock
        runs under ``torch.utils.checkpoint`` while gradients are taken (the
        blocks the JAX U-Net wraps in ``nn.remat``, unet.py:347-353)."""
        module = getattr(self, name)
        if not (self.remat and torch.is_grad_enabled()
                and isinstance(module, (ResnetBlock, TransformerBlock))):
            return module
        return lambda *args: checkpoint(module, *args, use_reentrant=False)

    def _time_condition(self, time, lowres_noise_times):
        cfg = self.config

        def branch(times, prefix):
            hid = sinusoidal_pos_emb(times, cfg.dim, dtype=self.dtype)
            hid = F.silu(getattr(self, f"{prefix}time_hiddens")(hid))
            t = getattr(self, f"{prefix}time_cond")(hid)
            tokens = getattr(self, f"{prefix}time_tokens")(hid)
            return t, tokens.reshape(tokens.shape[0], NUM_TIME_TOKENS, cfg.resolved_cond_dim)

        t, time_tokens = branch(time, "to_")
        if cfg.lowres_cond:
            if lowres_noise_times is None:
                raise ValueError("lowres_cond model requires lowres_noise_times")
            lr_t, lr_tokens = branch(lowres_noise_times, "to_lowres_")
            t = t + lr_t
            time_tokens = torch.cat([time_tokens, lr_tokens], dim=-2)
        return t, time_tokens

    def _text_condition(self, text_embeds, text_mask, text_keep_mask, t, time_tokens):
        """Project and pad the text tokens to 256, swap dropped rows for the
        learned null embeddings, fold pooled text into `t`, build `c`."""
        if text_embeds is None:
            return t, self.norm_cond(time_tokens)
        b = text_embeds.shape[0]
        text_tokens = self.text_to_cond(text_embeds.to(self.dtype))[:, :MAX_TEXT_LEN]
        remainder = MAX_TEXT_LEN - text_tokens.shape[1]
        if remainder > 0:
            text_tokens = F.pad(text_tokens, (0, 0, 0, remainder))
        if text_keep_mask is None:
            text_keep_mask = torch.ones(b, dtype=torch.bool, device=text_embeds.device)
        keep_embed = text_keep_mask[:, None, None]
        if text_mask is not None:
            text_mask = text_mask.bool()
            if remainder > 0:
                text_mask = torch.cat([text_mask, text_mask.new_zeros(b, remainder)], dim=1)
            keep_embed = text_mask[:, :MAX_TEXT_LEN, None] & keep_embed
        text_tokens = torch.where(keep_embed, text_tokens, self.null_text_embed.to(self.dtype))

        hid = self.text_nonattn_norm(text_tokens.mean(dim=-2))
        hid = self.text_nonattn_dense2(F.silu(self.text_nonattn_dense1(hid)))
        hid = torch.where(text_keep_mask[:, None], hid, self.null_text_hidden.to(self.dtype))
        c = torch.cat([time_tokens, text_tokens], dim=-2)
        return t + hid, self.norm_cond(c)

    def forward(self, x: torch.Tensor, time: torch.Tensor, *,
                lowres_cond_img: Optional[torch.Tensor] = None,
                lowres_noise_times: Optional[torch.Tensor] = None,
                text_embeds: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None,
                text_keep_mask: Optional[torch.Tensor] = None,
                encoder_cache: Optional[EncoderCache] = None,
                return_encoder_cache: bool = False):
        """Predict the noise in `x` (b, s, s, c) at integer timesteps `time`
        (b,); returns (b, s, s, channels_out) float32.

        :param lowres_cond_img: upsampled low-res conditioning image (super-res).
        :param lowres_noise_times: (b,) its noise-augmentation times.
        :param text_embeds: (b, L, text_embed_dim) T5 encodings; text_mask (b, L).
        :param text_keep_mask: (b,) False rows get the null conditioning.
        :param encoder_cache: ``(x, hiddens)`` returned by an earlier call:
            the low-res concat, the stem and the down path are skipped and
            these features used instead; the time and text conditioning, the
            middle and the up path run anew.
        :param return_encoder_cache: also return the ``(x, hiddens)`` tuple.
        """
        cfg = self.config
        if cfg.lowres_cond and lowres_cond_img is None:
            raise ValueError("low-res conditioning image must be present")
        x = x.to(self.dtype)
        t, time_tokens = self._time_condition(time, lowres_noise_times)
        t, c = self._text_condition(text_embeds, text_mask, text_keep_mask, t, time_tokens)

        layer_params = cfg.layer_params()
        last = len(layer_params) - 1
        mem_eff = cfg.memory_efficient
        skip_scale = 2 ** -0.5
        block = self._block

        if encoder_cache is not None:
            # the up path pops from the list: take a fresh one each reuse
            x, hiddens = encoder_cache[0], list(encoder_cache[1])
        else:
            if lowres_cond_img is not None:
                x = torch.cat([x, lowres_cond_img.to(self.dtype)], dim=-1)
            x = self.init_conv(x)
            hiddens = []
            for ind, (_, nblocks, _, attn, _) in enumerate(layer_params):
                if mem_eff:
                    x = block(f"down{ind}_pre")(x)
                x = block(f"down{ind}_init_block")(x, t, c)
                for j in range(nblocks):
                    x = block(f"down{ind}_block{j}")(x, t)
                    hiddens.append(x)
                if attn:
                    x = block(f"down{ind}_attn")(x)
                hiddens.append(x)
                if not mem_eff:
                    x = block(f"down{ind}_post")(x)
        cache = (x, tuple(hiddens)) if return_encoder_cache else None

        x = block("mid_block1")(x, t, c)
        if cfg.attend_at_middle:
            b, h, w, ch = x.shape
            tokens = x.reshape(b, h * w, ch)
            x = (tokens + self.mid_attn(tokens)).reshape(b, h, w, ch)
        x = block("mid_block2")(x, t, c)

        for rev, (_, nblocks, _, attn, _) in enumerate(reversed(layer_params)):
            x = torch.cat([x, hiddens.pop() * skip_scale], dim=-1)
            x = block(f"up{rev}_init_block")(x, t, c)
            for j in range(nblocks):
                x = torch.cat([x, hiddens.pop() * skip_scale], dim=-1)
                x = block(f"up{rev}_block{j}")(x, t)
            if attn:
                x = block(f"up{rev}_attn")(x)
            if rev != last or mem_eff:
                x = block(f"up{rev}_upsample")(x)

        x = block("final_res_block")(x, t)
        out = self.final_conv(x).float()
        return (out, cache) if return_encoder_cache else out


def encoder_cache_shapes(cfg: UnetConfig, batch: int, size: int) -> List[Tuple[int, ...]]:
    """The (b, h, w, c) shapes of the tensors an encoder cache holds, for
    `batch` rows of `size` x `size` images: the down path's output first,
    then the hiddens in the order the down path appends them. Derived from
    `cfg` alone, without running the net."""
    layer_params = cfg.layer_params()
    last = len(layer_params) - 1
    hiddens, s = [], size
    for ind, ((dim_in, dim_out), nblocks, *_) in enumerate(layer_params):
        channels = dim_in
        if cfg.memory_efficient:  # a 4x4 stride-2 conv first
            s, channels = s // 2, dim_out
        hiddens += [(batch, s, s, channels)] * (nblocks + 1)
        if not cfg.memory_efficient:  # stride-2 conv, or the parallel sum at the last
            s, channels = (s if ind == last else s // 2), dim_out
    return [(batch, s, s, channels), *hiddens]
