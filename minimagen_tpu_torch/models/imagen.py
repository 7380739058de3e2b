"""Cascade sampling and the training loss (counterpart of
``minimagen_tpu/models/imagen.py``).

N U-Nets, each with its own diffusion schedule, plus a low-res augmentation
schedule. Sampling runs classifier-free guidance as ONE pair-batched forward
(rows [0:b] conditioned, [b:2b] null), recovers x0 and clamps it by dynamic
thresholding (per-image quantile 0.9 of |x0|, at least 1), and steps with
DDPM or DDIM. A super-resolution stage conditions on the previous stage's
output, resized and noise-augmented at a fixed level in [0, 1] space (the
reference's order), and may start from that output noised to
``sr_start_noise_levels`` instead of pure noise (truncated refinement).

Encoder-feature caching is off (the JAX default ``'auto'`` is a cost model
fitted on a TPU) and ``guidance_rescale`` is 0. DPM-Solver++, UniPC and the
``lambda``/``karras`` grids are not ported yet.

Training: :meth:`Imagen.stage_loss` is the JAX package's ``stage_loss_fn``
(resize the [0, 1] images to the stage's size; for a super-resolution stage
build the low-res pair by resizing down to the previous stage's size and
back up, with one random augmentation time for the whole batch) and
:meth:`Imagen.p_losses` its ``_p_losses`` (noise the images at random times,
predict the noise with a classifier-free-guidance dropout mask, l1/l2/huber
loss, optional min-SNR weighting and offset noise). Its draws come from a
``torch.Generator`` in this order: the times, the augmentation time, the
noise, the offset noise (when enabled), the augmentation noise, the keep
mask; each can be injected instead.

Randomness: every draw goes through ``noise(shape)``, by default
``torch.randn`` from the caller's generator. The draws come in this order:
per stage, the augmentation noise of the low-res image (super-res stages),
then the stage's initial image (pure noise, or the truncated start), then
one draw per step for DDPM. Passing ``noise`` injects them, which is how the
tests hold a run against the JAX package.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.diffusion import GaussianDiffusion
from ..ops.helpers import (
    abs_quantile_bisect,
    cast_tuple,
    default,
    normalize_neg_one_to_one,
    prob_mask_like,
    right_pad_dims_to,
    unnormalize_zero_to_one,
)
from ..ops.resize import resize_image_to
from .t5 import MAX_LENGTH, TextEncoder, get_encoded_dim
from .unet import UnetConfig, UnetModel

NoiseFn = Callable[[Sequence[int]], torch.Tensor]
LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _elementwise_loss(loss_type: str) -> LossFn:
    if loss_type == "l1":
        return lambda pred, target: (pred - target).abs()
    if loss_type == "l2":
        return lambda pred, target: (pred - target).square()
    if loss_type == "huber":
        def smooth_l1(pred, target, beta=1.0):
            d = (pred - target).abs()
            return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
        return smooth_l1
    raise NotImplementedError(f"unknown loss type {loss_type!r}")


def _loss_fn(loss_type: str) -> LossFn:
    """l1 / l2 / huber per-element losses, mean-reduced."""
    per_element = _elementwise_loss(loss_type)
    return lambda pred, target: per_element(pred, target).mean()


def _per_sample_loss_fn(loss_type: str) -> LossFn:
    """The same losses reduced to one value per batch row (min-SNR weighting)."""
    per_element = _elementwise_loss(loss_type)
    return lambda pred, target: per_element(pred, target).mean(dim=tuple(range(1, pred.ndim)))

# rows of at least this many elements take the bisection quantile (the JAX
# package's default threshold, imagen.py:407-421)
APPROX_QUANTILE_MIN = 2 ** 17


class Imagen:
    """Cascading text-to-image diffusion model: sampling and the training loss.

    `dtype` is the U-Nets' compute dtype, `param_dtype` (default `dtype`)
    the dtype their parameters are held in."""

    def __init__(self, unets: Union[UnetConfig, Sequence[UnetConfig]], *,
                 text_encoder_name: str, image_sizes: Union[int, Sequence[int]],
                 text_embed_dim: Optional[int] = None, channels: int = 3,
                 timesteps: Union[int, Sequence[int]] = 1000, cond_drop_prob: float = 0.1,
                 loss_type: str = "l2", lowres_sample_noise_level: float = 0.2,
                 dynamic_thresholding_percentile: float = 0.9, auto_normalize_img: bool = True,
                 min_snr_gamma: Optional[float] = None, offset_noise_scale: float = 0.0,
                 dtype: torch.dtype = torch.float32, param_dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        self.loss_fn = _loss_fn(loss_type)
        self.per_sample_loss_fn = _per_sample_loss_fn(loss_type)
        self.min_snr_gamma: Optional[float] = None
        self.offset_noise_scale = 0.0
        self.set_training_levers(min_snr_gamma=min_snr_gamma,
                                 offset_noise_scale=offset_noise_scale)
        self.device = torch.device(device)
        self.dtype = dtype
        self.channels = channels
        configs = list(cast_tuple(unets))
        ts = cast_tuple(timesteps, len(configs))
        self.noise_schedulers = [GaussianDiffusion(t, self.device) for t in ts]
        self.lowres_noise_schedule = GaussianDiffusion(ts[0], self.device)
        self.text_encoder_name = text_encoder_name
        self.text_embed_dim = default(text_embed_dim, lambda: get_encoded_dim(text_encoder_name))
        self.unet_configs: List[UnetConfig] = [
            cfg.cast_model_parameters(lowres_cond=i != 0, text_embed_dim=self.text_embed_dim,
                                      channels=channels, channels_out=channels)
            for i, cfg in enumerate(configs)]
        self.unets = torch.nn.ModuleList(UnetModel(c, dtype, param_dtype)
                                         for c in self.unet_configs)
        self.unets.to(self.device).eval()
        self.image_sizes = cast_tuple(image_sizes)
        if len(self.image_sizes) != len(configs):
            raise ValueError(f"{len(configs)} u-nets for resolutions {self.image_sizes}")
        self.lowres_sample_noise_level = lowres_sample_noise_level
        self.cond_drop_prob = cond_drop_prob
        self.can_classifier_guidance = cond_drop_prob > 0.0
        self.dynamic_thresholding_percentile = dynamic_thresholding_percentile
        # images in [0, 1] are mapped to the U-Nets' [-1, 1] and back, unless
        # the caller's images are in [-1, 1] already
        identity = lambda t: t  # noqa: E731
        self.normalize_img = normalize_neg_one_to_one if auto_normalize_img else identity
        self.unnormalize_img = unnormalize_zero_to_one if auto_normalize_img else identity
        self.input_image_range = (0.0 if auto_normalize_img else -1.0, 1.0)
        self.text_encoder: Optional[TextEncoder] = None
        self.text_max_length = MAX_LENGTH

    def set_training_levers(self, *, min_snr_gamma: Optional[float] = None,
                            offset_noise_scale: Optional[float] = None) -> None:
        """Min-SNR-gamma loss weighting (> 0) and offset-noise scale (>= 0);
        None leaves a lever as it is."""
        if min_snr_gamma is not None:
            if not float(min_snr_gamma) > 0.0:
                raise ValueError("min_snr_gamma must be > 0")
            self.min_snr_gamma = float(min_snr_gamma)
        if offset_noise_scale is not None:
            if not float(offset_noise_scale) >= 0.0:
                raise ValueError("offset_noise_scale must be >= 0")
            self.offset_noise_scale = float(offset_noise_scale)

    @property
    def num_unets(self) -> int:
        return len(self.unets)

    def encode_text(self, texts: List[str]):
        if self.text_encoder is None:
            self.text_encoder = TextEncoder(self.text_encoder_name, self.device)
        return self.text_encoder.encode(texts, self.text_max_length)

    # ------------------------------------------------------------------ #
    # guided forward and x0 prediction                                    #
    # ------------------------------------------------------------------ #
    def _cfg_forward(self, stage, x, t, *, text_embeds, text_mask, lowres_cond_img,
                     lowres_noise_times, cond_scale):
        """One pair-batched forward; returns null + (cond - null) * cond_scale."""
        b = x.shape[0]
        dup = lambda a: None if a is None else torch.cat([a, a], dim=0)  # noqa: E731
        keep = torch.cat([torch.ones(b, dtype=torch.bool, device=x.device),
                          torch.zeros(b, dtype=torch.bool, device=x.device)])
        out = self.unets[stage](dup(x), dup(t), text_embeds=dup(text_embeds),
                                text_mask=dup(text_mask), lowres_cond_img=dup(lowres_cond_img),
                                lowres_noise_times=dup(lowres_noise_times), text_keep_mask=keep)
        logits, null_logits = out[:b], out[b:]
        return null_logits + (logits - null_logits) * cond_scale

    def _predict_x_start(self, stage, x, t, *, text_embeds, text_mask, lowres_cond_img,
                         lowres_noise_times, cond_scale, guided: bool):
        """Predicted noise -> x0, dynamically thresholded."""
        kw = dict(text_embeds=text_embeds, text_mask=text_mask,
                  lowres_cond_img=lowres_cond_img, lowres_noise_times=lowres_noise_times)
        if guided:
            pred = self._cfg_forward(stage, x, t, cond_scale=cond_scale, **kw)
        else:
            pred = self.unets[stage](x, t, **kw)
        x_start = self.noise_schedulers[stage].predict_start_from_noise(x, t=t, noise=pred)
        b = x_start.shape[0]
        flat = x_start.reshape(b, -1).abs().float()
        if flat.shape[-1] >= APPROX_QUANTILE_MIN:
            s = abs_quantile_bisect(flat, self.dynamic_thresholding_percentile)
        else:
            s = torch.quantile(flat, self.dynamic_thresholding_percentile, dim=-1)
        s = right_pad_dims_to(x_start, s.clamp(min=1.0)).to(x_start.dtype)
        return torch.maximum(torch.minimum(x_start, s), -s) / s

    def _p_mean_variance(self, stage, x, t, **kw):
        """Posterior (mean, variance, log-variance) from the thresholded x0."""
        x_start = self._predict_x_start(stage, x, t, **kw)
        return self.noise_schedulers[stage].q_posterior(x_start=x_start, x_t=x, t=t)

    # ------------------------------------------------------------------ #
    # sampling                                                            #
    # ------------------------------------------------------------------ #
    def _noise_fn(self, noise: Optional[NoiseFn], generator: Optional[torch.Generator]) -> NoiseFn:
        if noise is not None:
            return noise
        return lambda shape: torch.randn(tuple(shape), generator=generator,
                                         device=self.device, dtype=torch.float32)

    @torch.inference_mode()
    def sample_stage(self, stage: int, text_embeds, text_mask, cond_scale: float, *,
                     init_noise: torch.Tensor, lowres_cond_img=None, lowres_noise_times=None,
                     sampler: str = "ddim", sample_steps: Optional[int] = None,
                     start_at: Optional[int] = None, noise: Optional[NoiseFn] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One stage's reverse process from `init_noise`; returns [0, 1]
        images. `lowres_cond_img` is the already-noised [0, 1] conditioning
        image; `start_at` truncates to timesteps <= it."""
        if sampler not in ("ddpm", "ddim"):
            raise NotImplementedError(f"sampler {sampler!r} is not ported yet")
        scheduler = self.noise_schedulers[stage]
        b = text_embeds.shape[0]
        lowres = (self.normalize_img(lowres_cond_img)
                  if self.unet_configs[stage].lowres_cond else None)
        kw = dict(text_embeds=text_embeds, text_mask=text_mask, lowres_cond_img=lowres,
                  lowres_noise_times=lowres_noise_times, cond_scale=cond_scale,
                  guided=cond_scale != 1.0)
        full = lambda v: torch.full((b,), int(v), dtype=torch.int64, device=self.device)  # noqa: E731
        img = init_noise.to(self.device, torch.float32)
        if sampler == "ddpm":
            draw = self._noise_fn(noise, generator)
            times = np.arange(scheduler.num_timesteps - 1, -1, -1)
            if start_at is not None:
                times = times[times <= start_at]
            for t_scalar in times:
                mean, _, log_var = self._p_mean_variance(stage, img, full(t_scalar), **kw)
                step_noise = draw(img.shape)
                img = mean + (1.0 if t_scalar > 0 else 0.0) * torch.exp(0.5 * log_var) * step_noise
        else:
            steps = default(sample_steps, min(50, scheduler.num_timesteps))
            pairs = scheduler.strided_sampling_timesteps(steps)
            if start_at is not None:
                pairs = pairs[pairs[:, 0] <= start_at]
            for t_scalar, tp_scalar in pairs:
                t = full(t_scalar)
                x0 = self._predict_x_start(stage, img, t, **kw)
                img = scheduler.ddim_step(img, x0, t, full(tp_scalar))
        return self.unnormalize_img(img.clamp(-1.0, 1.0))

    def _truncation_start(self, stage: int, start_noise_level: float, sampler: str,
                          sample_steps: Optional[int]) -> int:
        """A truncation level in (0, 1] -> start timestep, clamped onto the
        DDIM grid so the init image is noised at the first t processed."""
        if not 0.0 < start_noise_level <= 1.0:
            raise ValueError("start_noise_level must be in (0, 1]")
        scheduler = self.noise_schedulers[stage]
        start_at = min(int(start_noise_level * scheduler.num_timesteps),
                       scheduler.num_timesteps - 1)
        if sampler == "ddim":
            steps = default(sample_steps, min(50, scheduler.num_timesteps))
            grid = scheduler.strided_sampling_timesteps(steps)[:, 0]
            on_grid = grid[grid <= start_at]
            if not on_grid.size:
                raise ValueError("start_noise_level is below the DDIM grid's smallest timestep")
            start_at = int(on_grid.max())
        return start_at

    def _truncation_init(self, stage: int, images, start_at: int, noise: torch.Tensor):
        """q_sample the normalized, upsampled `images` at `start_at`."""
        upsampled = resize_image_to(images, self.image_sizes[stage])
        b = upsampled.shape[0]
        return self.noise_schedulers[stage].q_sample(
            x_start=self.normalize_img(upsampled),
            t=torch.full((b,), start_at, dtype=torch.int64, device=self.device), noise=noise)

    def _lowres_condition(self, stage: int, images, noise_level: float, draw: NoiseFn):
        """Resize the previous stage's output and noise it at a fixed level
        in [0, 1] space; returns (noised image, its times)."""
        b = images.shape[0]
        times = self.lowres_noise_schedule.get_times(b, noise_level, self.device)
        lowres = resize_image_to(images, self.image_sizes[stage])
        lowres = self.lowres_noise_schedule.q_sample(x_start=lowres, t=times,
                                                     noise=draw(lowres.shape))
        return lowres, times

    def _text_inputs(self, texts, text_embeds, text_masks):
        if texts is not None and text_embeds is None:
            text_embeds, text_masks = self.encode_text(texts)
        if text_embeds is None:
            raise ValueError("text or text encodings must be passed")
        if text_embeds.shape[-1] != self.text_embed_dim:
            raise ValueError(f"text embedding dim {text_embeds.shape[-1]} != {self.text_embed_dim}")
        text_embeds = torch.as_tensor(text_embeds, dtype=torch.float32, device=self.device)
        if text_masks is not None:
            text_masks = torch.as_tensor(text_masks, dtype=torch.bool, device=self.device)
        return text_embeds, text_masks

    @torch.inference_mode()
    def sample(self, texts: Optional[List[str]] = None, text_masks=None, text_embeds=None,
               cond_scale: float = 1.0, lowres_sample_noise_level: Optional[float] = None, *,
               sampler: str = "ddpm", sample_steps: Union[int, Sequence[int], None] = None,
               sr_start_noise_levels: Union[float, Sequence[Optional[float]], None] = None,
               return_all_stage_outputs: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[NoiseFn] = None):
        """Generate (b, s, s, c) NHWC images in [0, 1] for captions (or
        precomputed T5 encodings) through every stage of the cascade.

        :param sample_steps: DDIM steps (default min(50, T)), or one per stage.
        :param sr_start_noise_levels: truncated refinement level in (0, 1]
            for the super-res stages (or one per stage, None = full reverse).
        :param noise: optional ``noise(shape)`` replacing every random draw
            (order in the module docstring); else ``generator`` is used.
        """
        text_embeds, text_masks = self._text_inputs(texts, text_embeds, text_masks)
        if cond_scale != 1.0 and not self.can_classifier_guidance:
            raise ValueError("classifier-free guidance needs a model trained with cond_drop_prob > 0")
        draw = self._noise_fn(noise, generator)
        b = text_embeds.shape[0]
        noise_level = default(lowres_sample_noise_level, self.lowres_sample_noise_level)
        per_stage = lambda v, i: v[i] if isinstance(v, (list, tuple)) else v  # noqa: E731
        img, outputs = None, []
        for stage in range(self.num_unets):
            size = self.image_sizes[stage]
            steps = per_stage(sample_steps, stage)
            lowres = lowres_times = start_at = None
            if self.unet_configs[stage].lowres_cond:
                lowres, lowres_times = self._lowres_condition(stage, img, noise_level, draw)
                sr_level = per_stage(sr_start_noise_levels, stage)
                if sr_level is not None:
                    start_at = self._truncation_start(stage, sr_level, sampler, steps)
            shape = (b, size, size, self.channels)
            init = (draw(shape) if start_at is None
                    else self._truncation_init(stage, img, start_at, draw(shape)))
            img = self.sample_stage(stage, text_embeds, text_masks, cond_scale, init_noise=init,
                                    lowres_cond_img=lowres, lowres_noise_times=lowres_times,
                                    sampler=sampler, sample_steps=steps, start_at=start_at,
                                    noise=draw)
            outputs.append(img)
        return outputs if return_all_stage_outputs else img

    @torch.inference_mode()
    def super_resolve(self, images, *, stage: int = 1, texts: Optional[List[str]] = None,
                      text_embeds=None, text_masks=None, cond_scale: float = 1.0,
                      lowres_sample_noise_level: Optional[float] = None,
                      sampler: str = "ddim", sample_steps: Optional[int] = None,
                      start_noise_level: Optional[float] = None,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[NoiseFn] = None):
        """Upscale existing (b, h, w, c) [0, 1] images through one super-res
        stage; `start_noise_level` refines instead of reversing from noise.
        Draws: augmentation noise, then the initial image."""
        if not (1 <= stage < self.num_unets and self.unet_configs[stage].lowres_cond):
            raise ValueError(f"stage {stage} is not a super-resolution stage")
        text_embeds, text_masks = self._text_inputs(texts, text_embeds, text_masks)
        draw = self._noise_fn(noise, generator)
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        b = images.shape[0]
        noise_level = default(lowres_sample_noise_level, self.lowres_sample_noise_level)
        lowres, lowres_times = self._lowres_condition(stage, images, noise_level, draw)
        size = self.image_sizes[stage]
        shape = (b, size, size, self.channels)
        start_at = None
        if start_noise_level is not None:
            start_at = self._truncation_start(stage, start_noise_level, sampler, sample_steps)
            init = self._truncation_init(stage, images, start_at, draw(shape))
        else:
            init = draw(shape)
        return self.sample_stage(stage, text_embeds, text_masks, cond_scale, init_noise=init,
                                 lowres_cond_img=lowres, lowres_noise_times=lowres_times,
                                 sampler=sampler, sample_steps=sample_steps, start_at=start_at,
                                 noise=draw)

    # ------------------------------------------------------------------ #
    # training loss                                                       #
    # ------------------------------------------------------------------ #
    def p_losses(self, stage: int, x_start: torch.Tensor, times: torch.Tensor, *,
                 text_embeds, text_mask, lowres_cond_img=None, lowres_aug_times=None,
                 noise: Optional[torch.Tensor] = None, lowres_noise: Optional[torch.Tensor] = None,
                 keep_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Noise [0, 1] images `x_start` (b, s, s, c) at `times`, predict the
        noise, return the scalar loss. `noise`, `lowres_noise` and the
        classifier-free-guidance `keep_mask` (b,) are drawn from `generator`
        unless given; offset noise applies only to drawn noise."""
        scheduler = self.noise_schedulers[stage]
        b = x_start.shape[0]
        draw = self._noise_fn(None, generator)
        if noise is None:
            noise = draw(x_start.shape)
            if self.offset_noise_scale > 0.0:
                noise = noise + self.offset_noise_scale * draw((b, 1, 1, x_start.shape[-1]))
        x_start = self.normalize_img(x_start)
        x_noisy = scheduler.q_sample(x_start=x_start, t=times, noise=noise)
        lowres_noisy = None
        if lowres_cond_img is not None:
            lowres_cond_img = self.normalize_img(lowres_cond_img)
            lowres_aug_times = default(lowres_aug_times, times)
            if lowres_noise is None:
                lowres_noise = draw(lowres_cond_img.shape)
            lowres_noisy = self.lowres_noise_schedule.q_sample(
                x_start=lowres_cond_img, t=lowres_aug_times, noise=lowres_noise)
        if keep_mask is None:
            keep_mask = prob_mask_like((b,), 1.0 - self.cond_drop_prob, generator=generator,
                                       device=self.device)
        pred = self.unets[stage](x_noisy, times, text_embeds=text_embeds, text_mask=text_mask,
                                 text_keep_mask=keep_mask, lowres_cond_img=lowres_noisy,
                                 lowres_noise_times=lowres_aug_times)
        if self.min_snr_gamma is None:
            return self.loss_fn(pred, noise)
        abar = scheduler.alphas_cumprod[times]
        snr = abar / (1.0 - abar).clamp(min=1e-20)
        weight = snr.clamp(max=self.min_snr_gamma) / snr.clamp(min=1e-20)
        return (weight * self.per_sample_loss_fn(pred, noise)).mean()

    def stage_loss(self, stage: int, images: torch.Tensor, text_embeds, text_mask, *,
                   generator: Optional[torch.Generator] = None,
                   times: Optional[torch.Tensor] = None,
                   lowres_aug_times: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   lowres_noise: Optional[torch.Tensor] = None,
                   keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One stage's loss on full-resolution [0, 1] NHWC `images`: resize
        to the stage's size; a super-resolution stage conditions on the
        images resized down to the previous stage's size and back up, noised
        at one augmentation time shared by the batch. Draws not given come
        from `generator` (order in the module docstring)."""
        b, h, w, c = images.shape
        size = self.image_sizes[stage]
        if c != self.channels or h < size or w < size:
            raise ValueError(f"images {tuple(images.shape)} do not fit stage {stage} ({size}px)")
        if times is None:
            times = self.noise_schedulers[stage].sample_random_times(b, generator)
        lowres = None
        if stage > 0:
            clamp = self.input_image_range
            lowres = resize_image_to(images, self.image_sizes[stage - 1], clamp_range=clamp)
            lowres = resize_image_to(lowres, size, clamp_range=clamp)
            if lowres_aug_times is None:
                lowres_aug_times = self.lowres_noise_schedule.sample_random_times(
                    1, generator).expand(b)
        return self.p_losses(stage, resize_image_to(images, size), times,
                             text_embeds=text_embeds, text_mask=text_mask, lowres_cond_img=lowres,
                             lowres_aug_times=lowres_aug_times if stage > 0 else None,
                             noise=noise, lowres_noise=lowres_noise, keep_mask=keep_mask,
                             generator=generator)

    def forward(self, images, texts: Optional[List[str]] = None, text_embeds=None,
                text_masks=None, unet_number: Optional[int] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training loss of U-Net `unet_number` (1-based; required for a
        cascade) on [0, 1] NHWC `images` and their captions or encodings."""
        if self.num_unets > 1 and unet_number is None:
            raise ValueError(f"pass unet_number, 1 to {self.num_unets}, to train a cascade")
        stage = default(unet_number, 1) - 1
        if texts is not None and text_embeds is None and len(texts) != len(images):
            raise ValueError("the number of captions does not match the number of images")
        text_embeds, text_masks = self._text_inputs(texts, text_embeds, text_masks)
        # encodings made under inference_mode cannot be saved for backward
        text_embeds = text_embeds.clone() if text_embeds.is_inference() else text_embeds
        if text_masks is not None and text_masks.is_inference():
            text_masks = text_masks.clone()
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        return self.stage_loss(stage, images, text_embeds, text_masks, generator=generator)

    __call__ = forward
