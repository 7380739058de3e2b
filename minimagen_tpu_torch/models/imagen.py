"""Cascade sampling and the training loss (counterpart of
``minimagen_tpu/models/imagen.py``).

N U-Nets, each with its own diffusion schedule, plus a low-res augmentation
schedule. Sampling runs classifier-free guidance as ONE pair-batched forward
(rows [0:b] conditioned, [b:2b] null), optionally with the guidance rescale
of arXiv 2305.08891 (``guidance_rescale``), recovers x0 and clamps it by
dynamic thresholding (per-image quantile 0.9 of |x0|, at least 1), and steps
with DDPM, DDIM, DPM-Solver++(2M) or UniPC-2 on the ``time``, ``lambda`` or
``karras`` grid. A super-resolution stage conditions on the previous stage's
output, resized and noise-augmented at a fixed level in [0, 1] space (the
reference's order), and may start from that output noised to
``sr_start_noise_levels`` instead of pure noise (truncated refinement).

Encoder-feature caching (``cache_interval``): every N-th step runs the whole
U-Net and keeps its stem + down-path features; the steps between reuse them
and run only the middle and up paths. ``'auto'`` (the default of ``sample``
and ``super_resolve``) asks :meth:`Imagen.encoder_cache_cost_model`, whose
constants were fitted to guided step times on an H100.

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

Randomness of sampling: every draw goes through ``noise(shape)``, by default
``torch.randn`` from the caller's generator. The draws come in this order:
per stage, the augmentation noise of the low-res image (super-res stages),
then the stage's initial image (pure noise, or the truncated start), then
one draw per step for DDPM. DDIM, DPM-Solver++ and UniPC draw nothing per
step. Passing ``noise`` injects them, which is how the tests hold a run
against the JAX package. On a mesh (``sample(mesh=)``, the training step's
``stage_draws``) every process makes each draw for the whole batch and
keeps its rows, so a mesh run equals a one-device run.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Union

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
from ..utils.progress import ProgressBar
from .t5 import MAX_LENGTH, TextEncoder, get_encoded_dim
from .unet import EncoderCache, UnetConfig, UnetModel, encoder_cache_shapes

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
SAMPLERS = ("ddpm", "ddim", "dpmpp", "unipc")
STRIDED_SAMPLERS = ("ddim", "dpmpp", "unipc")


def guided_combine(logits: torch.Tensor, null_logits: torch.Tensor, cond_scale: float,
                   guidance_rescale: float = 0.0) -> torch.Tensor:
    """null + (cond - null) * cond_scale; with `guidance_rescale` phi > 0,
    blended with that prediction rescaled to the conditional prediction's
    per-sample (population) std: phi * rescaled + (1 - phi) * guided
    (arXiv 2305.08891, section 3.4). phi = 0 runs only the first line."""
    guided = null_logits + (logits - null_logits) * cond_scale
    if guidance_rescale > 0.0:
        dims = tuple(range(1, guided.ndim))
        std_pos = torch.std(logits, dim=dims, keepdim=True, correction=0)
        std_cfg = torch.std(guided, dim=dims, keepdim=True, correction=0)
        rescaled = guided * (std_pos / std_cfg.clamp(min=1e-8))
        guided = guidance_rescale * rescaled + (1.0 - guidance_rescale) * guided
    return guided


def rows_of_draws(draw: NoiseFn, total: int, rows: slice) -> NoiseFn:
    """A process's draws from the whole batch's: each batch-shaped draw is
    made for `total` rows and cut to `rows`."""
    return lambda shape: draw((total,) + tuple(shape[1:]))[rows]


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """[0, 1] float images -> uint8, rounded to nearest (as PIL images and
    written PNGs hold them)."""
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _to_pil(arr: np.ndarray):
    """[0, 1] float HWC image -> PIL.Image (PIL is imported only here)."""
    from PIL import Image  # noqa: PLC0415

    arr = to_uint8(arr)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    return Image.fromarray(arr)


class Imagen:
    """Cascading text-to-image diffusion model: sampling and the training loss.

    The constructor takes the JAX ``Imagen``'s parameters in its order, so a
    training directory's ``imagen_params_*.json`` builds either one.
    `dtype` is the U-Nets' compute dtype, `param_dtype` (default `dtype`)
    the dtype their parameters are held in; `remat` recomputes each
    ResnetBlock and TransformerBlock in the backward pass instead of keeping
    its activations; `only_train_unet_number` (1-based) restricts
    :meth:`forward`'s loss to that U-Net, as the reference's does."""

    def __init__(self, unets: Union[UnetConfig, Sequence[UnetConfig]], *,
                 text_encoder_name: str, image_sizes: Union[int, Sequence[int]],
                 text_embed_dim: Optional[int] = None, channels: int = 3,
                 timesteps: Union[int, Sequence[int]] = 1000, cond_drop_prob: float = 0.1,
                 loss_type: str = "l2", lowres_sample_noise_level: float = 0.2,
                 auto_normalize_img: bool = True, dynamic_thresholding_percentile: float = 0.9,
                 only_train_unet_number: Optional[int] = None,
                 min_snr_gamma: Optional[float] = None, offset_noise_scale: float = 0.0,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 param_dtype: Optional[torch.dtype] = None, device="cuda"):
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
        self.only_train_unet_number = only_train_unet_number
        self.unets = torch.nn.ModuleList(UnetModel(c, dtype, param_dtype, remat=remat)
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

    def state_dict(self) -> dict:
        """{'unet_0': state_dict, ...}, every U-Net's parameters (the JAX
        ``Imagen.state_dict`` shim, ``minimagen_tpu/models/imagen.py:280``)."""
        return {f"unet_{i}": unet.state_dict() for i, unet in enumerate(self.unets)}

    def load_state_dict(self, params: dict) -> None:
        """Load {'unet_0': state_dict, ...}: exactly one entry per U-Net,
        every key matched."""
        want = {f"unet_{i}" for i in range(self.num_unets)}
        if set(params) != want:
            raise ValueError(f"expected keys {sorted(want)}, got {sorted(params)}")
        for i, unet in enumerate(self.unets):
            unet.load_state_dict(params[f"unet_{i}"], strict=True)

    def encode_text(self, texts: List[str]):
        if self.text_encoder is None:
            self.text_encoder = TextEncoder(self.text_encoder_name, self.device)
        return self.text_encoder.encode(texts, self.text_max_length)

    # ------------------------------------------------------------------ #
    # guided forward and x0 prediction                                    #
    # ------------------------------------------------------------------ #
    def _cfg_forward(self, stage, x, t, *, text_embeds, text_mask, lowres_cond_img,
                     lowres_noise_times, cond_scale, guidance_rescale: float = 0.0,
                     encoder_cache: Optional[EncoderCache] = None,
                     return_encoder_cache: bool = False):
        """One pair-batched forward; returns :func:`guided_combine` of its
        halves (and the cache when asked). An `encoder_cache` came from this
        function, so it is pair-batched already and goes in as it is."""
        b = x.shape[0]
        dup = lambda a: None if a is None else torch.cat([a, a], dim=0)  # noqa: E731
        keep = torch.cat([torch.ones(b, dtype=torch.bool, device=x.device),
                          torch.zeros(b, dtype=torch.bool, device=x.device)])
        out = self.unets[stage](dup(x), dup(t), text_embeds=dup(text_embeds),
                                text_mask=dup(text_mask), lowres_cond_img=dup(lowres_cond_img),
                                lowres_noise_times=dup(lowres_noise_times), text_keep_mask=keep,
                                encoder_cache=encoder_cache,
                                return_encoder_cache=return_encoder_cache)
        cache = None
        if return_encoder_cache:
            out, cache = out
        guided = guided_combine(out[:b], out[b:], cond_scale, guidance_rescale)
        return (guided, cache) if return_encoder_cache else guided

    def forward_with_cond_scale(self, x, time, *, unet_number: int = 1, cond_scale: float = 1.0,
                                guidance_rescale: float = 0.0, **conditioning):
        """Guided forward of U-Net `unet_number` (1-based): one pair-batched
        forward where the reference runs two. `conditioning` takes
        text_embeds, text_mask, lowres_cond_img and lowres_noise_times."""
        stage = unet_number - 1
        kw = {k: conditioning.get(k) for k in
              ("text_embeds", "text_mask", "lowres_cond_img", "lowres_noise_times")}
        if cond_scale == 1.0:
            return self.unets[stage](x, time, **kw)
        return self._cfg_forward(stage, x, time, cond_scale=cond_scale,
                                 guidance_rescale=guidance_rescale, **kw)

    def _predict_x_start(self, stage, x, t, *, text_embeds, text_mask, lowres_cond_img,
                         lowres_noise_times, cond_scale, guided: bool,
                         guidance_rescale: float = 0.0,
                         encoder_cache: Optional[EncoderCache] = None,
                         return_encoder_cache: bool = False):
        """Predicted noise -> x0, dynamically thresholded (and the encoder
        cache when asked)."""
        kw = dict(text_embeds=text_embeds, text_mask=text_mask,
                  lowres_cond_img=lowres_cond_img, lowres_noise_times=lowres_noise_times,
                  encoder_cache=encoder_cache, return_encoder_cache=return_encoder_cache)
        if guided:
            pred = self._cfg_forward(stage, x, t, cond_scale=cond_scale,
                                     guidance_rescale=guidance_rescale, **kw)
        else:
            pred = self.unets[stage](x, t, **kw)
        cache = None
        if return_encoder_cache:
            pred, cache = pred
        x_start = self.noise_schedulers[stage].predict_start_from_noise(x, t=t, noise=pred)
        b = x_start.shape[0]
        flat = x_start.reshape(b, -1).abs().float()
        if flat.shape[-1] >= APPROX_QUANTILE_MIN:
            s = abs_quantile_bisect(flat, self.dynamic_thresholding_percentile)
        else:
            s = torch.quantile(flat, self.dynamic_thresholding_percentile, dim=-1)
        s = right_pad_dims_to(x_start, s.clamp(min=1.0)).to(x_start.dtype)
        x_start = torch.maximum(torch.minimum(x_start, s), -s) / s
        return (x_start, cache) if return_encoder_cache else x_start

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
                     start_at: Optional[int] = None, grid: str = "time",
                     cache_interval: Optional[int] = None, guidance_rescale: float = 0.0,
                     progress: bool = False, noise: Optional[NoiseFn] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One stage's reverse process from `init_noise`; returns [0, 1]
        images. `lowres_cond_img` is the already-noised [0, 1] conditioning
        image; `start_at` truncates to timesteps <= it.

        :param sampler: 'ddpm' (all T steps), 'ddim', 'dpmpp'
            (DPM-Solver++(2M)) or 'unipc' (UniPC-2 'bh2': the DPM++ predictor
            after a corrector that reuses each model call), the last three
            over `sample_steps` pairs of the `grid` ('time', 'lambda' or
            'karras'; duplicate timesteps collapse, so there may be fewer).
        :param cache_interval: recompute the U-Net's stem + down path every
            N-th step and reuse it in between; None or 0 is off, 1 gives the
            same bits as off.
        :param guidance_rescale: phi of :func:`guided_combine`.
        :param progress: a progress bar ticking once per U-Net call.
        """
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        if not (cache_interval is None or isinstance(cache_interval, int)):
            raise ValueError(f"cache_interval {cache_interval!r}: 'auto' is resolved by "
                             "sample and super_resolve")
        scheduler = self.noise_schedulers[stage]
        b = text_embeds.shape[0]
        lowres = (self.normalize_img(lowres_cond_img)
                  if self.unet_configs[stage].lowres_cond else None)
        kw = dict(text_embeds=text_embeds, text_mask=text_mask, lowres_cond_img=lowres,
                  lowres_noise_times=lowres_noise_times, cond_scale=cond_scale,
                  guided=cond_scale != 1.0, guidance_rescale=guidance_rescale)
        full = lambda v: torch.full((b,), int(v), dtype=torch.int64, device=self.device)  # noqa: E731
        img = init_noise.to(self.device, torch.float32)
        if sampler == "ddpm":
            times = np.arange(scheduler.num_timesteps - 1, -1, -1)
            if start_at is not None:
                times = times[times <= start_at]
        else:
            steps = default(sample_steps, min(50, scheduler.num_timesteps))
            pairs = scheduler.strided_sampling_timesteps(steps, grid)
            if start_at is not None:  # before the coefficients: r_i links surviving rows
                pairs = pairs[pairs[:, 0] <= start_at]
        n_calls = len(times) if sampler == "ddpm" else len(pairs)
        bar = (ProgressBar(total=n_calls, desc=f"sampling stage {stage + 1}/{self.num_unets}")
               if progress else None)
        cache: Optional[EncoderCache] = None

        def predict(img, t_scalar, idx):
            """The thresholded x0 at `t_scalar`, the down path recomputed
            or reused as `cache_interval` says."""
            nonlocal cache
            t = full(t_scalar)
            if bar is not None:
                bar.update(1)
            if not cache_interval:
                return self._predict_x_start(stage, img, t, **kw)
            if idx % cache_interval == 0:
                x0, cache = self._predict_x_start(stage, img, t, return_encoder_cache=True, **kw)
                return x0
            return self._predict_x_start(stage, img, t, encoder_cache=cache, **kw)

        try:
            if sampler == "ddpm":
                draw = self._noise_fn(noise, generator)
                for idx, t_scalar in enumerate(times):
                    x0 = predict(img, t_scalar, idx)
                    mean, _, log_var = scheduler.q_posterior(x_start=x0, x_t=img, t=full(t_scalar))
                    step_noise = draw(img.shape)
                    img = mean + (1.0 if t_scalar > 0 else 0.0) * torch.exp(0.5 * log_var) \
                        * step_noise
            elif sampler == "ddim":
                for idx, (t_scalar, tp_scalar) in enumerate(pairs):
                    x0 = predict(img, t_scalar, idx)
                    img = scheduler.ddim_step(img, x0, full(t_scalar), full(tp_scalar))
            elif sampler == "dpmpp":
                # float32 coefficients, as the JAX package's scan takes them
                coefs = scheduler.dpmpp_2m_coefficients(pairs).tolist()
                x0_prev = torch.zeros_like(img)  # c2 = 0 on step 0
                for idx, ((t_scalar, _), c) in enumerate(zip(pairs, coefs)):
                    x0 = predict(img, t_scalar, idx)
                    d = c[2] * x0 + c[3] * x0_prev
                    img = c[0] * img + c[1] * d
                    x0_prev = x0
            else:  # unipc: correct the transition that landed here, then predict
                pcoefs = scheduler.dpmpp_2m_coefficients(pairs).tolist()
                ccoefs = scheduler.unipc_c_coefficients(pairs).tolist()
                x_s0 = m0 = m1 = torch.zeros_like(img)  # rows 0 and 1 ignore them
                for idx, ((t_scalar, _), pc, cc) in enumerate(zip(pairs, pcoefs, ccoefs)):
                    m_t = predict(img, t_scalar, idx)
                    x_c = (cc[0] * img + cc[1] * x_s0 + cc[2] * m0
                           + cc[3] * (m1 - m0) + cc[4] * (m_t - m0))
                    d = pc[2] * m_t + pc[3] * m0
                    img = pc[0] * x_c + pc[1] * d
                    x_s0, m1, m0 = x_c, m0, m_t
        finally:
            if bar is not None:
                bar.close()
        return self.unnormalize_img(img.clamp(-1.0, 1.0))

    def _truncation_start(self, stage: int, start_noise_level: float, sampler: str,
                          sample_steps: Optional[int], grid: str = "time") -> int:
        """A truncation level in (0, 1] -> start timestep, clamped onto the
        strided samplers' `grid` so the init image is noised at the first t
        processed."""
        if not 0.0 < start_noise_level <= 1.0:
            raise ValueError("start_noise_level must be in (0, 1]")
        scheduler = self.noise_schedulers[stage]
        start_at = min(int(start_noise_level * scheduler.num_timesteps),
                       scheduler.num_timesteps - 1)
        if sampler in STRIDED_SAMPLERS:
            steps = default(sample_steps, min(50, scheduler.num_timesteps))
            ts = scheduler.strided_sampling_timesteps(steps, grid)[:, 0]
            on_grid = ts[ts <= start_at]
            if not on_grid.size:
                raise ValueError("start_noise_level is below the grid's smallest timestep")
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

    # ------------------------------------------------------------------ #
    # encoder-feature caching: the 'auto' decision                        #
    # ------------------------------------------------------------------ #
    # H100 constants (NVIDIA H100 80GB HBM3, 700 W), fitted to host ms per
    # guided sampling step with cache_interval None and 2 at the lite (16
    # rows) and default (8 rows) cascades' stages, three repetitions of 20
    # turns each (chip_smoke.py's measure_cache_steps and
    # fit_cache_constants; PERF.md section 6). The eager port moves
    # no bytes to reuse a cache (it keeps references), so a cached step
    # saves the down path's host dispatch or, where the card sets the pace,
    # its device time, whichever is the larger; the saving must clear the
    # spread of a step's host time. The fit turns caching on for Base and
    # Super and off for both lite stages, whose savings (~3 ms of ~20) do
    # not clear that spread.
    _HOST_S_PER_CACHED_MAP = 4.83e-4  # host dispatch per cached map (one block)
    _DOWN_FLOPS_PER_S = 2.09e14  # the down path's convolutions, bf16
    _CACHE_MIN_SAVING_S = 3.79e-3  # the median spread of a guided step's host time

    def encoder_cache_cost_model(self, stage: int, batch_size: int, text_len: int = 64,
                                 interval: int = 2) -> dict:
        """Whether caching every `interval`-th step pays at `batch_size` rows
        (pair-batched rows when guided). The cache shapes come from the
        config alone (:func:`encoder_cache_shapes`): ``cache_bytes`` is
        exact, ``down_flops_est`` counts two 3x3 C->C convs per cached map,
        as the JAX package's model does; the decision depends on shapes and
        the constants above only, never on the device at hand. `text_len`
        shapes no cached tensor."""
        shapes = encoder_cache_shapes(self.unet_configs[stage], batch_size,
                                      self.image_sizes[stage])
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        cache_bytes = sum(int(np.prod(s)) * itemsize for s in shapes)
        down_flops = sum(4.0 * 9.0 * s[1] * s[2] * (s[3] ** 2) * s[0] for s in shapes)
        saved_s = (1.0 - 1.0 / interval) * max(down_flops / self._DOWN_FLOPS_PER_S,
                                               len(shapes) * self._HOST_S_PER_CACHED_MAP)
        cost_s = self._CACHE_MIN_SAVING_S
        return dict(cache_bytes=cache_bytes, down_flops_est=down_flops, saved_s_per_step=saved_s,
                    cost_s_per_step=cost_s, enable=saved_s > cost_s)

    def _resolve_cache_interval(self, cache_interval, stage: int, batch_size: int,
                                text_len: int) -> Optional[int]:
        """'auto' -> 2 where the cost model says caching pays, else None;
        an int or None passes through."""
        if cache_interval != "auto":
            return cache_interval
        return 2 if self.encoder_cache_cost_model(stage, batch_size, text_len)["enable"] else None

    @torch.inference_mode()
    def sample(self, texts: Optional[List[str]] = None, text_masks=None, text_embeds=None,
               cond_scale: float = 1.0, lowres_sample_noise_level: Optional[float] = None,
               return_pil_images: bool = False, *,
               sampler: str = "ddpm", sample_steps: Union[int, Sequence[int], None] = None,
               grid: str = "time", cache_interval: Union[int, str, None] = "auto",
               guidance_rescale: float = 0.0, data_format: str = "NHWC",
               progress: bool = False,
               sr_start_noise_levels: Union[float, Sequence[Optional[float]], None] = None,
               return_all_stage_outputs: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[NoiseFn] = None, device=None, mesh=None):
        """Generate (b, s, s, c) NHWC images in [0, 1] for captions (or
        precomputed T5 encodings) through every stage of the cascade.

        :param sampler: 'ddpm', 'ddim', 'dpmpp' or 'unipc' (:meth:`sample_stage`).
        :param sample_steps: strided steps (default min(50, T)), or one per stage.
        :param grid: 'time', 'lambda' or 'karras' spacing of the strided samplers.
        :param cache_interval: encoder-feature caching per stage: an int
            (None or 0 off), or 'auto' (2 where the cost model says it pays,
            for the whole batch of a mesh).
        :param guidance_rescale: phi of :func:`guided_combine` (0 = plain CFG).
        :param data_format: 'NHWC' or 'NCHW' for the returned tensors.
        :param return_pil_images: PIL images of the last stage (needs PIL).
        :param progress: a progress bar per stage, one tick per U-Net call.
        :param sr_start_noise_levels: truncated refinement level in (0, 1]
            for the super-res stages (or one per stage, None = full reverse).
        :param noise: optional ``noise(shape)`` replacing every random draw
            (order in the module docstring); else ``generator`` is used.
        :param device: the reference's argument, accepted as the JAX
            package's is: sampling runs where the U-Nets are, and a device
            other than theirs raises.
        :param mesh: a ``parallel.mesh.Mesh``: every process of it calls
            this with the same captions and an equally seeded generator
            (or the same `noise`). Captions are padded by repeating the last
            one to a multiple of the data size; each process denoises its
            rows (by data index: a model group shares them) from its rows of
            the whole batch's draws, and all get the whole result back
            (padding dropped), equal to a one-device run on the padded
            batch. U-Nets trained under FSDP are gathered one stage at a
            time. On a ``model`` axis, wide kernels not placed yet are split
            over it (``parallel.tensor.place_model``, the JAX package's
            ``infer_param_shardings``) and stay so; placed ones keep their
            placement.
        """
        if data_format not in ("NHWC", "NCHW"):
            raise ValueError(f"unknown data_format {data_format!r}")
        if device is not None and torch.device(device).type != self.device.type:
            raise ValueError(f"sample(device={device!r}): the U-Nets are on {self.device}")
        text_embeds, text_masks = self._text_inputs(texts, text_embeds, text_masks)
        if cond_scale != 1.0 and not self.can_classifier_guidance:
            raise ValueError("classifier-free guidance needs a model trained with cond_drop_prob > 0")
        draw = self._noise_fn(noise, generator)
        b = text_embeds.shape[0]
        total = b
        gathered = lambda params: contextlib.nullcontext()  # noqa: E731
        if mesh is not None:
            from ..parallel.mesh import gather_rows, gathered  # noqa: PLC0415
            from ..parallel.tensor import place_model  # noqa: PLC0415
            place_model(self.unets, mesh)  # a model axis: wide kernels not yet placed
            pad = (-b) % mesh.size
            if pad:
                text_embeds = torch.cat([text_embeds, text_embeds[-1:].expand(pad, -1, -1)])
                if text_masks is not None:
                    text_masks = torch.cat([text_masks, text_masks[-1:].expand(pad, -1)])
            total = b + pad
            rows = mesh.rows(total)
            text_embeds = text_embeds[rows]
            text_masks = None if text_masks is None else text_masks[rows]
            draw = rows_of_draws(draw, total, rows)
        options = dict(cond_scale=cond_scale, sampler=sampler, sample_steps=sample_steps,
                       grid=grid, cache_interval=cache_interval,
                       guidance_rescale=guidance_rescale, progress=progress,
                       lowres_sample_noise_level=lowres_sample_noise_level,
                       sr_start_noise_levels=sr_start_noise_levels)
        img, outputs = None, []
        for stage in range(self.num_unets):
            with gathered(self.unets[stage].parameters()):  # FSDP: one stage at a time
                img = self.cascade_stage(stage, img, text_embeds, text_masks, draw=draw,
                                         total_rows=total, **options)
            outputs.append(img)
        if mesh is not None:
            outputs = [gather_rows(o, mesh, total)[:b] for o in outputs]
            img = outputs[-1]
        if return_pil_images:
            return [_to_pil(im) for im in img.float().cpu().numpy()]
        if data_format == "NCHW":
            outputs = [o.permute(0, 3, 1, 2) for o in outputs]
        return outputs if return_all_stage_outputs else outputs[-1]

    @torch.inference_mode()
    def cascade_stage(self, stage: int, img, text_embeds, text_masks, *, draw: NoiseFn,
                      total_rows: int, cond_scale: float = 1.0, sampler: str = "ddpm",
                      sample_steps=None, grid: str = "time", cache_interval="auto",
                      guidance_rescale: float = 0.0, progress: bool = False,
                      lowres_sample_noise_level: Optional[float] = None,
                      sr_start_noise_levels=None) -> torch.Tensor:
        """One stage of :meth:`sample` over the rows of `text_embeds` from the
        previous stage's `img` (None for the first): its low-res condition and
        truncated start (super-res stages), its initial image and its reverse
        process, its draws from `draw`. `total_rows` is the whole batch's
        row count, which 'auto' caching decides by."""
        per_stage = lambda v: v[stage] if isinstance(v, (list, tuple)) else v  # noqa: E731
        noise_level = default(lowres_sample_noise_level, self.lowres_sample_noise_level)
        size = self.image_sizes[stage]
        steps = per_stage(sample_steps)
        lowres = lowres_times = start_at = None
        if self.unet_configs[stage].lowres_cond:
            lowres, lowres_times = self._lowres_condition(stage, img, noise_level, draw)
            sr_level = per_stage(sr_start_noise_levels)
            if sr_level is not None:
                start_at = self._truncation_start(stage, sr_level, sampler, steps, grid)
        shape = (text_embeds.shape[0], size, size, self.channels)
        init = (draw(shape) if start_at is None
                else self._truncation_init(stage, img, start_at, draw(shape)))
        rows = total_rows * (2 if cond_scale != 1.0 else 1)
        return self.sample_stage(
            stage, text_embeds, text_masks, cond_scale, init_noise=init,
            lowres_cond_img=lowres, lowres_noise_times=lowres_times, sampler=sampler,
            sample_steps=steps, start_at=start_at, grid=grid,
            cache_interval=self._resolve_cache_interval(cache_interval, stage, rows,
                                                        text_embeds.shape[1]),
            guidance_rescale=guidance_rescale, progress=progress, noise=draw)

    @torch.inference_mode()
    def super_resolve(self, images, *, stage: int = 1, texts: Optional[List[str]] = None,
                      text_embeds=None, text_masks=None, cond_scale: float = 1.0,
                      lowres_sample_noise_level: Optional[float] = None,
                      sampler: str = "ddim", sample_steps: Optional[int] = None,
                      grid: str = "time", cache_interval: Union[int, str, None] = "auto",
                      start_noise_level: Optional[float] = None, guidance_rescale: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[NoiseFn] = None):
        """Upscale existing (b, h, w, c) [0, 1] images through one super-res
        stage; `start_noise_level` refines instead of reversing from noise.
        Draws: augmentation noise, then the initial image."""
        if not (1 <= stage < self.num_unets and self.unet_configs[stage].lowres_cond):
            raise ValueError(f"stage {stage} is not a super-resolution stage")
        text_embeds, text_masks = self._text_inputs(texts, text_embeds, text_masks)
        if cond_scale != 1.0 and not self.can_classifier_guidance:
            raise ValueError("classifier-free guidance needs a model trained with cond_drop_prob > 0")
        draw = self._noise_fn(noise, generator)
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        b = images.shape[0]
        if b != text_embeds.shape[0]:
            raise ValueError(f"{b} images for {text_embeds.shape[0]} text encodings")
        noise_level = default(lowres_sample_noise_level, self.lowres_sample_noise_level)
        lowres, lowres_times = self._lowres_condition(stage, images, noise_level, draw)
        size = self.image_sizes[stage]
        shape = (b, size, size, self.channels)
        start_at = None
        if start_noise_level is not None:
            start_at = self._truncation_start(stage, start_noise_level, sampler, sample_steps,
                                              grid)
            init = self._truncation_init(stage, images, start_at, draw(shape))
        else:
            init = draw(shape)
        rows = b * (2 if cond_scale != 1.0 else 1)
        return self.sample_stage(
            stage, text_embeds, text_masks, cond_scale, init_noise=init,
            lowres_cond_img=lowres, lowres_noise_times=lowres_times, sampler=sampler,
            sample_steps=sample_steps, start_at=start_at, grid=grid,
            cache_interval=self._resolve_cache_interval(cache_interval, stage, rows,
                                                        text_embeds.shape[1]),
            guidance_rescale=guidance_rescale, noise=draw)

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
        noise, lowres_noise, keep_mask = self._noise_draws(
            x_start.shape, lowres_cond_img is not None, generator, noise, lowres_noise, keep_mask)
        x_start = self.normalize_img(x_start)
        x_noisy = scheduler.q_sample(x_start=x_start, t=times, noise=noise)
        lowres_noisy = None
        if lowres_cond_img is not None:
            lowres_cond_img = self.normalize_img(lowres_cond_img)
            lowres_aug_times = default(lowres_aug_times, times)
            lowres_noisy = self.lowres_noise_schedule.q_sample(
                x_start=lowres_cond_img, t=lowres_aug_times, noise=lowres_noise)
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
        draws = self.stage_draws(stage, b, generator, times=times,
                                 lowres_aug_times=lowres_aug_times, noise=noise,
                                 lowres_noise=lowres_noise, keep_mask=keep_mask)
        lowres = None
        if stage > 0:
            clamp = self.input_image_range
            lowres = resize_image_to(images, self.image_sizes[stage - 1], clamp_range=clamp)
            lowres = resize_image_to(lowres, size, clamp_range=clamp)
        return self.p_losses(stage, resize_image_to(images, size), text_embeds=text_embeds,
                             text_mask=text_mask, lowres_cond_img=lowres, **draws)

    def stage_memory_analysis(self, stage: int, *, batch_size: int = 1, text_len: int = 64,
                              cond_scale: float = 3.0, sampler: str = "ddim",
                              sample_steps: Optional[int] = None,
                              params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, int]:
        """The memory of one full sampling pass of `stage` (the JAX
        package's ``stage_memory_analysis``, ``imagen.py:743-779``, with its
        field names), for zero captions of `text_len` tokens:

        - ``argument_size_in_bytes``: the stage's parameters (`params`, a
          state_dict of its U-Net, else its own) plus its inputs, as the JAX
          function takes them: the float32 encodings, the bool masks, the
          float32 guidance scale, for a super-resolution stage the float32
          low-res image and the int32 noise times, and 8 bytes of
          randomness (the JAX function's key; here the generator's 64-bit
          seed);
        - ``output_size_in_bytes``: the stage's float32 (b, s, s, c) output;
        - ``temp_size_in_bytes``, on the card only: the measured peak of the
          pass above what was allocated before it
          (``torch.cuda.reset_peak_memory_stats`` /
          ``max_memory_allocated``), the output included.

        On the CPU the first two are returned and the third is left out (no
        allocator statistics), as the JAX package returns the fields its
        backend can answer. The pass runs with `params` swapped in, and the
        U-Net's own parameters put back after."""
        unet = self.unets[stage]
        own = dict(unet.named_parameters())
        params = own if params is None else params
        if set(params) != set(own):
            raise ValueError(f"params of unet_{stage}: {len(params)} tensors, the U-Net has "
                             f"{len(own)} parameters")
        size, c = self.image_sizes[stage], self.channels
        inputs = {"text_embeds": torch.zeros(batch_size, text_len, self.text_embed_dim,
                                             device=self.device),
                  "text_mask": torch.ones(batch_size, text_len, dtype=torch.bool,
                                          device=self.device)}
        kw = {}
        if self.unet_configs[stage].lowres_cond:
            kw = {"lowres_cond_img": torch.zeros(batch_size, size, size, c, device=self.device),
                  "lowres_noise_times": self.lowres_noise_schedule.get_times(
                      batch_size, self.lowres_sample_noise_level, self.device).int()}
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
        out = {"argument_size_in_bytes": nbytes(params.values()) + nbytes(inputs.values())
               + nbytes(kw.values()) + 4 + 8,
               "output_size_in_bytes": batch_size * size * size * c * 4}
        if self.device.type != "cuda":
            return out
        saved = {n: p.data for n, p in own.items()}
        try:
            for n, p in own.items():
                p.data = params[n].detach()
            torch.cuda.synchronize(self.device)
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            gen = torch.Generator(device=self.device).manual_seed(0)
            with torch.inference_mode():
                init = torch.randn(batch_size, size, size, c, generator=gen, device=self.device)
                img = self.sample_stage(stage, inputs["text_embeds"], inputs["text_mask"],
                                        cond_scale, init_noise=init, sampler=sampler,
                                        sample_steps=sample_steps, generator=gen, **kw)
            torch.cuda.synchronize(self.device)
            out["temp_size_in_bytes"] = torch.cuda.max_memory_allocated(self.device) - before
            del img, init
        finally:
            for n, p in own.items():
                p.data = saved[n]
        return out

    def stage_draws(self, stage: int, batch_size: int, generator: Optional[torch.Generator] = None,
                    *, times: Optional[torch.Tensor] = None,
                    lowres_aug_times: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    lowres_noise: Optional[torch.Tensor] = None,
                    keep_mask: Optional[torch.Tensor] = None) -> dict:
        """Every random draw of :meth:`stage_loss` for `batch_size` rows, the
        given ones kept and the others drawn from `generator` in the
        documented order. Each has the batch as its first axis, so a process
        of a mesh draws the global batch's and keeps its rows."""
        if times is None:
            times = self.noise_schedulers[stage].sample_random_times(batch_size, generator)
        if stage > 0 and lowres_aug_times is None:
            lowres_aug_times = self.lowres_noise_schedule.sample_random_times(
                1, generator).expand(batch_size)
        size = self.image_sizes[stage]
        noise, lowres_noise, keep_mask = self._noise_draws(
            (batch_size, size, size, self.channels), stage > 0, generator, noise, lowres_noise,
            keep_mask)
        draws = dict(times=times, noise=noise, keep_mask=keep_mask)
        if stage > 0:
            draws.update(lowres_aug_times=lowres_aug_times, lowres_noise=lowres_noise)
        return draws

    def _noise_draws(self, shape, lowres: bool, generator, noise, lowres_noise, keep_mask):
        """The noise (with its offset), the low-res noise and the keep mask
        of :meth:`p_losses`, drawn where not given."""
        draw = self._noise_fn(None, generator)
        if noise is None:
            noise = draw(shape)
            if self.offset_noise_scale > 0.0:
                noise = noise + self.offset_noise_scale * draw((shape[0], 1, 1, shape[-1]))
        if lowres and lowres_noise is None:
            lowres_noise = draw(shape)
        if keep_mask is None:
            keep_mask = prob_mask_like((shape[0],), 1.0 - self.cond_drop_prob,
                                       generator=generator, device=self.device)
        return noise, lowres_noise, keep_mask

    def forward(self, images, texts: Optional[List[str]] = None, text_embeds=None,
                text_masks=None, unet_number: Optional[int] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training loss of U-Net `unet_number` (1-based; required for a
        cascade) on [0, 1] NHWC `images` and their captions or encodings."""
        if self.num_unets > 1 and unet_number is None:
            raise ValueError(f"pass unet_number, 1 to {self.num_unets}, to train a cascade")
        unet_number = default(unet_number, 1)
        if self.only_train_unet_number is not None and self.only_train_unet_number != unet_number:
            raise ValueError(f"you can only train on unet #{self.only_train_unet_number}")
        stage = unet_number - 1
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
