"""The plain reference of the cascade around the U-Nets: the diffusion
schedule, the guided and thresholded x0 prediction, the DDIM step, the
low-res conditioning, the training loss and clip-50 Adam.

MinImagen's semantics written out plainly in float32 (float64 where a
schedule is built), from the papers and the reference's code: the linear
beta schedule scaled to 1000/T (Ho et al. 2020), classifier-free guidance
``null + (cond - null) * scale`` (Ho and Salimans 2022), dynamic
thresholding at the 0.9 quantile of |x0| (Saharia et al. 2022), DDIM with
eta 0 (Song et al. 2021), resize_right's cubic resampling with antialiasing
and reflected edges, and optax's ``clip_by_global_norm(50)`` then
``adam(lr, 0.9, 0.999, 1e-8)``. Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from .unet import Unet


class Schedule:
    """The linear beta schedule of `timesteps` steps, float32 on `device`."""

    def __init__(self, timesteps: int, device):
        scale = 1000.0 / timesteps
        betas = np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)
        abar = np.cumprod(1.0 - betas)
        self.T = timesteps
        self.abar_host = abar.astype(np.float32).astype(np.float64)
        self.abar = torch.as_tensor(abar.astype(np.float32), device=device)
        self.sqrt_abar = torch.as_tensor(np.sqrt(abar).astype(np.float32), device=device)
        self.sqrt_1m_abar = torch.as_tensor(np.sqrt(1.0 - abar).astype(np.float32), device=device)

    def q_sample(self, x0, t, noise):
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return self.sqrt_abar[t].view(shape) * x0 + self.sqrt_1m_abar[t].view(shape) * noise

    def ddim_pairs(self, steps: int) -> np.ndarray:
        """(t, t_prev) pairs of DDIM over evenly spaced timesteps, ending at -1."""
        ts = np.unique(np.linspace(0, self.T - 1, steps).round().astype(np.int64))[::-1]
        return np.stack([ts, np.concatenate([ts[1:], [-1]])], axis=1)

    def ddim_step(self, x_t, x0, t: int, t_prev: int):
        """Deterministic DDIM (eta 0) from `t` to `t_prev` (-1: to x0), in
        x_t's dtype with the schedule's coefficients as numbers."""
        ab_t = self.abar_host[t]
        ab_p = 1.0 if t_prev < 0 else self.abar_host[t_prev]
        eps = (x_t - math.sqrt(ab_t) * x0) * (1.0 / math.sqrt(1.0 - ab_t))
        return math.sqrt(ab_p) * x0 + math.sqrt(1.0 - ab_p) * eps


def threshold(x0: torch.Tensor, percentile: float) -> torch.Tensor:
    """Dynamic thresholding: clamp to the per-image quantile s of |x0| (at
    least 1) and divide by s."""
    flat = x0.reshape(x0.shape[0], -1).abs().float()
    s = torch.quantile(flat, percentile, dim=-1).clamp(min=1.0)
    s = s.view(-1, 1, 1, 1).to(x0.dtype)
    return torch.maximum(torch.minimum(x0, s), -s) / s


def unet_pair(unet: Unet, x_t, t: int, *, text_embeds, text_mask, lowres_cond_img=None,
              lowres_noise_times=None) -> torch.Tensor:
    """The U-Net's (2b, ...) output over the conditioned rows then the
    null-conditioned rows, run as one batch."""
    b = x_t.shape[0]
    dup = lambda a: None if a is None else torch.cat([a, a])  # noqa: E731
    keep = torch.cat([torch.ones(b, dtype=torch.bool, device=x_t.device),
                      torch.zeros(b, dtype=torch.bool, device=x_t.device)])
    times = torch.full((2 * b,), t, dtype=torch.long, device=x_t.device)
    return unet(dup(x_t), times, text_embeds=dup(text_embeds), text_mask=dup(text_mask),
                text_keep_mask=keep, lowres_cond_img=dup(lowres_cond_img),
                lowres_noise_times=dup(lowres_noise_times)).float()


def ddim_from_output(sched: Schedule, out: torch.Tensor, x_t, t: int, t_prev: int, *,
                     cond_scale: float, percentile: float, dtype=torch.float32):
    """One guided DDIM step from a pair output of the U-Net: guidance,
    x0 from the noise, dynamic thresholding, the DDIM update; computed in
    `dtype`, returned in float32."""
    b = x_t.shape[0]
    out, x = out.to(dtype), x_t.to(dtype)
    pred = out[b:] + (out[:b] - out[b:]) * cond_scale
    ab = sched.abar_host[t]
    x0 = math.sqrt(1.0 / ab) * x - math.sqrt(1.0 / ab - 1.0) * pred
    return sched.ddim_step(x, threshold(x0, percentile), t, t_prev).float()


# --------------------------------------------------------------------------- #
# resize_right: cubic, antialiased, reflected edges                            #
# --------------------------------------------------------------------------- #
def _cubic(x):
    ax = np.abs(x)
    return ((1.5 * ax ** 3 - 2.5 * ax ** 2 + 1.0) * (ax <= 1.0)
            + (-0.5 * ax ** 3 + 2.5 * ax ** 2 - 4.0 * ax + 2.0) * ((ax > 1.0) & (ax <= 2.0)))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 resampling matrix of resize_right's cubic."""
    scale = n_out / n_in
    grid = np.arange(n_out) / scale + (n_in - 1) / 2.0 - (n_out - 1) / (2.0 * scale)
    eps = float(np.finfo(np.float32).eps)
    if scale < 1.0:
        support, kernel = 4.0 / scale, lambda x: scale * _cubic(scale * x)
    else:
        support, kernel = 4.0, _cubic
    left = np.ceil(grid - support / 2.0 - eps).astype(np.int64)
    taps = left[:, None] + np.arange(int(math.ceil(support - eps)))[None, :]
    w = kernel(grid[:, None] - taps)
    s = w.sum(axis=1, keepdims=True)
    w = w / np.where(s == 0, 1.0, s)
    period = 2 * (n_in - 1)
    src = np.mod(taps, period)
    src = np.where(src < n_in, src, period - src)
    mat = np.zeros((n_out, n_in))
    np.add.at(mat, (np.broadcast_to(np.arange(n_out)[:, None], taps.shape), src), w)
    return mat


def resize(images: torch.Tensor, size: int, clamp: bool = False) -> torch.Tensor:
    """(b, h, w, c) -> (b, size, size, c)."""
    if images.shape[1] == size:
        return images
    m = torch.as_tensor(resize_matrix(images.shape[1], size), dtype=images.dtype,
                        device=images.device)
    out = torch.einsum("yh,xw,bhwc->byxc", m, m, images)
    return out.clamp(0.0, 1.0) if clamp else out


def lowres_condition(stage_out01, size: int, sched: Schedule, noise_level: float, noise):
    """The super-resolution stage's conditioning image in [-1, 1] and its
    times: the previous stage's [0, 1] output resized and noised at a fixed
    level (in [0, 1] space), then normalised."""
    b = stage_out01.shape[0]
    times = torch.full((b,), int(sched.T * noise_level), dtype=torch.long,
                       device=stage_out01.device)
    noised = sched.q_sample(resize(stage_out01, size), times, noise)
    return noised * 2.0 - 1.0, times


# --------------------------------------------------------------------------- #
# training                                                                     #
# --------------------------------------------------------------------------- #
def stage_loss(unet: Unet, sched: Schedule, stage: int, sizes: Sequence[int], images, encoding,
               mask, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """MSE of the predicted noise for stage `stage` on [0, 1] images."""
    size = sizes[stage]
    x0 = resize(images, size) * 2.0 - 1.0
    x_noisy = sched.q_sample(x0, draws["times"], draws["noise"])
    lowres = lowres_times = None
    if stage > 0:
        low = resize(resize(images, sizes[stage - 1], clamp=True), size, clamp=True)
        lowres_times = draws["lowres_aug_times"]
        lowres = sched.q_sample(low * 2.0 - 1.0, lowres_times, draws["lowres_noise"])
    pred = unet(x_noisy, draws["times"], text_embeds=encoding, text_mask=mask,
                text_keep_mask=draws["keep_mask"], lowres_cond_img=lowres,
                lowres_noise_times=lowres_times).float()
    return (pred - draws["noise"]).square().mean()


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(50), adam(lr))`` over float32 leaves."""

    def __init__(self, params: List[torch.Tensor], lr: float, clip: float = 50.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.clip, self.b1, self.b2, self.eps = params, lr, clip, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Clip `grads` in place and apply one update; returns them."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
        factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        for g in grads:
            g.mul_(factor)
        self.count += 1
        bc1 = 1.0 - float(np.float32(self.b1) ** np.float32(self.count))
        bc2 = 1.0 - float(np.float32(self.b2) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))
        return grads


def build_unets(unet_cfgs, state_dicts, device) -> List[Unet]:
    """Reference U-Nets in float32 on `device` holding `state_dicts`."""
    nets = []
    for cfg, sd in zip(unet_cfgs, state_dicts):
        with torch.device(device):
            net = Unet(cfg)
        net.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
        nets.append(net.eval())
    return nets


def no_tf32() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
