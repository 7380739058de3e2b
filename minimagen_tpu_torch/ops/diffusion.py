"""Gaussian diffusion schedule (counterpart of ``minimagen_tpu/ops/diffusion.py``).

The linear beta schedule (scaled by 1000/T) is computed in float64 numpy and
stored as float32 tensors, exactly as the JAX package does, so both hold the
same buffers bit for bit. What sampling and training use is ported here:
``q_sample``, ``q_posterior``, ``predict_start_from_noise``, the ``time`` grid
of ``strided_sampling_timesteps``, ``ddim_step`` and ``sample_random_times``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .helpers import extract

_BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2",
)


def _schedule_np(timesteps: int) -> dict:
    """The float64 schedule, with abar floored at 1e-20 for the reciprocal
    and log buffers (the JAX package's T=20 edge handling)."""
    if timesteps < 20:
        raise ValueError("timesteps must be at least 20")
    scale = 1000.0 / timesteps
    betas = np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas, axis=0)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    ac_safe = np.clip(ac, 1e-20, None)
    return dict(
        betas=betas,
        alphas_cumprod=ac,
        alphas_cumprod_prev=ac_prev,
        sqrt_alphas_cumprod=np.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        log_one_minus_alphas_cumprod=np.log(np.clip(1.0 - ac, 1e-20, None)),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac_safe),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac_safe - 1.0),
        posterior_variance=post_var,
        posterior_log_variance_clipped=np.log(np.clip(post_var, 1e-20, None)),
        posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
    )


class GaussianDiffusion:
    """Schedule buffers (float32, on `device`) plus the closed forms."""

    def __init__(self, timesteps: int, device="cuda"):
        self.num_timesteps = int(timesteps)
        sched = _schedule_np(self.num_timesteps)
        for name in _BUFFERS:
            setattr(self, name, torch.as_tensor(sched[name].astype(np.float32), device=device))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps."""
        nd = x_start.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor,
                                 noise: torch.Tensor) -> torch.Tensor:
        nd = x_t.ndim
        return (extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def q_posterior(self, x_start: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor):
        """Mean, variance and clipped log-variance of q(x_{t-1} | x_t, x_0)."""
        nd = x_t.ndim
        mean = (extract(self.posterior_mean_coef1, t, nd) * x_start
                + extract(self.posterior_mean_coef2, t, nd) * x_t)
        return (mean, extract(self.posterior_variance, t, nd),
                extract(self.posterior_log_variance_clipped, t, nd))

    def sample_random_times(self, batch_size: int,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Uniform integer timesteps in [0, T), drawn from `generator` on the
        schedule's device."""
        return torch.randint(0, self.num_timesteps, (batch_size,), generator=generator,
                             device=self.betas.device)

    def get_times(self, batch_size: int, noise_level: float, device="cuda") -> torch.Tensor:
        """Full batch of the timestep at a fixed noise level."""
        return torch.full((batch_size,), int(self.num_timesteps * noise_level),
                          dtype=torch.int64, device=device)

    def strided_sampling_timesteps(self, num_steps: int, spacing: str = "time") -> np.ndarray:
        """(num_steps, 2) int64 array of descending (t, t_prev) pairs, evenly
        strided over [0, T) and ending at t=0 with t_prev=-1. Only the
        ``time`` grid is ported; ``lambda`` and ``karras`` come with the
        DPM-Solver++ and UniPC samplers."""
        if not 1 <= num_steps <= self.num_timesteps:
            raise ValueError(f"num_steps {num_steps} outside [1, {self.num_timesteps}]")
        if spacing != "time":
            raise NotImplementedError(f"spacing {spacing!r} is not ported yet")
        ts = np.linspace(0, self.num_timesteps - 1, num_steps).round().astype(np.int64)
        ts = np.unique(ts)[::-1]
        t_prev = np.concatenate([ts[1:], [-1]])
        return np.stack([ts, t_prev], axis=1)

    def ddim_step(self, x_t: torch.Tensor, x0: torch.Tensor, t: torch.Tensor,
                  t_prev: torch.Tensor) -> torch.Tensor:
        """Deterministic DDIM (eta=0) update from `t` to `t_prev`;
        `t_prev < 0` means "to x0"."""
        nd = x_t.ndim
        abar_t = extract(self.alphas_cumprod, t, nd)
        tp = t_prev.reshape(t_prev.shape[0], *((1,) * (nd - 1)))
        abar_prev = torch.where(tp < 0, torch.ones_like(abar_t),
                                extract(self.alphas_cumprod, t_prev.clamp(min=0), nd))
        eps = (x_t - abar_t.sqrt() * x0) * torch.rsqrt(1.0 - abar_t)
        return abar_prev.sqrt() * x0 + (1.0 - abar_prev).sqrt() * eps
