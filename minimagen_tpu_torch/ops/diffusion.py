"""Gaussian diffusion schedule (counterpart of ``minimagen_tpu/ops/diffusion.py``).

The linear beta schedule (scaled by 1000/T) is computed in float64 numpy and
stored as float32 tensors, exactly as the JAX package does, so both hold the
same buffers bit for bit. What sampling and training use is ported here:
``q_sample``, ``q_posterior``, ``predict_start_from_noise``, the ``time``,
``lambda`` and ``karras`` grids of ``strided_sampling_timesteps``,
``ddim_step``, ``sample_random_times`` and the host-side per-step
coefficients of the DPM-Solver++(2M) and UniPC-2 samplers. The grids and
coefficients are numpy in float64 over the float32 ``alphas_cumprod``, cast
to float32, as the JAX package computes them, so both give the same arrays.
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
        # the float32 buffer in float64, for the host-side grids and coefficients
        self._abar = sched["alphas_cumprod"].astype(np.float32).astype(np.float64)

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
        """(n, 2) int64 array of descending (t, t_prev) pairs over [0, T),
        ending at t=0 with t_prev=-1; n <= num_steps, as duplicate timesteps
        collapse.

        :param spacing: ``time`` (even timesteps), ``lambda`` (even steps in
            log-SNR lambda = log(alpha/sigma), the DPM-Solver grid) or
            ``karras`` (even steps in sigma^(1/7), sigma = sqrt((1-abar)/abar),
            the EDM grid); the last two invert the discrete schedule by
            nearest lookup.
        """
        if not 1 <= num_steps <= self.num_timesteps:
            raise ValueError(f"num_steps {num_steps} outside [1, {self.num_timesteps}]")
        if spacing == "time":
            ts = np.linspace(0, self.num_timesteps - 1, num_steps).round().astype(np.int64)
        elif spacing == "karras":
            ac = self._abar[: self.num_timesteps]
            warped = np.sqrt((1.0 - ac) / ac) ** (1.0 / 7.0)  # decreasing as t -> 0
            targets = np.linspace(warped[-1], warped[0], num_steps)
            ts = np.abs(warped[None, :] - targets[:, None]).argmin(axis=1)
        elif spacing == "lambda":
            ac = self._abar
            lam = 0.5 * (np.log(ac) - np.log1p(-ac))  # increasing as t -> 0
            targets = np.linspace(lam[self.num_timesteps - 1], lam[0], num_steps)
            ts = np.abs(lam[None, : self.num_timesteps] - targets[:, None]).argmin(axis=1)
        else:
            raise ValueError(f"unknown spacing {spacing!r}")
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

    def dpmpp_2m_coefficients(self, pairs: np.ndarray) -> np.ndarray:
        """(n, 4) float32 (ratio, coef, c1, c2) per step of DPM-Solver++(2M)
        (Lu et al., arXiv 2211.01095, data prediction) over the (already
        truncated) `pairs`: with x0_i the thresholded data prediction,

            D_i = c1 * x0_i + c2 * x0_{i-1};  x <- ratio * x + coef * D_i

        ratio = sigma_prev/sigma_t, coef = alpha_prev * (1 - e^{-h_i}),
        h_i = lambda_prev - lambda_t, c2 = -1/(2 r_i) with r_i = h_{i-1}/h_i,
        c1 = 1 - c2. The first step and the last (to t_prev = -1: ratio 0,
        coef 1, x0 returned) are first order. A constant x0 makes the update
        DDIM's."""
        pairs = np.asarray(pairs, np.int64)
        ac = self._abar
        t, tp = pairs[:, 0], pairs[:, 1]
        last = tp < 0
        a_t, s_t = np.sqrt(ac[t]), np.sqrt(1.0 - ac[t])
        lam_t = np.log(a_t / s_t)
        tp_safe = np.maximum(tp, 0)
        a_p = np.where(last, 1.0, np.sqrt(ac[tp_safe]))
        s_p = np.where(last, 0.0, np.sqrt(1.0 - ac[tp_safe]))
        with np.errstate(divide="ignore"):
            lam_p = np.where(last, np.inf, np.log(a_p / np.where(last, 1.0, s_p)))
        h = lam_p - lam_t
        ratio = np.where(last, 0.0, s_p / s_t)
        coef = a_p * (-np.expm1(-h))
        h_prev = np.concatenate([[np.nan], h[:-1]])
        first = np.arange(len(t)) == 0
        with np.errstate(invalid="ignore", divide="ignore"):
            c2 = np.where(first | last, 0.0, -1.0 / (2.0 * (h_prev / h)))
        out = np.stack([ratio, coef, 1.0 - c2, c2], axis=1).astype(np.float32)
        if not np.all(np.isfinite(out)):
            raise ValueError("non-finite DPM++ coefficients")
        return out

    def unipc_c_coefficients(self, pairs: np.ndarray) -> np.ndarray:
        """(n, 5) float32 (c_self, cr, cm0, cd1, cdt) per step of the UniC-2
        corrector of UniPC (Zhao et al., arXiv 2302.04867, data prediction,
        B(h) = e^{-h} - 1, 'bh2'). Row i runs at grid point i, after the
        model gave x0_t there, and re-integrates the transition s0 = t_{i-1}
        -> t = t_i from the corrected previous sample x_s0:

            x_c = c_self*x + cr*x_s0 + cm0*x0_s0 + cd1*(x0_s1 - x0_s0)
                  + cdt*(x0_t - x0_s0)

        Row 0 is the identity, row 1 order 1 (cd1 = 0), rows 2+ order 2 with
        the rho weights solved exactly at each step's h. The predictor is
        :meth:`dpmpp_2m_coefficients`. A constant x0 makes the corrected
        trajectory DDIM's."""
        pairs = np.asarray(pairs, np.int64)
        k = len(pairs)
        out = np.zeros((k, 5), np.float64)
        out[0, 0] = 1.0
        if k > 1:
            a = np.sqrt(self._abar)
            s = np.sqrt(1.0 - self._abar)
            lam = np.log(a / s)
            for i in range(1, k):
                s0, t = pairs[i - 1]
                if t != pairs[i, 0] or t < 0:
                    raise ValueError("pairs are not a chain of descending timesteps")
                h = lam[t] - lam[s0]
                hh = -h
                h_phi_1 = np.expm1(hh)
                b_h = h_phi_1
                b0 = (h_phi_1 / hh - 1.0) / b_h
                rho_hist, rho_t, r1 = 0.0, b0, 1.0
                if i >= 2:
                    s1 = pairs[i - 2, 0]
                    r1 = (lam[s1] - lam[s0]) / h
                    h_phi_2 = (h_phi_1 / hh - 1.0) / hh - 0.5
                    b1 = 2.0 * h_phi_2 / b_h
                    # [[1, 1], [r1, 1]] @ [rho_hist, rho_t] = [b0, b1]
                    rho_hist = (b0 - b1) / (1.0 - r1)
                    rho_t = b0 - rho_hist
                out[i] = (0.0, s[t] / s[s0], -a[t] * h_phi_1,
                          -a[t] * b_h * rho_hist / r1, -a[t] * b_h * rho_t)
        res = out.astype(np.float32)
        if not np.all(np.isfinite(res)):
            raise ValueError("non-finite UniPC corrector coefficients")
        return res
