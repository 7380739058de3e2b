"""Quality metrics and rows of the synthetic shapes set (counterparts of
``tools/flagship_quality_eval.py``): ``color_metric`` and ``grad_mean`` with
the palette of ``data/dataset.py``, ``psnr_db``, and the rows ``sr_rows``
(``eval_sr``, :384-408) and ``holdout_rows`` (``eval_holdout``, :320-356) of
a lite cascade, and ``trunc_row`` (the ``trunc/sr*`` rows), each for one seed
of the port's generator (the tool's JAX keys draw other noise).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .data.dataset import _SYNTH_COLORS as SYNTH_COLORS  # colour name -> RGB in [0, 1]
from .data.dataset import NUM_SYNTH_COMBOS, _draw_synthetic, synthetic_combo_caption


def color_metric(images: np.ndarray, captions) -> float:
    """Mean L2 distance between the generated shape's mean colour and the
    caption's colour, in [0, 1] RGB (lower is better; a random palette colour
    averages ~0.55). Shape pixels are those far from the 0.92-grey
    background; an image with fewer than 20 of them scores 1."""
    dists = []
    for img, cap in zip(images, captions):
        target = np.array(SYNTH_COLORS[cap.split()[1]], np.float32)
        mask = np.abs(img - 0.92).max(axis=-1) > 0.25
        if mask.sum() < 20:
            dists.append(1.0)
            continue
        dists.append(float(np.linalg.norm(img[mask].mean(axis=0) - target)))
    return float(np.mean(dists))


def grad_mean(images: np.ndarray) -> float:
    """High-frequency noise proxy: mean |neighbour difference| over (b, h, w, c)
    images; a clean sample of the piecewise-flat set sits near 0.01, noise
    near 0.3."""
    gx = float(np.abs(np.diff(images, axis=2)).mean())
    gy = float(np.abs(np.diff(images, axis=1)).mean())
    return (gx + gy) / 2.0


def psnr_db(a, b) -> float:
    """PSNR of [0, 1] images, as the tool computes it (99 for equal ones)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(1.0 / mse)


SR_ITEMS = (0, 1, 7, 13)
SR_LEVELS = (0.2, 0.4)


def numpy_noise(seed: int, device):
    """A draw function for the samplers' ``noise=``: float32 standard
    normals from numpy's generator seeded `seed`, in call order, so that
    the JAX package can be given the same draws."""
    rng = np.random.default_rng(seed)
    return lambda shape: torch.from_numpy(
        rng.standard_normal(tuple(shape), dtype=np.float32)).to(device)


def sr_rows(imagen, seed: int = 3, steps: int = 50, cond_scale: float = 3.0,
            numpy_draws: bool = False) -> Dict[str, dict]:
    """``eval_sr``: items 0, 1, 7 and 13 of the synthetic set at the last
    stage's size, resized to the one before, super-resolved from start
    levels 0.2 and 0.4 (DDIM-`steps`, no caching, the generator seeded
    `seed` for each level, or with `numpy_draws` :func:`numpy_noise` seeded
    `seed`: the augmentation noise, then the initial image); PSNR against
    the originals beside the bicubic baseline."""
    from .ops.resize import resize_image_to  # noqa: PLC0415

    hi, lo = imagen.image_sizes[-1], imagen.image_sizes[-2]
    gt, caps = zip(*[_draw_synthetic(i, hi) for i in SR_ITEMS])
    gt = np.stack(gt)
    embeds, masks = imagen.encode_text(list(caps))
    low = resize_image_to(torch.as_tensor(gt, device=imagen.device), lo)
    bicubic = psnr_db(resize_image_to(low, hi).float().cpu().numpy(), gt)
    rows = {}
    for level in SR_LEVELS:
        draws = dict(noise=numpy_noise(seed, imagen.device)) if numpy_draws else dict(
            generator=torch.Generator(device=imagen.device).manual_seed(seed))
        out = imagen.super_resolve(low, stage=imagen.num_unets - 1, text_embeds=embeds,
                                   text_masks=masks, cond_scale=cond_scale, sampler="ddim",
                                   sample_steps=steps, start_noise_level=level,
                                   cache_interval=None, **draws).float().cpu().numpy()
        rows[f"sr/start{level}"] = dict(psnr_db=psnr_db(out, gt), bicubic_baseline_db=bicubic,
                                        finite=bool(np.isfinite(out).all()))
    return rows


def holdout_rows(imagen, held: Sequence[int], seed: int = 23, steps: int = 50,
                 cond_scale: float = 3.0) -> Dict[str, dict]:
    """``eval_holdout``: 8 captions cycling through the trained combos, then
    through the `held` ones; the base stage alone and the cascade truncated
    at 0.2 (DDIM-`steps`, no caching), from one generator seeded `seed`;
    the colour distances of each."""
    trained = [c for c in range(NUM_SYNTH_COMBOS) if c not in held]
    rows = {}
    for tag, combos in (("trained", trained), ("held", list(held))):
        caps = [synthetic_combo_caption(combos[i % len(combos)]) for i in range(8)]
        embeds, masks = imagen.encode_text(caps)
        gen = torch.Generator(device=imagen.device).manual_seed(seed)
        size = imagen.image_sizes[0]
        init = torch.randn(len(caps), size, size, imagen.channels, generator=gen,
                           device=imagen.device)
        base = imagen.sample_stage(0, embeds, masks, cond_scale, init_noise=init, sampler="ddim",
                                   sample_steps=steps, cache_interval=None).float().cpu().numpy()
        cascade = imagen.sample(text_embeds=embeds, text_masks=masks, cond_scale=cond_scale,
                                sampler="ddim", sample_steps=steps, cache_interval=None,
                                sr_start_noise_levels=0.2, generator=gen).float().cpu().numpy()
        rows[f"holdout/{tag}"] = dict(
            base64_color_dist=color_metric(base, caps),
            trunc_cascade_color_dist=color_metric(cascade, caps),
            finite=bool(np.isfinite(base).all() and np.isfinite(cascade).all()),
            captions=sorted(set(caps)))
    return rows


def trunc_row(imagen, captions: Sequence[str], level: float, seed: int = 0, steps: int = 50,
              cond_scale: float = 3.0) -> Dict[str, dict]:
    """``trunc/sr<level>``: the cascade with the super-resolution stage
    truncated at `level` (DDIM-`steps`, no caching) on `captions`, from a
    generator seeded `seed`; its colour distance and noise proxy."""
    gen = torch.Generator(device=imagen.device).manual_seed(seed)
    out = imagen.sample(list(captions), cond_scale=cond_scale, sampler="ddim", sample_steps=steps,
                        cache_interval=None, sr_start_noise_levels=level,
                        generator=gen).float().cpu().numpy()
    return {f"trunc/sr{level}": dict(color_dist=color_metric(out, captions),
                                     grad_mean=grad_mean(out),
                                     finite=bool(np.isfinite(out).all()))}


def mean_rows(per_seed: List[Dict[str, dict]]) -> Dict[str, dict]:
    """The numeric fields of rows from several seeds, averaged (finite: all)."""
    out = {}
    for name, first in per_seed[0].items():
        row = {}
        for key, value in first.items():
            vals = [r[name][key] for r in per_seed]
            if key == "finite":
                row[key] = all(vals)
            elif isinstance(value, float):
                row[key] = float(np.mean(vals))
            else:
                row[key] = value
        out[name] = row
    return out
