"""Caption-colour quality metrics of the synthetic shapes set
(counterparts of ``tools/flagship_quality_eval.py::color_metric`` and
``grad_mean``, with the palette of ``data/dataset.py``)."""
from __future__ import annotations

import numpy as np

from .data.dataset import _SYNTH_COLORS as SYNTH_COLORS  # colour name -> RGB in [0, 1]


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
