"""The offline synthetic captioned-shapes set (counterpart of
``minimagen_tpu/data/dataset.py:188-278``).

``_draw_synthetic``, ``synthetic_combo_caption`` and ``holdout_split`` are
copied from the JAX package and draw the same images bit for bit: numpy,
seeded by the item's index. Captions are encoded by the port's own T5
encoder (``models/t5.py``), one caption at a time and cached, as the JAX
package's ``CaptionEncoder`` does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.t5 import TextEncoder

_SYNTH_COLORS = {
    "red": (0.9, 0.1, 0.1), "green": (0.1, 0.8, 0.15), "blue": (0.15, 0.2, 0.9),
    "yellow": (0.9, 0.85, 0.1), "purple": (0.6, 0.15, 0.75), "orange": (0.95, 0.55, 0.1),
}
_SYNTH_SHAPES = ("square", "circle", "stripes")
NUM_SYNTH_COMBOS = len(_SYNTH_COLORS) * len(_SYNTH_SHAPES)  # 18 (color, shape) pairs


def synthetic_combo_caption(combo_id: int) -> str:
    """Caption of (color, shape) combo `combo_id` in the order
    `_draw_synthetic` cycles through (combo_id == index % 18)."""
    colors = list(_SYNTH_COLORS)
    color = colors[combo_id % len(colors)]
    shape = _SYNTH_SHAPES[(combo_id // len(colors)) % len(_SYNTH_SHAPES)]
    return f"a {color} {shape}"


def holdout_split(n_holdout: int, seed: int = 5) -> Tuple[List[int], List[int]]:
    """Deterministic (train_combos, held_out_combos) split of the 18 combos:
    training excludes the held-out combos entirely."""
    if not 0 <= n_holdout < NUM_SYNTH_COMBOS:
        raise ValueError(f"n_holdout must be in [0, {NUM_SYNTH_COMBOS})")
    rng = np.random.default_rng(seed)
    held = sorted(int(i) for i in rng.choice(NUM_SYNTH_COMBOS, n_holdout, replace=False))
    train = [i for i in range(NUM_SYNTH_COMBOS) if i not in held]
    return train, held


def _draw_synthetic(index: int, side: int) -> Tuple[np.ndarray, str]:
    """Deterministic procedural image + caption for `index`."""
    rng = np.random.default_rng(index)
    color_name = list(_SYNTH_COLORS)[index % len(_SYNTH_COLORS)]
    shape = _SYNTH_SHAPES[(index // len(_SYNTH_COLORS)) % len(_SYNTH_SHAPES)]
    color = np.array(_SYNTH_COLORS[color_name], np.float32)

    img = np.full((side, side, 3), 0.92, np.float32)
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)

    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    cx, cy = rng.uniform(0.35, 0.65, 2)
    r = rng.uniform(0.18, 0.3)
    if shape == "square":
        mask = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
    elif shape == "circle":
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r**2
    else:  # stripes
        mask = (np.floor(xx * 6).astype(int) % 2) == 0
    img[mask] = color

    caption = f"a {color_name} {shape}"
    return np.clip(img, 0, 1), caption


class CaptionEncoder:
    """Per-caption T5 encodings, cached: (L, dim) float32 and an (L,) mask,
    L the caption's own token count."""

    def __init__(self, encoder_name: str, max_length: int, device="cuda"):
        self.encoder = TextEncoder(encoder_name, device)
        self.max_length = max_length
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def encode(self, caption: str) -> Tuple[np.ndarray, np.ndarray]:
        if caption not in self._cache:
            enc, mask = self.encoder.encode([caption], self.max_length)
            self._cache[caption] = (enc[0].cpu().numpy(), mask[0].cpu().numpy())
        return self._cache[caption]


class SyntheticCaptionedImages:
    """Procedural coloured shapes with captions; item i always gives the same
    {'image': (s, s, 3) float32 in [0, 1], 'encoding', 'mask'}. `combos`
    restricts the set to some of the 18 (colour, shape) pairs: item i cycles
    through them while the instance noise still advances with i."""

    def __init__(self, *, num_items: int, side_length: int, encoder_name: str,
                 max_length: int, combos: Optional[List[int]] = None, device="cuda"):
        self.num_items = num_items
        self.side_length = side_length
        self.encoder = CaptionEncoder(encoder_name, max_length, device)
        if combos is not None and not (combos and all(0 <= c < NUM_SYNTH_COMBOS for c in combos)):
            raise ValueError(f"combos must be a non-empty subset of range({NUM_SYNTH_COMBOS})")
        self.combos = list(combos) if combos is not None else None

    def __len__(self):
        return self.num_items

    def _underlying_index(self, idx: int) -> int:
        if self.combos is None:
            return idx
        combo = self.combos[idx % len(self.combos)]
        block = idx // len(self.combos)
        return block * NUM_SYNTH_COMBOS + combo

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img, caption = _draw_synthetic(self._underlying_index(idx), self.side_length)
        enc, mask = self.encoder.encode(caption)
        return {"image": img, "encoding": enc, "mask": mask}
