"""Datasets (counterpart of the offline parts of
``minimagen_tpu/data/dataset.py``).

``_draw_synthetic``, ``synthetic_combo_caption`` and ``holdout_split`` are
copied from the JAX package and draw the same images bit for bit: numpy,
seeded by the item's index. Captions are encoded by the port's own T5
encoder (``models/t5.py``), one caption at a time and cached, as the JAX
package's ``CaptionEncoder`` does.

:func:`ConceptualCaptions` is the reference's dataset factory with only its
offline branch: the synthetic set (2048 items, 16 with `smalldata`; the
test set drawn from ``seed_offset`` 10 000), split by :func:`random_split`.
The JAX package's HF ``datasets`` branch, ``MinimagenDataset`` and
``fetch_single_image`` fetch images over the network and are not ported.
:func:`rescale_image` and :func:`pil_to_array` preprocess a local image as
they do (PIL only inside :func:`pil_to_array`'s caller).
"""
from __future__ import annotations

import os
import warnings
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
    through them while the instance noise still advances with i.
    `seed_offset` shifts the drawn indices (a disjoint test set);
    `failure_rate` makes that share of items None, as failed fetches are."""

    def __init__(self, *, num_items: int, side_length: int, encoder_name: str,
                 max_length: int, combos: Optional[List[int]] = None, seed_offset: int = 0,
                 failure_rate: float = 0.0, device="cuda"):
        self.num_items = num_items
        self.side_length = side_length
        self.seed_offset = seed_offset
        self.failure_rate = failure_rate
        self.encoder = CaptionEncoder(encoder_name, max_length, device)
        if combos is not None and not (combos and all(0 <= c < NUM_SYNTH_COMBOS for c in combos)):
            raise ValueError(f"combos must be a non-empty subset of range({NUM_SYNTH_COMBOS})")
        self.combos = list(combos) if combos is not None else None

    def __len__(self):
        return self.num_items

    def _underlying_index(self, idx: int) -> int:
        if self.combos is None:
            return idx + self.seed_offset
        combo = self.combos[idx % len(self.combos)]
        block = idx // len(self.combos)
        return (block + self.seed_offset) * NUM_SYNTH_COMBOS + combo

    def __getitem__(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        if self.failure_rate > 0 and np.random.default_rng(idx).uniform() < self.failure_rate:
            return None
        img, caption = _draw_synthetic(self._underlying_index(idx), self.side_length)
        enc, mask = self.encoder.encode(caption)
        return {"image": img, "encoding": enc, "mask": mask}


class _SubsetDataset:
    """The items `indices` of `base`, renumbered from 0."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[self.indices[i]]


def random_split(dataset, train_size: int, seed: int = 0):
    """(train, valid) views of `dataset` from one numpy permutation seeded
    `seed`: the first `train_size` permuted items, then the rest."""
    perm = np.random.default_rng(seed).permutation(len(dataset))
    return _SubsetDataset(dataset, perm[:train_size]), _SubsetDataset(dataset, perm[train_size:])


def rescale_image(arr: np.ndarray, side_length: int) -> Optional[np.ndarray]:
    """An HWC [0, 1] image resized to `side_length` square by the
    resize_right algorithm (cubic, antialiased, reflect padding; out shape
    pinned to the side) and min-max renormalised to [0, 1], as the
    reference's ``_Rescale``; None for a constant image or a failed resize.
    With ``MINIMAGEN_TPU_NATIVE_RESIZE=1`` and the native library built, its
    antialiased Catmull-Rom resize instead (another grid than the
    reference's)."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    elif arr.ndim != 3:
        return None
    if os.environ.get("MINIMAGEN_TPU_NATIVE_RESIZE") == "1":
        from . import native  # noqa: PLC0415

        if native.available():
            out = native.resize_image_u8((np.clip(arr, 0, 1) * 255).astype(np.uint8),
                                         side_length, renorm=True)
            if out is not None:
                return out
    import torch  # noqa: PLC0415

    from ..ops.resize_right import resize  # noqa: PLC0415

    h, w = arr.shape[:2]
    out = arr.astype(np.float32)
    if (h, w) != (side_length, side_length):
        try:
            out = resize(torch.from_numpy(out), scale_factors=(side_length / h, side_length / w),
                         out_shape=(side_length, side_length), dims=(0, 1),
                         pad_mode="reflect").numpy()
        except Exception:  # noqa: BLE001 - a failed item, as the reference's
            return None
    lo, hi = out.min(), out.max()
    if hi <= lo:
        return None
    return ((out - lo) / (hi - lo)).astype(np.float32)


def pil_to_array(img) -> np.ndarray:
    """A PIL image -> HWC float32 in [0, 1], keeping its channel count (the
    reference rejects non-3-channel images after this step)."""
    return np.asarray(img, dtype=np.float32) / 255.0


def ConceptualCaptions(args, smalldata: bool = False, testset: bool = False, *, device="cuda"):
    """The reference's dataset factory, offline: the synthetic set of 2048
    items (16 with `smalldata`) at ``args.IMG_SIDE_LEN`` with captions
    encoded by ``args.T5_NAME`` to ``args.MAX_NUM_WORDS`` tokens on `device`.
    Returns the test set (drawn from ``seed_offset`` 10 000) if `testset`,
    else (train, valid) split at ``args.TRAIN_VALID_FRAC``, the valid part
    cut to ``args.VALID_NUM + 1`` items when that is set. The reference's
    Conceptual Captions download is not ported."""
    warnings.warn("Conceptual Captions needs the network: using the offline synthetic "
                  "captioned-image set (deterministic shapes + captions).", stacklevel=2)
    num = 16 if smalldata else 2048

    def make(offset: int, n: int) -> SyntheticCaptionedImages:
        return SyntheticCaptionedImages(num_items=n, side_length=args.IMG_SIDE_LEN,
                                        encoder_name=args.T5_NAME, max_length=args.MAX_NUM_WORDS,
                                        seed_offset=offset, device=device)

    if testset:
        return make(10_000, num)
    full = make(0, num)
    train_ds, valid_ds = random_split(full, int(args.TRAIN_VALID_FRAC * len(full)))
    if getattr(args, "VALID_NUM", None) is not None:
        valid_ds.indices = valid_ds.indices[:args.VALID_NUM + 1]
    return train_ds, valid_ds
