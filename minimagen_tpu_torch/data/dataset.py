"""Datasets (counterpart of ``minimagen_tpu/data/dataset.py``).

- :func:`fetch_single_image`, :class:`MinimagenDataset` and the HF
  ``datasets`` branch of :func:`ConceptualCaptions`: the reference's
  URL-fetching data path. Each item's image is fetched with urllib (the
  JAX package's user agent, `timeout`, ``retries + 1`` attempts) and
  decoded by PIL, imported inside :func:`fetch_single_image` only (the
  card's machine has no PIL, so this path runs off the card); then
  :func:`pil_to_array`, :func:`rescale_image`, the 3-channel filter, the
  optional transform and the caption's encoding, or None where any step
  fails. ``datasets`` is imported only inside the HF branch.
- ``_draw_synthetic``, ``synthetic_combo_caption`` and ``holdout_split``
  are copied from the JAX package and draw the same images bit for bit:
  numpy, seeded by the item's index. :func:`ConceptualCaptions` falls back
  to that synthetic set (2048 items, 16 with `smalldata`; the test set
  drawn from ``seed_offset`` 10 000), split by :func:`random_split`, where
  ``datasets`` or its download fails.
- Captions are encoded by the port's own T5 encoder (``models/t5.py``) on
  the caller's device and cached per caption (:class:`CaptionEncoder`,
  with :meth:`CaptionEncoder.precompute` encoding many in batches), as the
  JAX package's ``CaptionEncoder`` does.
"""
from __future__ import annotations

import io
import os
import urllib.request
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.t5 import TextEncoder

USER_AGENT = "minimagen_tpu/0.1 (dataset fetcher)"  # the JAX package's, byte for byte


def fetch_single_image(image_url: str, timeout: Optional[float] = None, retries: int = 0):
    """One image from `image_url` as a PIL image, or None on any failure
    (an HTTP error, a timeout, bytes PIL cannot open), after ``retries + 1``
    attempts; the JAX package's ``fetch_single_image``."""
    import PIL.Image  # noqa: PLC0415 - the card's machine has no PIL

    image = None
    for _ in range(retries + 1):
        try:
            request = urllib.request.Request(image_url, data=None,
                                             headers={"user-agent": USER_AGENT})
            with urllib.request.urlopen(request, timeout=timeout) as req:
                image = PIL.Image.open(io.BytesIO(req.read()))
            break
        except Exception:  # noqa: BLE001 - any failure is a missing image, as the reference's
            image = None
    return image

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

    def precompute(self, captions: List[str], batch_size: int = 64) -> None:
        """Encode the distinct captions not cached yet, `batch_size` at a
        time, each cached row cut to its mask's count (a batch pads to its
        longest caption)."""
        todo = [c for c in dict.fromkeys(captions) if c not in self._cache]
        for i in range(0, len(todo), batch_size):
            chunk = todo[i:i + batch_size]
            enc, mask = self.encoder.encode(chunk, self.max_length)
            enc, mask = enc.cpu().numpy(), mask.cpu().numpy()
            for j, c in enumerate(chunk):
                n = int(mask[j].sum())
                self._cache[c] = (enc[j][:n], mask[j][:n])


class MinimagenDataset:
    """The reference's URL-fetching captioned-image dataset over an HF
    ``datasets``-style mapping (``hf_dataset[split]["image_url"]`` and
    ``["caption"]``; split "train", or "validation" without `train`). Item
    i is {'image': (s, s, 3) float32 in [0, 1], 'encoding', 'mask'}, or
    None where the fetch, the resize, the 3-channel filter or the
    transform fails (the collator drops Nones). Captions are encoded on
    `device`."""

    def __init__(self, hf_dataset, *, encoder_name: str, max_length: int, side_length: int,
                 train: bool = True, img_transform=None, fetch_timeout: Optional[float] = 10.0,
                 fetch_retries: int = 0, device="cuda"):
        split = "train" if train else "validation"
        self.urls = hf_dataset[split]["image_url"]
        self.captions = hf_dataset[split]["caption"]
        self.side_length = side_length
        self.img_transform = img_transform
        self.fetch_timeout = fetch_timeout
        self.fetch_retries = fetch_retries
        self.encoder = CaptionEncoder(encoder_name, max_length, device)

    def __len__(self):
        return len(self.urls)

    def __getitem__(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        img = fetch_single_image(self.urls[idx], timeout=self.fetch_timeout,
                                 retries=self.fetch_retries)
        if img is None:
            return None
        arr = rescale_image(pil_to_array(img), self.side_length)
        if arr is None or arr.shape[-1] != 3:
            return None
        if self.img_transform is not None:
            arr = self.img_transform(arr)
            if arr is None:
                return None
        enc, mask = self.encoder.encode(self.captions[idx])
        return {"image": arr, "encoding": enc, "mask": mask}


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


def _split(full, args):
    """(train, valid) of `full` at ``args.TRAIN_VALID_FRAC``, the valid part
    cut to ``args.VALID_NUM + 1`` items when that is set."""
    train_ds, valid_ds = random_split(full, int(args.TRAIN_VALID_FRAC * len(full)))
    if getattr(args, "VALID_NUM", None) is not None:
        valid_ds.indices = valid_ds.indices[:args.VALID_NUM + 1]
    return train_ds, valid_ds


def ConceptualCaptions(args, smalldata: bool = False, testset: bool = False, *, device="cuda"):
    """The reference's dataset factory. Where HF ``datasets`` imports and
    ``load_dataset("conceptual_captions")`` succeeds, :class:`MinimagenDataset`
    over it (both splits cut to their first 16 rows with `smalldata`):
    the validation split if `testset`, else the train split cut by
    :func:`random_split`. Otherwise, with a warning, the offline synthetic
    set of 2048 items (16 with `smalldata`), its test set drawn from
    ``seed_offset`` 10 000. Images are ``args.IMG_SIDE_LEN`` square,
    captions encoded by ``args.T5_NAME`` to ``args.MAX_NUM_WORDS`` tokens on
    `device`; (train, valid) split at ``args.TRAIN_VALID_FRAC``, the valid
    part cut to ``args.VALID_NUM + 1`` items when that is set."""
    dset = None
    try:
        from datasets import load_dataset  # noqa: PLC0415 - optional, and absent on the card

        dset = load_dataset("conceptual_captions")
        if smalldata:
            num = 16
            dset = {split: {"image_url": dset[split]["image_url"][:num],
                            "caption": dset[split]["caption"][:num]}
                    for split in ("train", "validation")}
    except Exception:  # noqa: BLE001 - no package, no network, no data: the offline set
        dset = None

    if dset is not None:
        def make(train: bool) -> MinimagenDataset:
            return MinimagenDataset(dset, max_length=args.MAX_NUM_WORDS,
                                    encoder_name=args.T5_NAME, side_length=args.IMG_SIDE_LEN,
                                    train=train, device=device)

        return make(False) if testset else _split(make(True), args)

    warnings.warn("HF `datasets`/network unavailable: using the offline synthetic "
                  "captioned-image set (deterministic shapes + captions).", stacklevel=2)
    num = 16 if smalldata else 2048

    def make_synth(offset: int, n: int) -> SyntheticCaptionedImages:
        return SyntheticCaptionedImages(num_items=n, side_length=args.IMG_SIDE_LEN,
                                        encoder_name=args.T5_NAME, max_length=args.MAX_NUM_WORDS,
                                        seed_offset=offset, device=device)

    if testset:
        return make_synth(10_000, num)
    return _split(make_synth(0, num), args)
