"""Batch collation (counterpart of the part of
``minimagen_tpu/data/collate.py::MinimagenCollator`` the synthetic set needs).

Stacks the images and pads every encoding and mask to a fixed ``max_length``
(padding encodes 0.0, mask False), so every batch has one shape. Batches are
host numpy arrays.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class MinimagenCollator:
    """Collate item dicts into fixed-shape numpy batches."""

    def __init__(self, *, max_length: int = 64):
        self.max_length = max_length

    def __call__(self, batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        length = self.max_length
        images = np.stack([x["image"] for x in batch]).astype(np.float32)
        dim = batch[0]["encoding"].shape[-1]
        encodings = np.zeros((len(batch), length, dim), np.float32)
        masks = np.zeros((len(batch), length), bool)
        for i, x in enumerate(batch):
            enc = np.squeeze(x["encoding"])
            msk = np.squeeze(x["mask"])
            if enc.ndim == 1:  # a one-token caption squeezed to (dim,)
                enc = enc[None, :]
                msk = np.atleast_1d(msk)
            n = min(enc.shape[0], length)
            encodings[i, :n] = enc[:n]
            masks[i, :n] = msk[:n]
        return {"image": images, "encoding": encodings, "mask": masks}
