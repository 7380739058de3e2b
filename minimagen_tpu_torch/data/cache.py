"""An on-disk dataset cache (counterpart of ``minimagen_tpu/data/cache.py``):
a dataset materialised once into npz shards of images and caption
encodings, served from disk afterwards.

    build_cache(dataset, "cache_dir")            # once
    ds = CachedCaptionedImages("cache_dir")      # every run
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

SHARD_SIZE = 256


def build_cache(dataset, out_dir: str, *, shard_size: int = SHARD_SIZE,
                num_threads: int = 8) -> Dict:
    """Write an indexable captioned-image dataset into npz shards of
    `shard_size` items and a ``manifest.json``; failed items (None, or an
    exception) are left out, so cached batches are always full. Returns
    the manifest."""
    from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

    os.makedirs(out_dir, exist_ok=True)

    def fetch(i):
        try:
            return dataset[i]
        except Exception:  # noqa: BLE001 - a failed item is skipped
            return None

    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        items: List = [x for x in ex.map(fetch, range(len(dataset))) if x is not None]

    shards = []
    for s in range(0, len(items), shard_size):
        chunk = items[s:s + shard_size]
        max_len = max(x["encoding"].shape[0] for x in chunk)
        dim = chunk[0]["encoding"].shape[-1]
        encodings = np.zeros((len(chunk), max_len, dim), np.float32)
        masks = np.zeros((len(chunk), max_len), bool)
        for i, x in enumerate(chunk):
            n = x["encoding"].shape[0]
            encodings[i, :n] = x["encoding"]
            masks[i, :n] = np.asarray(x["mask"]).reshape(-1)[:n]
        name = f"shard_{s // shard_size:05d}.npz"
        np.savez(os.path.join(out_dir, name),
                 image=np.stack([x["image"] for x in chunk]).astype(np.float32),
                 encoding=encodings, mask=masks)
        shards.append({"file": name, "count": len(chunk)})

    manifest = {"num_items": len(items), "shard_size": shard_size, "shards": shards}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class CachedCaptionedImages:
    """Indexable dataset over a :func:`build_cache` directory; shards load
    lazily, one kept at a time."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        with open(os.path.join(cache_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.shard_size = self.manifest["shard_size"]
        self._loaded_idx: Optional[int] = None
        self._loaded = None

    def __len__(self):
        return self.manifest["num_items"]

    def _shard(self, shard_idx: int):
        if self._loaded_idx != shard_idx:
            path = os.path.join(self.cache_dir, self.manifest["shards"][shard_idx]["file"])
            self._loaded = np.load(path)
            self._loaded_idx = shard_idx
        return self._loaded

    def __getitem__(self, idx: int):
        shard = self._shard(idx // self.shard_size)
        j = idx % self.shard_size
        return {"image": shard["image"][j], "encoding": shard["encoding"][j],
                "mask": shard["mask"][j]}
