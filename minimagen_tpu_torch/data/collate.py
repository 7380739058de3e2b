"""Batching (counterpart of ``minimagen_tpu/data/collate.py``): a collator
that drops failed items and pads every caption to one length, and a
threaded prefetching loader.

:class:`MinimagenCollator` stacks the images and pads every encoding and
mask to a fixed ``max_length`` (padding encodes 0.0, mask False), so every
batch has one shape; it drops ``None`` items (a failed fetch) and returns
None for a batch of which nothing is left. :class:`DataLoader` is the JAX
package's: shuffling from ``seed + epoch`` with numpy, drop-last, and one
reused worker pool of threads for ``num_workers > 1``. Batches are host
numpy arrays; ``training.device_prefetch`` moves them to the card.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np


class MinimagenCollator:
    """Collate item dicts into fixed-shape numpy batches. `device` is
    accepted for the reference's signature; placement happens later."""

    def __init__(self, device=None, *, max_length: int = 64):
        self.device = device
        self.max_length = max_length

    def __call__(self, batch: List[Optional[Dict[str, np.ndarray]]]
                 ) -> Optional[Dict[str, np.ndarray]]:
        batch = [x for x in batch if x is not None and x.get("image") is not None]
        if not batch:
            return None
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


def get_minimagen_dl_opts(device=None) -> dict:
    """The reference's default loader options."""
    return {"batch_size": 4, "shuffle": True, "num_workers": 0, "drop_last": True,
            "collate_fn": MinimagenCollator(device)}


class DataLoader:
    """Threaded prefetching loader over an indexable dataset: `batch_size`,
    `shuffle` (numpy, seeded by ``seed + epoch``), `num_workers` (threads,
    one pool kept for the loader's life), `drop_last`, `collate_fn`;
    iteration yields collated batches (possibly None). `prefetch` batches
    are fetched ahead on a producer thread (0: in the caller's thread)."""

    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = True,
                 num_workers: int = 0, drop_last: bool = True, collate_fn=None,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn or MinimagenCollator()
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0
        self._pool = None

    def _worker_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

            self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                            thread_name_prefix="minimagen-dl")
        return self._pool

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = [idx[i:i + self.batch_size].tolist()
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def _fetch_batch(self, indices: List[int]):
        if self.num_workers > 1:
            items = list(self._worker_pool().map(self.dataset.__getitem__, indices))
        else:
            items = [self.dataset[i] for i in indices]
        return self.collate_fn(items)

    def __iter__(self) -> Iterator:
        self._epoch += 1
        batches = self._index_batches()
        if self.prefetch <= 0:
            for b in batches:
                yield self._fetch_batch(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        error: list = []

        def producer():
            try:
                for b in batches:
                    q.put(self._fetch_batch(b))
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                error.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        t.join()
        if error:
            raise error[0]
