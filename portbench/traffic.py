"""The one generator of the benchmark's inputs, driven by a workload file.

Everything comes from ``--seed``, on the card, from ``torch.Generator``s
seeded per purpose (:func:`weights.sub_seed`), so the reference draws the
same tensors again after the program is gone. Every seed gets the same
sizes: caption lengths are one fixed spread over the workload's range, put
in another order by the seed.

Sampling: caption sets (text encodings, masks) cycled over the calls, and
each call's noise draws (:class:`CallNoise`). Training: batches of smooth
random images in [0, 1] with their encodings and masks, and every draw of
the step (:func:`train_draws`), cycled over the steps.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .weights import sub_seed


def _gen(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def caption_lengths(n: int, lo: int, hi: int, seed: int, tag) -> List[int]:
    """`n` token counts spread evenly over [lo, hi], in a seeded order."""
    lengths = [round(lo + (hi - lo) * i / max(n - 1, 1)) for i in range(n)]
    order = torch.randperm(n, generator=torch.Generator().manual_seed(sub_seed(seed, "len", tag)))
    return [lengths[i] for i in order.tolist()]


def captions(n: int, tokens: Sequence[int], width: int, seed: int, tag, device):
    """(encodings (n, L, width) float32, masks (n, L) bool, lengths): seeded
    encodings, L the longest caption, each row's mask true over its length."""
    lengths = caption_lengths(n, tokens[0], tokens[1], seed, tag)
    longest = max(lengths)
    enc = torch.randn(n, longest, width, generator=_gen(device, seed, "enc", tag), device=device)
    mask = torch.arange(longest, device=device)[None, :] < torch.tensor(lengths, device=device)[:, None]
    return enc * mask[..., None], mask, lengths


class CallNoise:
    """The draws of one sampling call, in the order the call asks for them:
    ``noise(shape)`` returns the next standard normal tensor of that shape."""

    def __init__(self, seed: int, call: int, device):
        self.seed, self.call, self.device, self.count = seed, call, device, 0

    def __call__(self, shape) -> torch.Tensor:
        gen = _gen(self.device, self.seed, "noise", self.call, self.count)
        self.count += 1
        return torch.randn(tuple(shape), generator=gen, device=self.device)

    def draw(self, index: int, shape) -> torch.Tensor:
        """The `index`-th draw of this call again."""
        gen = _gen(self.device, self.seed, "noise", self.call, index)
        return torch.randn(tuple(shape), generator=gen, device=self.device)


def images(n: int, size: int, seed: int, tag, device) -> torch.Tensor:
    """(n, size, size, 3) smooth random images in [0, 1]: a coarse 8x8
    field upsampled, with fine noise on top."""
    g = _gen(device, seed, "img", tag)
    coarse = torch.rand(n, 3, 8, 8, generator=g, device=device)
    smooth = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    fine = 0.05 * torch.randn(n, 3, size, size, generator=g, device=device)
    return (smooth + fine).clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def train_batch(b: int, size: int, tokens: Sequence[int], width: int, seed: int, k: int,
                device) -> Dict[str, torch.Tensor]:
    """Batch `k`: images, encodings and masks, as the train step takes them."""
    enc, mask, _ = captions(b, tokens, width, seed, ("batch", k), device)
    return {"image": images(b, size, seed, k, device), "encoding": enc, "mask": mask}


def train_draws(b: int, sizes: Sequence[int], timesteps: int, cond_drop_prob: float,
                seed: int, k: int, device) -> List[Dict[str, torch.Tensor]]:
    """Every random draw of a train step on batch `k`, one dict per stage:
    times, noise and the guidance-dropout keep mask; for a super-resolution
    stage also one augmentation time for the batch and its noise."""
    out = []
    for stage, size in enumerate(sizes):
        g = _gen(device, seed, "draws", k, stage)
        d = {"times": torch.randint(0, timesteps, (b,), generator=g, device=device),
             "noise": torch.randn(b, size, size, 3, generator=g, device=device),
             "keep_mask": torch.rand(b, generator=g, device=device) >= cond_drop_prob}
        if stage > 0:
            t = torch.randint(0, timesteps, (1,), generator=g, device=device)
            d["lowres_aug_times"] = t.expand(b).contiguous()
            d["lowres_noise"] = torch.randn(b, size, size, 3, generator=g, device=device)
        out.append(d)
    return out
