"""Faults planted underneath the timed path, for the checks that the
comparison catches them (``tests/test_portbench_faults.py``) and for the
readings that set a training cell's upper limits (``calibrate.py``): a
step that leaves its state unchanged, an answer altered where it is made,
half of the batch left out with the mean taken over the rest, an EMA left
unchanged (its decay taken as 1)."""
from __future__ import annotations

from unittest import mock

FAULTS = ("sample_state_unchanged", "sample_answer_altered", "train_state_unchanged",
          "train_half_batch", "train_ema_unchanged")


def _unchanged_ddim(self, x_t, x0, t, t_prev):
    return x_t


def _altered(sample):
    def altered(self, *args, **kwargs):
        outs = sample(self, *args, **kwargs)
        return [o + 0.02 for o in outs] if isinstance(outs, list) else outs + 0.02
    return altered


def _half_batch(stage_loss):
    def half(self, stage, images, text_embeds, text_mask, **draws):
        h = images.shape[0] // 2
        return stage_loss(self, stage, images[:h], text_embeds[:h], text_mask[:h],
                          **{k: v[:h] for k, v in draws.items()})
    return half


def _ema_still(make_train_step):
    def make(imagen, optimizer, ema_decay=0.9999, **kwargs):
        return make_train_step(imagen, optimizer, 1.0, **kwargs)
    return make


def planted(name: str):
    """A context manager that plants fault `name` in the port."""
    from minimagen_tpu_torch import training  # noqa: PLC0415
    from minimagen_tpu_torch.models.imagen import Imagen  # noqa: PLC0415
    from minimagen_tpu_torch.ops.diffusion import GaussianDiffusion  # noqa: PLC0415

    if name == "sample_state_unchanged":
        return mock.patch.object(GaussianDiffusion, "ddim_step", _unchanged_ddim)
    if name == "sample_answer_altered":
        return mock.patch.object(Imagen, "sample", _altered(Imagen.sample))
    if name == "train_state_unchanged":
        return mock.patch.object(training.ClippedAdam, "step", lambda self, *a, **k: True)
    if name == "train_half_batch":
        return mock.patch.object(Imagen, "stage_loss", _half_batch(Imagen.stage_loss))
    if name == "train_ema_unchanged":
        return mock.patch.object(training, "make_train_step",
                                 _ema_still(training.make_train_step))
    raise ValueError(f"unknown fault {name!r}")
