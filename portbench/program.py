"""The system under test: the port's cascade built from a configuration
file, holding the benchmark's weights. The only module of the harness that
imports the program; the reference never does."""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
UNET_KEYS = ("dim", "dim_mults", "num_resnet_blocks", "layer_attns", "layer_cross_attns",
             "attn_heads", "memory_efficient", "attend_at_middle")


def build(config: Dict, weights, param_dtype: str, device="cuda"):
    """The port's ``Imagen`` for `config`, computing in its ``dtype`` with
    parameters held in `param_dtype`, every U-Net holding `weights`."""
    from minimagen_tpu_torch.models.imagen import Imagen  # noqa: PLC0415
    from minimagen_tpu_torch.models.unet import UnetConfig  # noqa: PLC0415

    unets = [UnetConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in u.items() if k in UNET_KEYS}) for u in config["unets"]]
    with torch.device(device):
        imagen = Imagen(unets=unets, image_sizes=tuple(config["image_sizes"]),
                        text_encoder_name=config["text_encoder"],
                        text_embed_dim=config["text_embed_dim"],
                        timesteps=config["timesteps"], cond_drop_prob=config["cond_drop_prob"],
                        lowres_sample_noise_level=config["lowres_sample_noise_level"],
                        dynamic_thresholding_percentile=config["dynamic_thresholding_percentile"],
                        dtype=DTYPES[config["dtype"]],
                        param_dtype=DTYPES[param_dtype], device=device)
    for u, unet in enumerate(imagen.unets):
        loaded = set()
        for block in weights.blocks(u):
            unet.load_state_dict(block, strict=False)
            loaded |= set(block)
        missing = {n for n, _ in unet.named_parameters()} - loaded
        if missing:
            raise ValueError(f"unet {u}: no weights for {sorted(missing)[:4]} ...")
    return imagen


def module_classes():
    """The port's attention and GroupNorm module classes."""
    from minimagen_tpu_torch.models import layers  # noqa: PLC0415

    return (layers.Attention, layers.CrossAttention), layers.GroupNorm


def launches():
    """The port's kernel launch counter (``ops/kernels.py``)."""
    from minimagen_tpu_torch.ops import kernels  # noqa: PLC0415

    return kernels


def train_step(imagen, lr: float, ema_decay: float):
    """(state, step_fn) of the port's trainer: clip-50 Adam and a float32
    EMA over every U-Net."""
    from minimagen_tpu_torch import training  # noqa: PLC0415

    optimizer = training.make_optimizer(lr)
    state = training.create_train_state(imagen, optimizer, ema=True)
    return state, training.make_train_step(imagen, optimizer, ema_decay=ema_decay)
