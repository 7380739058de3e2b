"""Building cascades (counterpart of the JAX package's ``generate.py``
loaders, ``__graft_entry__._lite_imagen`` and the model set-up of
``train.py``).

``assets/lite_ckpt`` holds the bf16 EMA weights of a 64px base U-Net and a
256px super-resolution U-Net trained with the committed tiny T5 encoder
(``assets/t5_tiny``); ``meta.json`` names the model, the encoder and the
caption length it was trained with (:func:`load_lite`).

:func:`default_imagen` builds the cascade ``train.py`` trains: with no
parameters directory its default, the ``Base`` (64px) and ``Super`` (128px)
presets, 1000 timesteps, ``cond_drop_prob`` 0.15 and ``t5_base`` (the hash
text encoder, offline); with one, the cascade that directory's JSON files
describe (``train.py --PARAMETERS``). Its state is a fresh flax-style init
from a seed, made on the target device.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

from .checkpoint import load_unet_checkpoint
from .models.imagen import Imagen
from .models.t5 import REPO_ROOT, TextEncoder
from .models.unet import Base, Super, UnetConfig

LITE_CKPT_DIR = os.path.join(REPO_ROOT, "assets", "lite_ckpt")


def lite_unet_configs():
    """The lite cascade's (base, super-res) U-Net configs."""
    base = UnetConfig(
        dim=64, dim_mults=(1, 2, 3, 4), num_resnet_blocks=2,
        layer_attns=(False, True, True, True), layer_cross_attns=(False, True, True, True),
        memory_efficient=False, attend_at_middle=True,
    )
    sr = UnetConfig(
        dim=32, dim_mults=(1, 2, 4, 8), num_resnet_blocks=(2, 2, 3, 3),
        layer_attns=(False, False, False, True), layer_cross_attns=(False, False, False, True),
        memory_efficient=True,
    )
    return base, sr


def lite_imagen(text_encoder_name: str = "t5_tiny", dtype=torch.bfloat16,
                param_dtype: Optional[torch.dtype] = None, device="cuda") -> Imagen:
    """The lite 64->256 cascade with randomly initialised weights (flax's
    initialisers, from torch's global generator), computing in `dtype` with
    parameters in `param_dtype` (default `dtype`)."""
    return Imagen(unets=list(lite_unet_configs()), image_sizes=(64, 256), timesteps=1000,
                  cond_drop_prob=0.1, text_encoder_name=text_encoder_name, dtype=dtype,
                  param_dtype=param_dtype, device=device)


def load_lite(device="cuda", ckpt_dir: str = LITE_CKPT_DIR,
              dtype: torch.dtype = torch.bfloat16,
              param_dtype: Optional[torch.dtype] = None) -> Imagen:
    """Build the cascade that ``meta.json`` describes and load both U-Nets'
    weights and its T5 encoder from the committed files. With
    ``param_dtype=torch.float32`` the bf16 weights become float32 master
    parameters (exactly: a bf16 value is a float32 value)."""
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    config = meta["config"]
    if config["model"] != "lite":
        raise ValueError(f"{ckpt_dir} holds model {config['model']!r}, not 'lite'")
    imagen = lite_imagen(config["encoder"], dtype=dtype, param_dtype=param_dtype, device=device)
    for i, unet in enumerate(imagen.unets):
        load_unet_checkpoint(os.path.join(ckpt_dir, f"unet_{i}_ema_bf16.ckpt"), unet)
    imagen.text_encoder = TextEncoder(config["encoder"], device)
    imagen.text_max_length = config["max_length"]
    return imagen


def default_imagen(params_dir: Optional[str] = None, device="cuda", *, seed: int = 0,
                   dtype: torch.dtype = torch.bfloat16,
                   param_dtype: Optional[torch.dtype] = torch.float32) -> Imagen:
    """``train.py``'s cascade without a restart directory: from the JSON files
    of `params_dir` when given (``--PARAMETERS``), else ``Base`` and
    ``Super`` at 64/128px (``--IMG_SIDE_LEN`` 128), 1000 timesteps,
    ``cond_drop_prob`` 0.15 and ``t5_base``. Fresh flax-style weights drawn on
    `device` by torch's generator seeded with `seed` (the caller's generator
    state is restored), computing in `dtype` with parameters in
    `param_dtype`."""
    # training imports this module for the lite cascade
    from .training import get_default_args, get_model_params  # noqa: PLC0415

    if params_dir is None:
        unets = [get_default_args(Base), get_default_args(Super)]
        imagen_params = dict(image_sizes=(64, 128), timesteps=1000, cond_drop_prob=0.15,
                             text_encoder_name="t5_base")
    else:
        unets, imagen_params = get_model_params(params_dir)
        imagen_params = {k: v for k, v in imagen_params.items() if k != "unets"}
        if imagen_params.pop("only_train_unet_number", None) is not None:
            raise NotImplementedError("only_train_unet_number is not ported")
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(seed)
        return Imagen(unets=[UnetConfig.from_dict(p) for p in unets], **imagen_params,
                      dtype=dtype, param_dtype=param_dtype, device=dev)
