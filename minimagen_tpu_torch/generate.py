"""Building cascades and sampling from training directories (counterpart of
``minimagen_tpu/generate.py``, ``__graft_entry__._lite_imagen`` and the model
set-up of ``train.py``).

A training directory (``training.create_directory``) holds
``parameters/unet_<i>_params_<ts>.json`` and ``imagen_params_<ts>.json``,
the best-validation U-Nets in ``state_dicts/`` and the latest in ``tmp/``,
all flax-msgpack ``.ckpt`` files that either package reads.
:func:`load_params`, :func:`load_minimagen` and :func:`sample_and_save` are
the JAX package's; the card has no PIL, so :func:`write_png` writes the
images with ``zlib`` alone. A reference-MinImagen ``.pth`` checkpoint is
refused with a clear error: its import is not ported yet (ROADMAP section
1 item 6).

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
import struct
import zlib
from contextlib import contextmanager
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .checkpoint import load_unet_checkpoint
from .models.imagen import Imagen, to_uint8
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
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(seed)
        return Imagen(unets=[UnetConfig.from_dict(p) for p in unets], **imagen_params,
                      dtype=dtype, param_dtype=param_dtype, device=dev)


# --------------------------------------------------------------------------- #
# training directories (minimagen_tpu/generate.py:35-166)                      #
# --------------------------------------------------------------------------- #
def load_params(directory: str) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """The U-Net config dicts (``unet_<i>_*``, in i order) and the Imagen
    parameters (``imagen_*``) of a training directory's ``parameters/``."""
    from .training import get_model_params  # noqa: PLC0415 - training imports this module

    return get_model_params(os.path.join(directory, "parameters"))


def _instantiate_minimagen(directory: str, device="cuda", dtype: torch.dtype = torch.float32,
                           param_dtype: Optional[torch.dtype] = None) -> Imagen:
    """An Imagen built from a training directory's configs, weights not
    loaded (the reference's ``_instatiate_minimagen`` [sic])."""
    unets, imagen_params = load_params(directory)
    imagen_params = {k: v for k, v in imagen_params.items() if k != "unets"}
    return Imagen(unets=[UnetConfig.from_dict(p) for p in unets], **imagen_params, dtype=dtype,
                  param_dtype=param_dtype, device=device)


def load_minimagen(directory: str, device="cuda", dtype: torch.dtype = torch.float32,
                   param_dtype: Optional[torch.dtype] = None) -> Imagen:
    """An Imagen with the configs and weights of a training directory: each
    U-Net from ``state_dicts/`` (its best validation), else from ``tmp/``
    (the latest dump); raises if both are empty. A reference MinImagen
    ``.pth`` file is converted (``tools/torch_import.py``), as the JAX
    package converts it. Computes in `dtype` (float32, as the JAX package
    loads)."""
    imagen = _instantiate_minimagen(directory, device, dtype, param_dtype)

    def load_from(subdir: str) -> bool:
        files = [f for f in os.listdir(os.path.join(directory, subdir)) if f.startswith("unet_")]
        if not files:
            return False
        for i in range(imagen.num_unets):
            candidates = sorted(f for f in files if f.startswith(f"unet_{i}_"))
            if not candidates:
                raise ValueError(f"{directory}/{subdir} holds no checkpoint of unet_{i}")
            path = os.path.join(directory, subdir, candidates[0])
            if path.endswith(".pth"):  # a reference MinImagen checkpoint: converted
                from .tools.torch_import import load_reference_unet  # noqa: PLC0415

                load_reference_unet(path, imagen, i)
            else:
                load_unet_checkpoint(path, imagen.unets[i])
        return True

    if not load_from("state_dicts"):
        print(f'\n"state_dicts" folder in {directory} is empty, using the most recent '
              'checkpoint from "tmp".\n')
        if not load_from("tmp"):
            raise ValueError(f'Both "/state_dicts" and "/tmp" in {directory} are empty. Train '
                             "the model to acquire state dictionaries for inference.")
    return imagen


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (h, w, 3) uint8 image as an 8-bit RGB PNG (zlib and struct
    only: no imaging library)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    if c != 3:
        raise ValueError(f"write_png takes RGB images, got {c} channels")

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def _output_directory(dir_path: str):
    """The generated-images directory's chdir context manager (raises if
    ``generated_images/`` exists and is not empty)."""
    original_dir = os.getcwd()
    img_path = os.path.join(original_dir, dir_path, "generated_images")
    if not os.path.exists(img_path):
        os.makedirs(img_path)
    elif os.listdir(img_path):
        raise FileExistsError(f"The directory {img_path} already exists and is nonempty")

    @contextmanager
    def cm(subdir: str = ""):
        os.chdir(os.path.join(original_dir, dir_path, subdir))
        try:
            yield
        finally:
            os.chdir(original_dir)

    return cm


def sample_and_save(captions: List[str], *, minimagen: Optional[Imagen] = None,
                    training_directory: Optional[str] = None,
                    sample_args: Optional[dict] = None, save_directory: Optional[str] = None,
                    filetype: str = "png", device="cuda") -> np.ndarray:
    """Sample `captions` and write ``<save_directory>/generated_images/
    image_<idx>.png`` (default directory ``generated_images_<timestamp>``)
    with ``captions.txt`` and ``imagen_training_directory.txt``, from an
    Imagen or a training directory (loaded on `device`). Returns the
    (b, s, s, 3) uint8 images written. With a ``mesh`` in `sample_args`
    every process of it samples, and its process 0 alone writes."""
    if (minimagen is None) == (training_directory is None):
        raise ValueError("supply exactly one of a MinImagen instance and a training directory")
    if filetype != "png":
        raise ValueError(f"images are written as png, not {filetype!r}")
    if save_directory is None:
        save_directory = datetime.now().strftime("generated_images_%Y%m%d_%H%M%S")
    mesh = (sample_args or {}).get("mesh")
    writer = mesh is None or mesh.is_leader
    if writer:
        cm = _output_directory(save_directory)
        with cm():
            with open("captions.txt", "w") as f:
                f.writelines(f"{c}\n" for c in captions)
            if training_directory is not None:
                with open("imagen_training_directory.txt", "w") as f:
                    f.write(training_directory)
    if training_directory is not None:
        minimagen = load_minimagen(training_directory, device=device)
    images = minimagen.sample(texts=captions, **dict(sample_args or {}))
    pixels = to_uint8(images.float().cpu().numpy())
    if writer:
        with cm("generated_images"):
            for idx, img in enumerate(pixels):
                write_png(f"image_{idx}.{filetype}", img)
    return pixels
