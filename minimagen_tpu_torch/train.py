"""The training CLI (counterpart of the root ``train.py``):

    python -m minimagen_tpu_torch.train [flags]

The same flags and behaviour: the reference's 16 of
``training.get_minimagen_parser`` and train.py's ``--TIMESTAMP``,
``--BF16``, ``--REMAT``, ``--MU_DTYPE``, ``--MIN_SNR_GAMMA``,
``--OFFSET_NOISE``, ``--MESH`` and ``--ZERO1``; the parameters resolve as
RESTART_DIRECTORY > PARAMETERS > TESTING > defaults. It makes
``training_<timestamp>/`` with the flags and configs, then runs
:func:`training.MinimagenTrain`, and prints the run's summary as one JSON
line with the kernels' launch counts. ``--DEVICE`` (default ``cuda``) is the
port's one new flag. A restart keeps ``--BF16`` and ``--REMAT`` (the JAX CLI
rebuilds a restarted model in float32).

``--MESH data`` trains data-parallel, one process per device, sharded as
``--ZERO1`` says (``on``: ZeRO-1, ``fsdp``, ``off``)::

    torchrun --nproc_per_node N -m minimagen_tpu_torch.train --MESH data [flags]

Each process uses ``cuda:{LOCAL_RANK}`` (NCCL; gloo for ``--DEVICE cpu``),
loads the same batches (``-b`` is the global batch) and keeps its rows;
process 0 makes the directory and writes the files, and prints the JSON
line. Without torchrun's environment ``--MESH data`` is a mesh of one.
"""
from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Optional, Sequence

import torch

from .generate import load_minimagen, load_params
from .models.imagen import Imagen
from .models.unet import Base, BaseTest, Super, SuperTest, UnetConfig
from .ops import kernels
from .parallel import collectives
from .parallel.mesh import make_mesh
from .training import (
    MU_DTYPES,
    ConceptualCaptions,
    DataLoader,
    MinimagenCollator,
    MinimagenTrain,
    create_directory,
    get_default_args,
    get_minimagen_dl_opts,
    get_minimagen_parser,
    get_model_params,
    get_model_size,
    imagen_config_dict,
    load_restart_training_parameters,
    load_testing_parameters,
    make_optimizer,
    save_training_info,
)


def build_parser():
    """:func:`training.get_minimagen_parser` with train.py's flags and
    ``--DEVICE``."""
    parser = get_minimagen_parser()
    add = parser.add_argument
    add("-ts", "--TIMESTAMP", dest="timestamp", type=str, default=None,
        help="Timestamp for training directory")
    add("--MESH", dest="MESH", choices=["none", "data"], default="none",
        help="Data-parallel over all visible devices ('data') or single device")
    add("--BF16", dest="BF16", action="store_true", help="bfloat16 compute (f32 params/norms/softmax)")
    add("--REMAT", dest="REMAT", action="store_true",
        help="Recompute U-Net blocks in the backward pass (activation memory for recompute)")
    add("--MU_DTYPE", dest="MU_DTYPE", choices=["f32", "bf16"], default="f32",
        help="Adam first-moment dtype")
    add("--MIN_SNR_GAMMA", dest="MIN_SNR_GAMMA", type=float, default=None,
        help="Min-SNR loss weighting gamma (arXiv 2303.09556); None = unweighted loss")
    add("--OFFSET_NOISE", dest="OFFSET_NOISE", type=float, default=None,
        help="Offset-noise scale of the forward-process noise; None/0 = off")
    add("--ZERO1", dest="ZERO1", choices=["on", "off", "fsdp"], default="on",
        help="Optimizer/param sharding over the 'data' axis of a mesh run")
    add("--DEVICE", dest="DEVICE", default="cuda", help="torch device to train on (default cuda)")
    return parser


def _fresh_imagen(unets_params, imagen_params, args) -> Imagen:
    """The cascade from config dicts, a flax-style init from seed 0 (the JAX
    CLI's PRNGKey(0)) made on the device."""
    dev = torch.device(args.DEVICE)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(0)
        return Imagen(unets=[UnetConfig.from_dict(p) for p in unets_params], **imagen_params,
                      dtype=torch.bfloat16 if args.BF16 else torch.float32,
                      param_dtype=torch.float32, remat=args.REMAT, device=dev)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    mesh = make_mesh(device=args.DEVICE) if args.MESH == "data" else None
    writer = mesh is None or mesh.is_leader
    timestamp = args.timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
    if mesh is not None:
        args.DEVICE = str(mesh.device)
        timestamp = collectives.broadcast_object(timestamp, mesh.world)
    dir_path = f"./training_{timestamp}"
    if writer:
        training_dir = create_directory(dir_path)
    if mesh is not None:
        collectives.barrier(mesh.world)
        training_dir = create_directory(dir_path)

    if args.RESTART_DIRECTORY is not None:
        args = load_restart_training_parameters(args)
    elif args.PARAMETERS is not None:
        args = load_restart_training_parameters(args, justparams=True)
    if args.TESTING:
        args = load_testing_parameters(args)
    train_dataset, valid_dataset = ConceptualCaptions(args, smalldata=args.TESTING,
                                                      device=args.DEVICE)
    dl_opts = {**get_minimagen_dl_opts(None), "batch_size": args.BATCH_SIZE,
               "num_workers": args.NUM_WORKERS,
               "collate_fn": MinimagenCollator(max_length=args.MAX_NUM_WORDS)}
    train_dataloader = DataLoader(train_dataset, **dl_opts)
    valid_dataloader = DataLoader(valid_dataset, **dl_opts)

    if args.RESTART_DIRECTORY is None:
        imagen_params = dict(image_sizes=(int(args.IMG_SIDE_LEN / 2), args.IMG_SIDE_LEN),
                             timesteps=args.TIMESTEPS, cond_drop_prob=0.15,
                             text_encoder_name=args.T5_NAME)
        if args.TESTING:
            unets_params = [get_default_args(BaseTest), get_default_args(SuperTest)]
        elif not args.PARAMETERS:
            unets_params = [get_default_args(Base), get_default_args(Super)]
        else:
            unets_params, imagen_params = get_model_params(args.PARAMETERS)
            imagen_params = {k: v for k, v in imagen_params.items() if k != "unets"}
        if args.MIN_SNR_GAMMA is not None:
            imagen_params["min_snr_gamma"] = args.MIN_SNR_GAMMA
        if args.OFFSET_NOISE is not None:
            imagen_params["offset_noise_scale"] = args.OFFSET_NOISE
        imagen = _fresh_imagen(unets_params, imagen_params, args)
    else:
        orig_train_dir = os.path.join(os.getcwd(), args.RESTART_DIRECTORY)
        _, imagen_params = load_params(orig_train_dir)
        imagen_params = {k: v for k, v in imagen_params.items() if k != "unets"}
        imagen = load_minimagen(orig_train_dir, device=args.DEVICE,
                                dtype=torch.bfloat16 if args.BF16 else torch.float32,
                                param_dtype=torch.float32)
        for unet in imagen.unets:
            unet.remat = args.REMAT
        if args.MIN_SNR_GAMMA is not None or args.OFFSET_NOISE is not None:
            imagen.set_training_levers(min_snr_gamma=args.MIN_SNR_GAMMA,
                                       offset_noise_scale=args.OFFSET_NOISE)
            imagen_params["min_snr_gamma"] = imagen.min_snr_gamma
            imagen_params["offset_noise_scale"] = imagen.offset_noise_scale
    unets = imagen.unet_configs
    unets_params = [cfg.to_dict() for cfg in imagen.unet_configs]
    imagen_params = imagen_config_dict(imagen_params)
    if writer:
        save_training_info(args, timestamp, unets_params, imagen_params, get_model_size(imagen),
                           training_dir)
    optimizer = make_optimizer(args.OPTIM_LR, args.ACCUM_ITER, mu_dtype=MU_DTYPES[args.MU_DTYPE])
    summary = MinimagenTrain(timestamp, args, unets, imagen, train_dataloader, valid_dataloader,
                             training_dir, optimizer, timeout=30, mesh=mesh)
    if writer:
        print(json.dumps({"training_directory": os.path.abspath(dir_path), "summary": summary,
                          "launches": dict(kernels.LAUNCHES)}), flush=True)
    return summary


if __name__ == "__main__":
    main()
