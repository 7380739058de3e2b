"""The inference CLI (counterpart of the root ``inference.py``):

    python -m minimagen_tpu_torch.inference -d training_<ts> [-c "a happy dog"]

The same flags: ``--CAPTIONS`` (one caption, or a .txt file of one per
line; default "a happy dog"), ``--TRAINING_DIRECTORY``, ``--SAMPLER``,
``--SAMPLE_STEPS``, ``--GRID``, ``--CACHE_INTERVAL``, ``--GUIDANCE_RESCALE``,
``--SEED`` (seeds the port's generator; default: fresh entropy) and
``--MESH``; sampling at cond_scale 3.0 into ``generated_images_<ts>/``, then
one JSON line with that directory and the kernels' launch counts.
``--DEVICE`` (default ``cuda``) is the port's one new flag.

``--MESH data`` splits the captions over the processes, one per device::

    torchrun --nproc_per_node N -m minimagen_tpu_torch.inference --MESH data -d ...

(``sample(mesh=)``: the captions padded to a multiple of N, each process
denoising its rows; without ``--SEED`` process 0's fresh seed is shared).
Process 0 writes the directory and prints the JSON line.
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from datetime import datetime
from typing import Optional, Sequence

import torch

from .generate import sample_and_save
from .ops import kernels
from .parallel import collectives
from .parallel.mesh import make_mesh


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    add = parser.add_argument
    add("-c", "--CAPTIONS", dest="CAPTIONS", default=None, type=str,
        help="Single caption to generate for or filepath for .txt file of captions to generate for")
    add("-d", "--TRAINING_DIRECTORY", dest="TRAINING_DIRECTORY", type=str,
        help="Training directory to use for inference")
    add("--SAMPLER", dest="SAMPLER", choices=["ddpm", "ddim", "dpmpp", "unipc"], default="ddpm",
        help="ddpm = all T steps; ddim / dpmpp / unipc = strided")
    add("--SAMPLE_STEPS", dest="SAMPLE_STEPS", default=None,
        type=lambda v: tuple(int(s) for s in v.split(",")) if "," in v else int(v),
        help="strided steps (default min(50, T)); a comma list sets one per stage")
    add("--GRID", dest="GRID", choices=["time", "lambda", "karras"], default="time",
        help="strided-sampler timestep spacing")
    add("--CACHE_INTERVAL", dest="CACHE_INTERVAL", default=None,
        type=lambda v: v if v == "auto" else int(v),
        help="encoder-feature caching: recompute the down path every N-th step "
             "(0/1 = off; 'auto' = the cost model, the library default)")
    add("--GUIDANCE_RESCALE", dest="GUIDANCE_RESCALE", type=float, default=0.0,
        help="CFG rescale phi (arXiv 2305.08891); 0 = plain classifier-free guidance")
    add("--SEED", dest="SEED", type=int, default=None,
        help="seed of the sampling generator (default: fresh entropy per run)")
    add("--MESH", dest="MESH", choices=["none", "data"], default="none",
        help="multi-device serving ('data'): the captions split over the processes")
    add("--DEVICE", dest="DEVICE", default="cuda", help="torch device to sample on (default cuda)")
    return parser


def read_captions(value: Optional[str]):
    """The --CAPTIONS value as a list of captions."""
    if value is None:
        print('\nNo caption supplied - using the default of "a happy dog".\n')
        return ["a happy dog"]
    if not value.endswith(".txt"):
        return [value]
    with open(value) as f:
        return [line[:-1] if line.endswith("\n") else line for line in f.readlines()]


def sample_args_from(args) -> dict:
    """The keyword arguments of ``Imagen.sample`` the flags ask for."""
    sample_args = {"cond_scale": 3.0, "sampler": args.SAMPLER, "progress": True, "grid": args.GRID}
    if args.SAMPLE_STEPS is not None:
        sample_args["sample_steps"] = args.SAMPLE_STEPS
    if args.CACHE_INTERVAL is not None:
        sample_args["cache_interval"] = args.CACHE_INTERVAL
    if args.GUIDANCE_RESCALE:
        sample_args["guidance_rescale"] = args.GUIDANCE_RESCALE
    if args.SEED is not None:
        sample_args["generator"] = torch.Generator(device=args.DEVICE).manual_seed(args.SEED)
    return sample_args


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    mesh = make_mesh(device=args.DEVICE) if args.MESH == "data" else None
    save_directory = datetime.now().strftime("generated_images_%Y%m%d_%H%M%S")
    if mesh is not None:
        args.DEVICE = str(mesh.device)
        if args.SEED is None:
            args.SEED = int.from_bytes(os.urandom(4), "little")
        args.SEED, save_directory = collectives.broadcast_object((args.SEED, save_directory),
                                                                 mesh.world)
    sample_args = sample_args_from(args)
    if mesh is not None:
        sample_args["mesh"] = mesh
    pixels = sample_and_save(read_captions(args.CAPTIONS),
                             training_directory=args.TRAINING_DIRECTORY,
                             sample_args=sample_args, save_directory=save_directory,
                             device=args.DEVICE)
    if mesh is None or mesh.is_leader:
        print(json.dumps({"save_directory": os.path.abspath(save_directory),
                          "images": len(pixels), "launches": dict(kernels.LAUNCHES)}), flush=True)
    return pixels


if __name__ == "__main__":
    main()
