"""Training on one device (counterpart of ``minimagen_tpu/parallel/mesh.py:250-367``
and of ``examples/train_flagship_tpu.py --model lite``).

- :func:`make_optimizer`: global-norm clipping at 50, then Adam (eps 1e-8),
  as the JAX package's optax chain. ``torch.optim.Adam``'s update is optax
  ``adam``'s arithmetic (bias corrections folded into the step size and the
  denominator); the clip scales every gradient by ``min(1, 50 / norm)``, the
  norm taken in float32 over all of them, as optax's ``clip_by_global_norm``.
- :class:`TrainState` and :func:`create_train_state`: the step counter, the
  float32 master parameters of every U-Net, the optimizer and, optionally, an
  exponential moving average of the parameters held as a real float32 copy.
- :func:`make_train_step`: one step sums every stage's loss, runs one
  backward pass, clips, steps Adam and updates the EMA. Its random draws come
  from a generator seeded by the caller's seed with the global step folded
  in, so a run repeats exactly.
- :func:`get_model_params` and :func:`get_default_args`: the U-Net and
  Imagen parameters of a ``parameters/`` directory and of a preset
  (``minimagen_tpu/training.py:241-275``); ``generate.default_imagen``
  builds a cascade from them.
- :func:`train_lite`: the lite cascade trained from a fresh flax-style init
  on the synthetic set with the committed run's recipe (``assets/lite_ckpt/
  meta.json``: its held-out combos, 512 items, batch 16, lr 1e-4, EMA 0.9995)
  but one difference: Adam's first moment stays float32, where that run kept
  it in bf16 (``examples/train_flagship_tpu.py`` always passes ``--mu_bf16``).

Not ported yet: the ``MinimagenTrain`` harness, checkpoint writing, gradient
accumulation (``optax.MultiSteps``) and a bf16 first moment.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.collate import MinimagenCollator
from .data.dataset import SyntheticCaptionedImages
from .generate import LITE_CKPT_DIR, lite_imagen
from .models.imagen import Imagen
from .models.unet import UnetConfig

GRAD_CLIP_NORM = 50.0
DATA_SEED = 42  # the seed train_lite's steps fold their step into


@dataclass(frozen=True)
class ClippedAdam:
    """Global-norm clipping followed by Adam (b1 0.9, b2 0.999, eps 1e-8, as
    optax's defaults); :meth:`init` binds it to the parameters as a
    ``torch.optim.Adam``."""

    lr: float

    def init(self, params: Sequence[torch.nn.Parameter]) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def clip(self, params: Sequence[torch.nn.Parameter]) -> torch.Tensor:
        """Scale the gradients by min(1, GRAD_CLIP_NORM / norm), the global
        norm in float32 (optax's ``clip_by_global_norm``, without a host
        sync); returns the norm before clipping."""
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [n.float() for n in torch._foreach_norm(grads)]))
        scale = (GRAD_CLIP_NORM / norm).clamp(max=1.0)
        for dtype in {g.dtype for g in grads}:
            torch._foreach_mul_([g for g in grads if g.dtype == dtype], scale.to(dtype))
        return norm


def make_optimizer(lr: float) -> ClippedAdam:
    """Adam + global-norm clip 50 (the JAX package's ``make_optimizer``)."""
    return ClippedAdam(lr)


@dataclass
class TrainState:
    step: int
    params: List[torch.nn.Parameter]
    opt_state: torch.optim.Adam
    ema_params: Optional[List[torch.Tensor]] = None


def unet_parameters(imagen: Imagen) -> List[torch.nn.Parameter]:
    """Every U-Net's parameters, stage by stage, in module order."""
    return [p for unet in imagen.unets for p in unet.parameters()]


def create_train_state(imagen: Imagen, optimizer: ClippedAdam, *, ema: bool = False) -> TrainState:
    """Fresh state over the U-Nets' parameters; `ema` also keeps a float32
    copy of them for the moving average."""
    params = unet_parameters(imagen)
    ema_params = [p.detach().float().clone() for p in params] if ema else None
    return TrainState(step=0, params=params, opt_state=optimizer.init(params),
                      ema_params=ema_params)


def fold_in(seed: int, step: int) -> int:
    """A 63-bit generator seed for `step` of the run seeded by `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{int(step)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_train_step(imagen: Imagen, optimizer: ClippedAdam, ema_decay: float = 0.9999):
    """fn(state, batch, seed=0, draws=None) -> (state, losses (num_unets,)).

    `batch` = {'image': (b, s, s, 3) in [0, 1], 'encoding': (b, L, d),
    'mask': (b, L)} on the imagen's device. `draws`, one dict per stage of
    injected ``stage_loss`` draws (times, lowres_aug_times, noise,
    lowres_noise, keep_mask), replaces the generator's. The EMA update is
    ``ema * d + p * (1 - d)`` in float32, with d and 1 - d rounded to
    float32 as the JAX package computes them."""
    d32 = np.float32(ema_decay)
    decay, one_minus = float(d32), float(np.float32(1.0) - d32)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], seed: int = 0,
                draws: Optional[List[Dict[str, torch.Tensor]]] = None):
        gen = torch.Generator(device=imagen.device).manual_seed(fold_in(seed, state.step))
        losses = [imagen.stage_loss(i, batch["image"], batch["encoding"], batch["mask"],
                                    generator=gen, **(draws[i] if draws else {}))
                  for i in range(imagen.num_unets)]
        state.opt_state.zero_grad(set_to_none=True)
        torch.stack(losses).sum().backward()
        for p in state.params:  # optax updates every leaf, gradient or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.clip(state.params)
        state.opt_state.step()
        if state.ema_params is not None:
            with torch.no_grad():
                torch._foreach_mul_(state.ema_params, decay)
                torch._foreach_add_(state.ema_params, [p.detach().float() for p in state.params],
                                    alpha=one_minus)
        state.step += 1
        return state, torch.stack([loss.detach() for loss in losses])

    return step_fn


def stage_batches(num_items: int, batch: int, size: int, max_length: int, encoder_name: str,
                  combos=None, device="cuda") -> Dict[str, torch.Tensor]:
    """The whole synthetic set as stacked (K, b, ...) tensors on `device`
    (K = num_items // batch), batch k holding items k*b ... k*b + b - 1."""
    ds = SyntheticCaptionedImages(num_items=num_items, side_length=size,
                                  encoder_name=encoder_name, max_length=max_length,
                                  combos=combos, device=device)
    coll = MinimagenCollator(max_length=max_length)
    items = [ds[i] for i in range(num_items)]
    stacks = [coll(items[i * batch:(i + 1) * batch]) for i in range(num_items // batch)]
    return {k: torch.as_tensor(np.stack([s[k] for s in stacks]), device=device)
            for k in stacks[0]}


@dataclass
class LiteRun:
    losses: np.ndarray          # (steps, num_unets) per-step losses
    host_ms_per_step: float     # host clock around the steps, synchronized
    imagen: Imagen
    state: TrainState
    step_fn: Callable           # the run's train step, to go on training
    batches: Dict[str, torch.Tensor]  # the staged (K, b, ...) batches


def train_lite(steps: int, batch: int = 16, *, items: int = 512, seed: int = 0,
               device="cuda") -> LiteRun:
    """Train the lite cascade from a fresh flax-style init (from `seed`) for
    `steps` steps with the committed run's recipe (``assets/lite_ckpt/
    meta.json``): the synthetic set without its held-out combos, `items`
    items staged once as items // batch batches and cycled in order,
    clip-50 Adam at its lr, its EMA decay, float32 master parameters and
    bf16 compute. Adam's first moment is float32; the committed run kept it
    in bf16. Returns the per-step losses of both stages."""
    with open(os.path.join(LITE_CKPT_DIR, "meta.json")) as f:
        config = json.load(f)["config"]
    held = set(config["held_combos"])
    combos = [i for i in range(18) if i not in held]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        imagen = lite_imagen(config["encoder"], dtype=torch.bfloat16, param_dtype=torch.float32,
                             device=device)
    stacked = stage_batches(items, batch, imagen.image_sizes[-1], config["max_length"],
                            config["encoder"], combos=combos, device=device)
    n_batches = stacked["image"].shape[0]
    optimizer = make_optimizer(config["lr"])
    state = create_train_state(imagen, optimizer, ema=config["ema"] > 0)
    step_fn = make_train_step(imagen, optimizer, ema_decay=config["ema"])
    sync = torch.cuda.synchronize if imagen.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        k = state.step % n_batches
        state, step_losses = step_fn(state, {name: v[k] for name, v in stacked.items()},
                                     seed=DATA_SEED)
        losses.append(step_losses)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    return LiteRun(losses=torch.stack(losses).float().cpu().numpy(), host_ms_per_step=ms,
                   imagen=imagen, state=state, step_fn=step_fn, batches=stacked)


def get_model_params(parameters_dir: str) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """The U-Net parameter dicts (``unet_<i>_*.json``, in i order) and the
    Imagen parameters (``imagen*.json``) of a parameters directory."""
    im_params = None
    unets_params: List[str] = []
    for file in os.listdir(parameters_dir):
        if file.startswith("imagen"):
            im_params = file
        elif file.startswith("unet_"):
            unets_params.append(file)
    unets_params = sorted(unets_params, key=lambda x: int(x.split("_")[1]))
    loaded = []
    for name in unets_params:
        with open(os.path.join(parameters_dir, name)) as f:
            loaded.append(json.load(f))
    with open(os.path.join(parameters_dir, im_params)) as f:
        return loaded, json.load(f)


def get_default_args(obj) -> Dict[str, Any]:
    """The default arguments of a callable or config class; a preset
    (``Base``, ``Super``, ...) merges its ``defaults`` over UnetConfig's."""
    if inspect.isclass(obj) and issubclass(obj, UnetConfig):
        base = {f.name: f.default for f in dataclasses.fields(UnetConfig)
                if f.default is not dataclasses.MISSING}
        return {**base, **obj.defaults} if obj is not UnetConfig else base
    signature = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)
    return {k: v.default for k, v in signature.parameters.items()
            if v.default is not inspect.Parameter.empty}


def window_means(losses: np.ndarray, width: int = 200) -> List[List[float]]:
    """Each stage's mean loss over consecutive `width`-step windows (the rows
    of the committed run's history.json)."""
    return [losses[i:i + width].mean(axis=0).tolist()
            for i in range(0, len(losses) - width + 1, width)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m minimagen_tpu_torch.training [--steps 400] [--seed 0]``:
    run :func:`train_lite` and print one JSON line with the seed, each stage's
    mean loss over every 200-step window and the host ms per step."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    run = train_lite(args.steps, seed=args.seed)
    print(json.dumps({"seed": args.seed, "steps": args.steps,
                      "finite": bool(np.isfinite(run.losses).all()),
                      "window_means": window_means(run.losses),
                      "host_ms_per_step": run.host_ms_per_step}), flush=True)


if __name__ == "__main__":
    main()
