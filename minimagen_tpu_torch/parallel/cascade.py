"""Cascade-stage parallelism: each U-Net trains on its own process group
(counterpart of ``minimagen_tpu/parallel/cascade.py``).

The stages' losses are independent (each draws its own noise and times; no
gradient crosses stages), so the world splits into one equal group per
stage, and a group runs only its stage's data-parallel step: a batch takes
the longest stage's time instead of the sum. Every process runs the same
program; each builds the whole cascade and trains the stage its group owns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import training
from . import collectives
from .mesh import Mesh, shard_batch


def make_stage_meshes(num_stages: int, group: Optional[collectives.Group] = None) -> List[Mesh]:
    """The world (or `group`) split into `num_stages` equal groups of
    consecutive ranks, each a mesh; every process calls this, and is a
    member (``mesh.rank >= 0``) of exactly one."""
    group = group if group is not None else collectives.world()
    if group.size % num_stages:
        raise ValueError(f"{group.size} processes do not split into {num_stages} stage groups")
    per = group.size // num_stages
    return [Mesh(collectives.new_group(group.ranks[s * per:(s + 1) * per]))
            for s in range(num_stages)]


def make_stage_train_step(imagen, stage: int, optimizer: training.ClippedAdam,
                          mesh: Optional[Mesh] = None):
    """fn(state, batch, seed=0, draws=None) -> (state, loss): one stage's
    step, its draws from a generator seeded ``fold_in(fold_in(seed, step),
    stage)`` for the whole batch (or `draws`, that stage's dict); `batch`
    is this process's rows on a `mesh`."""
    step_fn = training.make_train_step(imagen, optimizer, mesh=mesh, stages=(stage,))

    def stage_step(state, batch: Dict[str, torch.Tensor], seed: int = 0,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        if draws is None:
            total = batch["image"].shape[0] * (mesh.size if mesh is not None else 1)
            gen = torch.Generator(device=imagen.device).manual_seed(
                training.fold_in(training.fold_in(seed, state.step), stage))
            draws = imagen.stage_draws(stage, total, gen)
        state, losses = step_fn(state, batch, draws=[draws])
        return state, losses[0]

    return stage_step


class CascadeParallelTrainer:
    """One train step per stage per batch, each stage on its own group
    (``cascade.py:68-103``). This process trains the stage of the group it
    belongs to; :meth:`step` takes the whole batch (as host arrays), keeps
    this process's rows and returns every stage's loss."""

    def __init__(self, imagen, optimizer: training.ClippedAdam,
                 meshes: Optional[Sequence[Mesh]] = None):
        self.imagen = imagen
        self.meshes = list(meshes) if meshes is not None else make_stage_meshes(imagen.num_unets)
        if len(self.meshes) != imagen.num_unets:
            raise ValueError(f"{len(self.meshes)} stage groups for {imagen.num_unets} stages")
        self.stage = next(s for s, m in enumerate(self.meshes) if m.rank >= 0)
        self.mesh = self.meshes[self.stage]
        self.world = collectives.world()
        self.state = training.create_train_state(imagen, optimizer, mesh=self.mesh,
                                                 stages=(self.stage,))
        self.step_fn = make_stage_train_step(imagen, self.stage, optimizer, self.mesh)

    def step(self, batch: Dict[str, np.ndarray], seed: int = 0) -> np.ndarray:
        """One cascade-wide step; returns the per-stage losses."""
        rows = shard_batch(batch, self.mesh)
        rows = {k: torch.as_tensor(v, device=self.imagen.device) for k, v in rows.items()}
        self.state, loss = self.step_fn(self.state, rows, seed)
        losses = torch.zeros(self.imagen.num_unets, device=self.imagen.device)
        if self.mesh.rank == 0:
            losses[self.stage] = loss
        return collectives.all_reduce(losses, self.world).cpu().numpy()

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{'unet_<stage>': state_dict} of the stage this process trains."""
        return {f"unet_{self.stage}": self.imagen.unets[self.stage].state_dict()}
