"""Pipelined cascade serving: each stage samples on its own process group
(counterpart of ``minimagen_tpu/parallel/pipeline.py``).

``Imagen.sample`` runs the stages one after the other on one device set, so
the super-resolution stage idles while the base stage denoises the next
request. Here group s runs stage s only (``make_stage_meshes``); a
request's stage-s output goes from rank j of group s to rank j of group s+1
by send/recv, without waiting for it to be received, so group s starts the
next request at once. At most `depth` sends per process wait unreceived.

The numbers are ``Imagen.sample``'s at the same generator: each stage takes
the draws one generator would give it there, because the sender passes its
generator's state on with the images (``generator.get_state``), and within
a group each process keeps its rows of the whole batch's draws.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch

from ..models.imagen import rows_of_draws
from . import collectives
from .cascade import make_stage_meshes
from .mesh import Mesh, gather_rows


class CascadePipelineServer:
    """Streamed cascade sampling over per-stage process groups; every
    process runs the same requests.

    :param meshes: one mesh per stage (default ``make_stage_meshes``).
    :param sample_steps: an int or one per stage.
    :param cache_interval: encoder-feature caching per stage (None: exact;
        'auto' decides by the whole batch, as ``sample`` does).
    :param sr_start_noise_levels: truncated refinement of the super-res
        stages, as ``sample`` takes it.
    :param depth: the most unreceived sends a process keeps in flight.
    """

    def __init__(self, imagen, meshes: Optional[Sequence[Mesh]] = None, *,
                 cond_scale: float = 3.0, sampler: str = "ddim", sample_steps=None,
                 grid: str = "time", cache_interval=None, lowres_sample_noise_level=None,
                 sr_start_noise_levels=None, depth: int = 2, guidance_rescale: float = 0.0):
        self.imagen = imagen
        self.meshes = list(meshes) if meshes is not None else make_stage_meshes(imagen.num_unets)
        if len(self.meshes) != imagen.num_unets:
            raise ValueError(f"{len(self.meshes)} stage groups for {imagen.num_unets} stages")
        self.stage = next(s for s, m in enumerate(self.meshes) if m.rank >= 0)
        self.mesh = self.meshes[self.stage]
        self.options = dict(cond_scale=float(cond_scale), sampler=sampler,
                            sample_steps=sample_steps, grid=grid, cache_interval=cache_interval,
                            lowres_sample_noise_level=lowres_sample_noise_level,
                            sr_start_noise_levels=sr_start_noise_levels,
                            guidance_rescale=float(guidance_rescale))
        self.depth = int(depth)
        self._sends: List[Any] = []

    def _peer(self, stage: int) -> int:
        """The global rank of this process's counterpart in group `stage`."""
        return self.meshes[stage].group.ranks[self.mesh.rank]

    def submit(self, text_embeds, text_masks=None, *, seed: int = 0) -> Optional[torch.Tensor]:
        """One request through this process's stage, its generator seeded
        `seed` on the imagen's device (as ``sample(generator=)`` would be):
        the last group returns the (b, s, s, c) images, the others None once
        their output is on its way."""
        imagen, mesh, stage = self.imagen, self.mesh, self.stage
        text_embeds, text_masks = imagen._text_inputs(None, text_embeds, text_masks)
        total = text_embeds.shape[0]
        rows = mesh.rows(total)
        gen = torch.Generator(device=imagen.device).manual_seed(int(seed))
        img = None
        if stage > 0:
            size = imagen.image_sizes[stage - 1]
            img = torch.empty((rows.stop - rows.start, size, size, imagen.channels),
                              device=imagen.device)
            state = gen.get_state()
            collectives.recv(img, self._peer(stage - 1), mesh.group)
            collectives.recv(state, self._peer(stage - 1), mesh.group)
            gen.set_state(state)
        img = imagen.cascade_stage(
            stage, img, text_embeds[rows], None if text_masks is None else text_masks[rows],
            draw=rows_of_draws(imagen._noise_fn(None, gen), total, rows), total_rows=total,
            **self.options)
        if stage == len(self.meshes) - 1:
            return gather_rows(img, mesh, total)
        self._sends += [collectives.isend(img, self._peer(stage + 1), mesh.group),
                        collectives.isend(gen.get_state(), self._peer(stage + 1), mesh.group)]
        while len(self._sends) > 2 * self.depth:
            self._sends.pop(0).wait()
        return None

    def flush(self) -> None:
        """Wait until every send of this process has been received."""
        while self._sends:
            self._sends.pop(0).wait()

    def serve(self, requests: Iterable[Dict[str, Any]]):
        """Yield one result per request, in order: the images on the last
        group, None elsewhere. Each request holds 'text_embeds' and
        optionally 'text_masks' and 'seed'."""
        for req in requests:
            yield self.submit(req["text_embeds"], req.get("text_masks"),
                              seed=req.get("seed", 0))
        self.flush()
