"""Mode ``train``: the port's train step (``training.make_train_step``)
driven back to back over batches made ahead on the card.

Set-up builds one train state from the configuration's weights and runs
its first three steps through the window's own call and feed (batches
0-2, each with its own draws); they warm every shape, and the comparison
follows them (``compare.training_gaps``): the losses, the first clipped
gradient, and the parameters' and the EMA's change. The window continues the same
state, cycling the workload's ``batches`` batches and their draws, with no
host sync between steps, and ends with a synchronize.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import compare, program, traffic, work

CHECKED_STEPS = 3


class Mode:
    unit = "step"
    ranges = ("unet0", "unet1")  # opened in a traced run, to label its idle gaps

    def __init__(self, ctx):
        self.ctx = ctx
        self.w, self.cfg = ctx.workload, ctx.config
        self.b = self.w["batch"]
        sizes, dev = self.cfg["image_sizes"], ctx.device
        self.batches = [traffic.train_batch(self.b, sizes[-1], self.w["caption_tokens"],
                                            self.cfg["text_embed_dim"], ctx.seed, k, dev)
                        for k in range(self.w["batches"])]
        self.draws = [traffic.train_draws(self.b, sizes, self.cfg["timesteps"],
                                          self.cfg["cond_drop_prob"], ctx.seed, k, dev)
                      for k in range(self.w["batches"])]
        self.steps = 0

    def setup(self) -> None:
        self.weights = self.ctx.make_weights()
        self.imagen = program.build(self.cfg, self.weights,
                                     self.w.get("param_dtype", self.cfg["param_dtype"]),
                                     self.ctx.device)
        self.state, self.step_fn = program.train_step(self.imagen, self.w["lr"],
                                                      self.w["ema_decay"])
        losses = []
        for k in range(CHECKED_STEPS):
            losses.append(self.step())
            if k == 0:  # Adam's first moment after one step is (1 - b1) g
                mu = self.state.opt_state.mu
                grad_norms = torch.stack(torch._foreach_norm(mu)).double().cpu() / 0.1
        self.names = list(self.state.names)
        index = {key: i for i, key in enumerate(self.names)}
        norms = [compare.change_norms(leaves, self.weights, len(self.imagen.unets),
                                      lambda u, n: index[(u, n)])
                 for leaves in (self.state.params, self.state.ema_params)]
        self.first = {"losses": torch.stack(losses).double().cpu(), "grad_norms": grad_norms,
                      "change_norms": norms[0], "ema_norms": norms[1],
                      "stages": [u for u, _ in self.names]}
        torch.cuda.synchronize()

    def step(self) -> torch.Tensor:
        k = self.steps % len(self.batches)
        self.state, losses = self.step_fn(self.state, self.batches[k], draws=self.draws[k])
        self.steps += 1
        return losses

    # ------------------------------------------------------------------ #
    def measure(self, seconds: float, step_events: bool = False) -> Dict:
        """Steps back to back until `seconds` have passed on the host, then
        a synchronize; images/s over that time."""
        n = 0
        events: List[torch.cuda.Event] = []
        marks: List[float] = []  # the host's clock as each step is dispatched
        torch.cuda.synchronize()
        start = time.perf_counter()
        if step_events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        while True:
            self.step()
            n += 1
            if step_events:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            marks.append(time.perf_counter())
            if marks[-1] - start >= seconds:
                break
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        flops = 3 * n * self._forward_flops()
        out = {"train_images_per_s": n * self.b / elapsed, "attempted": n, "steps": n,
               "seconds": elapsed, "flops_per_s": flops / elapsed,
               "unit_s": [b - a for a, b in zip([start, *marks], marks)]}
        if step_events:
            out["step_ms"] = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        return out

    def _forward_flops(self) -> int:
        longest = max(b["encoding"].shape[1] for b in self.batches)
        return sum(work.unet_forward_flops(self.ctx.unet_cfgs[s], self.b, size, longest)
                   for s, size in enumerate(self.cfg["image_sizes"]))

    def traced_units(self, n: int, ranges) -> int:
        for _ in range(n):
            with ranges.span("step"):
                self.step()
        return n

    # ------------------------------------------------------------------ #
    def release(self) -> None:
        del self.imagen, self.state, self.step_fn
        gc.collect()
        torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        from ..reference import cascade as rc  # noqa: PLC0415

        rc.no_tf32()
        ref = compare.reference_training(
            self.ctx.unet_cfgs, self.weights, self.batches, self.draws,
            sizes=self.cfg["image_sizes"], timesteps=self.cfg["timesteps"], lr=self.w["lr"],
            ema_decay=self.w["ema_decay"], steps=CHECKED_STEPS, device=self.ctx.device)
        names = [f"unet{u}.{n}" for u, n in self.names]
        return compare.training_gaps(self.first, ref, names)
