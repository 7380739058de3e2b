"""Mode ``sample``: closed-loop guided cascade sampling with DDIM in both
stages and no encoder cache, one caller, calls back to back through the
port's ``Imagen.sample``.

Each call samples one of ``CAPTION_SETS`` caption sets (cycled) with its
own draws, and copies its images to the host. The call to check is drawn
from the seed over every call the window makes: call ``i`` replaces the
kept one with probability ``1 / (i + 1)``, so the one kept at the close is
any of the window's calls with equal chance. In a kept call, a forward
pre-hook and a forward hook on each U-Net copy, for ``CHECK_ROWS`` rows
(the longest caption, the last row and rows drawn from the seed; every row
of a smaller call), the image entering each U-Net call and the U-Net's
output for them into host buffers, without a host sync: the comparison
follows the program from those (``compare.sampling_gaps``). The warm call
keeps its rows too, so that the buffers are made in set-up.

A sampler other than DDIM, or the encoder cache, is another mode: the
reference here follows DDIM steps.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional

import torch

from .. import compare, program, traffic, work
from ..reference import cascade as rc

SAMPLER = "ddim"
CAPTION_SETS = 4
CHECK_ROWS = 8


class Mode:
    unit = "call"
    ranges = ("unet0", "unet1")  # opened in a traced run, to label its idle gaps

    def __init__(self, ctx):
        self.ctx = ctx
        self.w, self.cfg = ctx.workload, ctx.config
        self.b = self.w["captions_per_call"]
        self.sets = [traffic.captions(self.b, self.w["caption_tokens"],
                                      self.cfg["text_embed_dim"], ctx.seed, k, ctx.device)
                     for k in range(CAPTION_SETS)]
        self.pick = torch.Generator().manual_seed(traffic.sub_seed(ctx.seed, "check"))
        self.pinned = torch.device(ctx.device).type == "cuda"
        self.host: Dict = {}  # (kind, stage, U-Net call) -> host buffer
        self.current: Optional[Dict] = None
        self.record: Optional[Dict] = None
        self.calls = 0
        self.unet_calls = [0] * len(self.cfg["unets"])

    # ------------------------------------------------------------------ #
    def setup(self) -> None:
        self.weights = self.ctx.make_weights()
        self.imagen = program.build(self.cfg, self.weights,
                                     self.w.get("param_dtype", self.cfg["param_dtype"]),
                                     self.ctx.device)
        for s, unet in enumerate(self.imagen.unets):
            unet.register_forward_pre_hook(self._in_keeper(s), with_kwargs=True)
            unet.register_forward_hook(self._out_keeper(s))
        self.call(None, keep=True)  # every shape of the cell once, and the buffers
        self.record = None
        torch.cuda.synchronize()

    def _in_keeper(self, stage: int):
        def hook(module, args, kwargs):
            self.unet_calls[stage] += 1
            if self.current is not None:
                self._keep("inputs", stage, args[0][self.current["rows_dev"]])
        return hook

    def _out_keeper(self, stage: int):
        def hook(module, args, out):
            if self.current is not None:
                rows = self.current["rows_dev"]
                self._keep("unet_out", stage, torch.cat([out[rows], out[rows + out.shape[0] // 2]]))
        return hook

    def _keep(self, kind: str, stage: int, x: torch.Tensor) -> None:
        """Copy `x` into the next host buffer of the kept call's `kind`."""
        kept = self.current[kind][stage]
        key = (kind, stage, len(kept))
        buf = self.host.get(key)
        if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
            buf = self.host[key] = torch.empty(x.shape, dtype=x.dtype, pin_memory=self.pinned)
        buf.copy_(x, non_blocking=self.pinned)
        kept.append(buf)

    def _rows(self, call: int) -> torch.Tensor:
        """The rows checked in `call`: the longest caption, the last row, and
        rows drawn from the seed, ``CHECK_ROWS`` in all (host indices)."""
        lengths = self.sets[call % CAPTION_SETS][2]
        first = list(dict.fromkeys([max(range(self.b), key=lambda i: lengths[i]), self.b - 1]))
        rest = [i for i in range(self.b) if i not in first]
        g = torch.Generator().manual_seed(traffic.sub_seed(self.ctx.seed, "rows", call))
        drawn = torch.randperm(len(rest), generator=g)[: max(CHECK_ROWS - len(first), 0)]
        return torch.tensor(sorted(first + [rest[i] for i in drawn.tolist()]))

    def call(self, index: Optional[int], keep: bool = False):
        """Sampling call `index` (None: the warm call); returns the host
        images. `keep`: keep its checked rows as the call to check."""
        index = -1 if index is None else index
        enc, mask, _ = self.sets[index % CAPTION_SETS]
        rec = None
        if keep:
            rows = self._rows(index)
            rec = {"call": index, "rows": rows, "rows_dev": rows.to(self.ctx.device),
                   "inputs": [[] for _ in self.cfg["unets"]],
                   "unet_out": [[] for _ in self.cfg["unets"]]}
        self.current = rec
        outs = self.imagen.sample(
            text_embeds=enc, text_masks=mask, cond_scale=self.w["cond_scale"],
            sampler=SAMPLER, sample_steps=self.w["sample_steps"], cache_interval=None,
            lowres_sample_noise_level=self.cfg["lowres_sample_noise_level"],
            noise=traffic.CallNoise(self.ctx.seed, index, self.ctx.device),
            return_all_stage_outputs=True)
        host = outs[-1].cpu()  # also waits for the kept rows' copies
        self.current = None
        if rec is not None:
            rows = rec.pop("rows_dev")
            rec["outputs"] = [o[rows].cpu() for o in outs[:-1]]
            rec["host_output"] = host[rec["rows"]]
            self.record = rec
        return host

    # ------------------------------------------------------------------ #
    def measure(self, seconds: float) -> Dict:
        """Calls back to back until `seconds` have passed; images/s over the
        calls' own time."""
        n0 = list(self.unet_calls)
        start = time.perf_counter()
        busy, images, each = 0.0, 0, []
        while True:
            i = self.calls
            keep = float(torch.rand((), generator=self.pick)) * (i + 1) < 1.0
            t0 = time.perf_counter()
            self.call(i, keep)
            t1 = time.perf_counter()
            self.calls += 1
            busy += t1 - t0
            each.append(round(t1 - t0, 3))
            images += self.b
            if t1 - start >= seconds:
                break
        print(f"portbench: call seconds {each}; call {self.record['call']} checked",
              file=sys.stderr)
        flops = sum((self.unet_calls[s] - n0[s]) * self._unet_flops(s)
                    for s in range(len(self.unet_calls)))
        return {"images_per_s": images / busy, "attempted": images, "calls": len(each),
                "seconds": busy, "flops_per_s": flops / busy}

    def _unet_flops(self, s: int) -> int:
        longest = max(e.shape[1] for e, _, _ in self.sets)
        return work.unet_forward_flops(self.ctx.unet_cfgs[s], 2 * self.b,
                                       self.cfg["image_sizes"][s], longest)

    def traced_units(self, n: int, ranges) -> int:
        for _ in range(n):
            with ranges.span("call"):
                self.call(self.calls)
            self.calls += 1
        return n

    # ------------------------------------------------------------------ #
    def release(self) -> None:
        del self.imagen
        gc.collect()
        torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The widest gaps in the kept call."""
        if self.record is None:
            raise RuntimeError("the window kept no call for the check")
        rc.no_tf32()
        dev = self.ctx.device
        nets = rc.build_unets(self.ctx.unet_cfgs, [self.weights.state_dict(u) for u in
                                                   range(len(self.ctx.unet_cfgs))], dev)
        scheds = [rc.Schedule(self.cfg["timesteps"], dev) for _ in nets]
        return self.gaps(nets, scheds, self.record)

    def gaps(self, nets, scheds, rec) -> Dict[str, float]:
        dev = self.ctx.device
        index, rows = rec["call"], rec["rows"].to(dev)
        enc, mask, _ = self.sets[index % CAPTION_SETS]
        noise = traffic.CallNoise(self.ctx.seed, index, dev)
        sizes = self.cfg["image_sizes"]
        shape = lambda s: (self.b, sizes[s], sizes[s], 3)  # noqa: E731
        record = {"text": enc[rows], "mask": mask[rows], "inputs": rec["inputs"],
                  "unet_out": rec["unet_out"],
                  "outputs": [o.to(dev) for o in rec["outputs"]] + [rec["host_output"].to(dev)],
                  # the call's draws: base start, then the SR stage's
                  # augmentation noise and start
                  "init": [noise.draw(0, shape(0))[rows], noise.draw(2, shape(1))[rows]],
                  "lowres_noise": noise.draw(1, shape(1))[rows]}
        print(f"portbench: checked call {index}, rows {rec['rows'].tolist()} of {self.b}",
              file=sys.stderr)
        return compare.sampling_gaps(
            nets, scheds, scheds[0], record, sizes=sizes, steps=self.w["sample_steps"],
            cond_scale=self.w["cond_scale"],
            percentile=self.cfg["dynamic_thresholding_percentile"],
            lowres_noise_level=self.cfg["lowres_sample_noise_level"])
