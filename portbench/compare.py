"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``portbench/reference/``), float32 with TF32 off.

Sampling (followed step by step). For the call kept for the check (drawn
from the seed over the window's calls), the benchmark kept, for eight of
its rows (``modes/sample.py``), the image that entered every guided U-Net call
of the program and the U-Net's output (conditioned and null rows), the
stage outputs the call returned and the draws it was given. For each step:

- ``unet_gap.<stage>``: the reference U-Net on the same input image (the
  benchmark's draw at the first step, so a wrong start shows; for the
  super-resolution stage with the conditioning worked out again from the
  program's base output and the augmentation noise, so a wrong condition
  shows) against the program's output, relative L2 per row;
- ``step_gap.<stage>``: the reference's guidance, thresholding and DDIM
  step on the program's own U-Net output, against the image the program
  went on with (the last step: the image the call returned), relative L2
  per row.

Each is the widest over the rows and steps. The two are
apart because a trained model's x0 at high noise is a difference of nearly
equal terms: a step computed wholly by the reference from the program's
image would swing with the rounding of the U-Net, not with a fault.

Training (the first three steps of the state that the window then drives).
``loss_gap``: the widest gap of a stage loss over the three steps, as a
share of the reference's loss or of the noise's power (1), whichever is
larger: a trained model's loss is a small difference, so its own size
would turn rounding in the prediction into a large share;
``loss_gap_first``: the same over the first step alone.
``grad_gap``: per leaf, the gap between the norms of the first clipped
gradient (the program's from Adam's first moment after one step) as a
share of the reference leaf's norm or the median leaf's, whichever is
larger; the worst leaf. ``update_gap``: the same of the norms of each
leaf's change over the three steps, over the leaves whose reference
gradient is at least a thousandth of the median leaf's (the rest move by
round-off alone under Adam); ``update_gap_median``: the median of those
leaves' gaps. ``ema_gap``: per U-Net, the gap between the norms of the
EMA's change over the three steps (over the same leaves), as a share of
the reference's; the worst U-Net. The reference's EMA follows its own
parameters in float32, as the configuration keeps it: at d = 0.9999 a
step moves the EMA of a leaf near 1 (a norm's gain, a null embedding) by
less than half a float32 step, so rounding alone sets that leaf's change
on either side. Hence per U-Net, where the wide leaves carry the norm;
``ema_gap_leaf``, the worst leaf, is printed and not compared. A cell
compares the numbers its workload lists (PERF.md says why each).
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import cascade as rc

INF = float("inf")


def _rel(a: torch.Tensor, b: torch.Tensor, scale: float) -> float:
    return float((a.float() - b.float()).norm()) / max(scale, 1e-30)


@torch.no_grad()
def sampling_gaps(nets: Sequence, scheds: Sequence[rc.Schedule], lowres_sched: rc.Schedule,
                  record: Dict, *, sizes, steps, cond_scale, percentile,
                  lowres_noise_level) -> Dict[str, float]:
    """The widest U-Net and step gaps of each stage for one call's kept rows.

    `record` holds, for the kept rows: ``text``, ``mask``, ``init`` (the
    initial draw of each stage), ``lowres_noise``, ``inputs`` and
    ``unet_out`` (per stage, the image entering each U-Net call and the
    U-Net's (2 rows) output) and ``outputs`` (per stage, the [0, 1] images
    the call returned)."""
    gaps = {}
    base_out = None
    for s, (net, sched) in enumerate(zip(nets, scheds)):
        pairs = sched.ddim_pairs(steps)
        inputs, unet_out = record["inputs"][s], record["unet_out"][s]
        out01 = record["outputs"][s]
        base, gaps[f"unet_gap.{s}"], gaps[f"step_gap.{s}"] = out01, 0.0, 0.0
        if len(inputs) != len(pairs) or len(unet_out) != len(pairs):
            gaps[f"unet_gap.{s}"] = gaps[f"step_gap.{s}"] = INF
            base_out = base
            continue
        lowres = lowres_t = None
        if s > 0:
            lowres, lowres_t = rc.lowres_condition(base_out, sizes[s], lowres_sched,
                                                   lowres_noise_level, record["lowres_noise"])
        n, dev = record["text"].shape[0], record["text"].device
        widest_at = {}
        for i, (t, tp) in enumerate(pairs.tolist()):
            x_in = inputs[i].to(dev)
            x_t = record["init"][s] if i == 0 else x_in
            ref_out = rc.unet_pair(net, x_t, t, text_embeds=record["text"],
                                   text_mask=record["mask"], lowres_cond_img=lowres,
                                   lowres_noise_times=lowres_t)
            prog_out = unet_out[i].to(dev)
            ref_next = rc.ddim_from_output(sched, prog_out, x_in, t, tp,
                                           cond_scale=cond_scale, percentile=percentile)
            prog_next = inputs[i + 1].to(dev) if i + 1 < len(pairs) else out01 * 2.0 - 1.0
            for r in range(n):
                both = [r, n + r]
                g_u = _rel(prog_out[both], ref_out[both], float(ref_out[both].norm()))
                g_s = _rel(prog_next[r], ref_next[r], float(ref_next[r].norm()))
                for key, g in ((f"unet_gap.{s}", g_u), (f"step_gap.{s}", g_s)):
                    if _finite_or_inf(g) > gaps[key]:
                        gaps[key], widest_at[key] = _finite_or_inf(g), t
        for key, t in widest_at.items():
            print(f"portbench: widest {key} {gaps[key]:.4g} at t={t}", file=sys.stderr)
        base_out = base
    return gaps


def _finite_or_inf(x: float) -> float:
    return x if math.isfinite(x) else INF


@torch.no_grad()
def reference_call(nets, scheds, lowres_sched, *, text, mask, noise, sizes, steps, cond_scale,
                   percentile, lowres_noise_level, sampler_dtype=torch.float32) -> Dict:
    """The reference run as the program (the control): a whole call on the
    given rows with the given draws, its sampler arithmetic in
    `sampler_dtype`, returning the same kind of record."""
    b = text.shape[0]
    rec = {"text": text, "mask": mask, "init": [], "inputs": [], "unet_out": [],
           "outputs": []}
    prev = None
    for s, (net, sched) in enumerate(zip(nets, scheds)):
        lowres = lowres_t = None
        if s > 0:
            rec["lowres_noise"] = noise((b, sizes[s], sizes[s], 3))
            lowres, lowres_t = rc.lowres_condition(prev, sizes[s], lowres_sched,
                                                   lowres_noise_level, rec["lowres_noise"])
        x = noise((b, sizes[s], sizes[s], 3))
        rec["init"].append(x)
        inputs, outs = [], []
        for t, tp in sched.ddim_pairs(steps).tolist():
            inputs.append(x)
            out = rc.unet_pair(net, x, t, text_embeds=text, text_mask=mask,
                               lowres_cond_img=lowres, lowres_noise_times=lowres_t)
            outs.append(out)
            x = rc.ddim_from_output(sched, out, x, t, tp, cond_scale=cond_scale,
                                    percentile=percentile, dtype=sampler_dtype)
        prev = (x.clamp(-1.0, 1.0) + 1.0) * 0.5
        rec["inputs"].append(inputs)
        rec["unet_out"].append(outs)
        rec["outputs"].append(prev)
    return rec


# --------------------------------------------------------------------------- #
# training                                                                     #
# --------------------------------------------------------------------------- #
def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per leaf, |prog - ref| / max(ref, median(ref)) of per-leaf norms."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    return (prog - ref).abs() / torch.maximum(ref, ref.median()).clamp(min=1e-30)


def training_gaps(prog: Dict, ref: Dict, names=None) -> Dict[str, float]:
    """`prog` and `ref` hold ``losses`` (steps, stages), ``grad_norms``,
    ``change_norms``, ``ema_norms`` and ``stages`` (each leaf's U-Net), per
    leaf in one order. With leaf `names`, the worst leaves are
    printed to standard error."""
    lp, lr = prog["losses"].double().cpu(), ref["losses"].double().cpu()
    loss_gaps = (lp - lr).abs() / lr.abs().clamp(min=1.0)
    print(f"portbench: losses (step x stage) program {lp.tolist()} reference {lr.tolist()}",
          file=sys.stderr)
    g = ref["grad_norms"].double()
    moved = g >= 1e-3 * g.median()
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    update = leaf_gaps(prog["change_norms"], ref["change_norms"])
    update[~moved] = 0.0
    ema = leaf_gaps(prog["ema_norms"], ref["ema_norms"])
    ema[~moved] = 0.0
    if names is not None:
        for what, gaps, p, r in (("grad", grad, prog["grad_norms"], ref["grad_norms"]),
                                 ("update", update, prog["change_norms"], ref["change_norms"]),
                                 ("EMA", ema, prog["ema_norms"], ref["ema_norms"])):
            for i in gaps.argsort(descending=True)[:3].tolist():
                print(f"portbench: {what} gap {float(gaps[i]):.4g} at {names[i]} "
                      f"(program {float(p[i]):.6g}, reference {float(r[i]):.6g}, "
                      f"median {float(r.double().median()):.6g})", file=sys.stderr)
    stages = torch.tensor(prog["stages"])
    ema_stage = []
    for u in stages.unique().tolist():
        keep = (stages == u) & moved
        p_u = float(prog["ema_norms"].double()[keep].square().sum().sqrt())
        r_u = float(ref["ema_norms"].double()[keep].square().sum().sqrt())
        ema_stage.append(abs(p_u - r_u) / max(r_u, 1e-30))
    print(f"portbench: EMA change gap per U-Net {ema_stage}", file=sys.stderr)
    return {"loss_gap": float(loss_gaps.max()), "loss_gap_first": float(loss_gaps[0].max()),
            "grad_gap": float(grad.max()),
            "update_gap": float(update.max()),
            "update_gap_median": float(update[moved].median()),
            "ema_gap": max(ema_stage), "ema_gap_leaf": float(ema.max())}


def change_norms(params: List[torch.Tensor], weights, n_unets: int, name_of) -> torch.Tensor:
    """Per-leaf norms of each parameter's change from the initial weights,
    which `weights` draws again a block at a time. `name_of(u, name)` gives
    the index into `params` of U-Net `u`'s leaf `name`."""
    out = torch.zeros(len(params), dtype=torch.float64)
    for u in range(n_unets):
        for block in weights.blocks(u):
            for name, p0 in block.items():
                i = name_of(u, name)
                out[i] = float((params[i].detach().float() - p0.float()).norm())
    return out


@torch.no_grad()
def reference_training(unet_cfgs, weights, batches, draws, *, sizes, timesteps, lr: float,
                       ema_decay: float, steps: int, device, lowp=None,
                       lowp_inputs: bool = True) -> Dict:
    """Three (`steps`) reference train steps from the initial weights:
    stage losses summed (one backward per stage, gradients add), clip-50
    Adam, and the float32 EMA of the parameters, ``ema * d + p * (1 - d)``
    with d and 1 - d in float32 as the configuration runs it (kept on the
    host between steps); per-step losses, the first clipped gradient's, the
    total change's and the EMA's total change's per-leaf norms, and each
    leaf's U-Net. `lowp` rounds the products (the control; with
    `lowp_inputs` False, the weights alone)."""
    from .reference.unet import set_low_precision  # noqa: PLC0415

    nets = rc.build_unets(unet_cfgs, [weights.state_dict(u) for u in range(len(unet_cfgs))],
                          device)
    for net in nets:
        set_low_precision(net, lowp, inputs=lowp_inputs)
        net.train()
    scheds = [rc.Schedule(timesteps, device) for _ in nets]
    params = [p for net in nets for p in net.parameters()]
    index = {(u, n): i for i, (u, n) in enumerate(
        (u, n) for u, net in enumerate(nets) for n, _ in net.named_parameters())}
    opt = rc.ClippedAdam(params, lr)
    decay = float(np.float32(ema_decay))
    one_minus = float(np.float32(1.0) - np.float32(ema_decay))
    ema = [p.detach().to("cpu", copy=True) for p in params]
    losses, grad_norms = [], None
    for k in range(steps):
        batch, d = batches[k], draws[k]
        for p in params:
            p.grad = None
        row = []
        for s, (net, sched) in enumerate(zip(nets, scheds)):
            with torch.enable_grad():
                loss = rc.stage_loss(net, sched, s, sizes, batch["image"], batch["encoding"],
                                     batch["mask"], d[s])
                loss.backward()
            row.append(float(loss))
        losses.append(row)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        clipped = opt.step(grads)
        if k == 0:
            grad_norms = torch.tensor([float(g.norm()) for g in clipped], dtype=torch.float64)
        del grads, clipped
        for p in params:
            p.grad = None
        for e, p in zip(ema, params):
            e.copy_(e.to(device).mul_(decay).add_(p.detach(), alpha=one_minus))
    change = torch.zeros(len(params), dtype=torch.float64)
    ema_change = torch.zeros(len(params), dtype=torch.float64)
    for u in range(len(nets)):
        for block in weights.blocks(u):
            for name, p0 in block.items():
                i = index[(u, name)]
                change[i] = float((params[i].detach() - p0.float()).norm())
                ema_change[i] = float((ema[i].to(device) - p0.float()).norm())
    return {"losses": torch.tensor(losses, dtype=torch.float64), "grad_norms": grad_norms,
            "change_norms": change, "ema_norms": ema_change,
            "stages": [u for u, net in enumerate(nets) for _ in net.parameters()]}
