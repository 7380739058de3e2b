"""Readings from which a cell's limits are set (not run by the benchmark's
own runs).

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 ... --control-seeds 1 2 3

For each seed, one run of the cell as the benchmark makes it (a short
window) gives the program's compared numbers: the largest over sound seeds
is the lower reading. For each control seed, the reference is put in the
program's place, each part in the nearest precision below the one the
configuration states: the U-Nets' products in float8 (e4m3, per-tensor
scaled; the configuration computes them in bf16), the sampler's arithmetic
in bf16 (float32 in the program), the train step's products in float8; it
is judged by the same comparison, and the smallest is the upper reading. A
training cell's numbers are also read with faults planted in the program
(``--faults``, on ``--fault-seeds``): half of each batch left out, and a
state left unchanged, an EMA left unchanged. ``--look-seeds`` reads a
training cell's gaps against the reference with its weights rounded to bf16
(``look_training``). One JSON line per run (every gap the check works out,
compared or not), and a summary line last.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import torch

from . import compare, faults, run, traffic
from .reference import cascade as rc
from .reference.unet import bf16_rounding, fp8_rounding, set_low_precision


def control_sampling(ctx: run.Context) -> Dict[str, float]:
    """The fp8 reference as the program, on the rows a run would check in
    its first call."""
    from .modes.sample import CAPTION_SETS, Mode  # noqa: PLC0415

    rc.no_tf32()
    mode = Mode(ctx)
    mode.weights = ctx.make_weights()
    w, cfg = ctx.workload, ctx.config
    sds = [mode.weights.state_dict(u) for u in range(len(ctx.unet_cfgs))]
    low = rc.build_unets(ctx.unet_cfgs, sds, ctx.device)
    for net in low:
        set_low_precision(net, fp8_rounding)
    nets = rc.build_unets(ctx.unet_cfgs, sds, ctx.device)
    del sds
    scheds = [rc.Schedule(cfg["timesteps"], ctx.device) for _ in nets]
    call = 0
    rows = mode._rows(call)
    enc, mask, _ = mode.sets[call % CAPTION_SETS]
    noise = traffic.CallNoise(ctx.seed, call, ctx.device)
    order = iter(range(3))  # the call's draws, in the order a call makes them
    rows_dev = rows.to(ctx.device)
    draw = lambda shape: noise.draw(next(order), (mode.b,) + tuple(shape[1:]))[rows_dev]  # noqa: E731
    rec = compare.reference_call(
        low, scheds, scheds[0], text=enc[rows_dev], mask=mask[rows_dev], noise=draw,
        sizes=cfg["image_sizes"], steps=w["sample_steps"], cond_scale=w["cond_scale"],
        percentile=cfg["dynamic_thresholding_percentile"],
        lowres_noise_level=cfg["lowres_sample_noise_level"], sampler_dtype=torch.bfloat16)
    record = {"call": call, "rows": rows, "inputs": rec["inputs"], "unet_out": rec["unet_out"],
              "outputs": rec["outputs"][:-1], "host_output": rec["outputs"][-1]}
    return mode.gaps(nets, scheds, record)


def _training_kw(ctx: run.Context) -> Dict:
    from .modes.train import CHECKED_STEPS  # noqa: PLC0415

    return dict(sizes=ctx.config["image_sizes"], timesteps=ctx.config["timesteps"],
                lr=ctx.workload["lr"], ema_decay=ctx.workload["ema_decay"],
                steps=CHECKED_STEPS, device=ctx.device)


def control_training(ctx: run.Context) -> Dict[str, float]:
    """The fp8 reference's three steps as the program's."""
    from .modes.train import Mode  # noqa: PLC0415

    rc.no_tf32()
    mode = Mode(ctx)
    weights = ctx.make_weights()
    low = compare.reference_training(ctx.unet_cfgs, weights, mode.batches, mode.draws,
                                     lowp=fp8_rounding, **_training_kw(ctx))
    torch.cuda.empty_cache()
    ref = compare.reference_training(ctx.unet_cfgs, weights, mode.batches, mode.draws,
                                     **_training_kw(ctx))
    return compare.training_gaps(low, ref)


def look_training(ctx: run.Context) -> Dict[str, Dict[str, float]]:
    """The program's first three steps against the reference as it stands
    and against the reference with its weights rounded to bf16 before each
    product (``bf16_weights``), and with its products' inputs rounded too
    (``bf16_products``): where the program's gaps come from its bf16 casts
    of its float32 masters, they fall against those."""
    from .modes.train import Mode  # noqa: PLC0415

    mode = Mode(ctx)
    mode.setup()
    mode.release()
    rc.no_tf32()
    out = {}
    for name, lowp, inputs in (("float32", None, True), ("bf16_weights", bf16_rounding, False),
                               ("bf16_products", bf16_rounding, True)):
        ref = compare.reference_training(ctx.unet_cfgs, mode.weights, mode.batches, mode.draws,
                                         lowp=lowp, lowp_inputs=inputs, **_training_kw(ctx))
        out[name] = compare.training_gaps(mode.first, ref)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", default=["train_half_batch"],
                        choices=faults.FAULTS)
    parser.add_argument("--look-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    program, control = {}, {}
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = run.make_context(args.workload, seed)
        res = run.run_cell(ctx, args.seconds, False, run.cell_metrics(args.workload, False))
        program[seed] = dict(ctx.gaps)
        print(json.dumps({"seed": seed, "side": "program", "gaps": program[seed],
                          "correct": res["correct"], "seconds": time.perf_counter() - t}),
              flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t = time.perf_counter()
        ctx = run.make_context(args.workload, seed)
        fn = control_sampling if ctx.workload["mode"] == "sample" else control_training
        control[seed] = fn(ctx)
        print(json.dumps({"seed": seed, "side": "control", "gaps": control[seed],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    fault: Dict[str, Dict] = {name: {} for name in args.faults}
    for name in args.faults:  # planted in the program
        for seed in args.fault_seeds:
            t = time.perf_counter()
            ctx = run.make_context(args.workload, seed)
            with faults.planted(name):
                res = run.run_cell(ctx, args.seconds, False, [])
            fault[name][seed] = dict(ctx.gaps)
            print(json.dumps({"seed": seed, "side": name, "gaps": fault[name][seed],
                              "seconds": time.perf_counter() - t}), flush=True)
            torch.cuda.empty_cache()
    for seed in args.look_seeds:  # training cells
        t = time.perf_counter()
        looks = look_training(run.make_context(args.workload, seed))
        for name, gaps in looks.items():
            print(json.dumps({"seed": seed, "side": "look_" + name, "gaps": gaps,
                              "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    keys = sorted({k for g in program.values() for k in g})
    summary = {k: {"lower": max((g[k] for g in program.values() if k in g), default=None),
                   "control": min((g[k] for g in control.values() if k in g), default=None),
                   **{name: min((g[k] for g in fault[name].values() if k in g), default=None)
                      for name in args.faults}}
               for k in keys}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
