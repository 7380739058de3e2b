"""Time the port's attention, GroupNorm and depth-to-space kernels at the
lite paths' heaviest shapes (GroupNorm also at the default cascade's widest
and at a shape of each form), and guided sampling steps of the lite
cascade, to compare two checkouts on one card.

    python minimagen_tpu_torch/ab_times.py --root PATH [--reps 50] [--kernels K,...] [--forms]
        [--train-default STEPS]

imports ``minimagen_tpu_torch`` from the checkout at PATH (so this file can
time an older tree), builds its kernels and prints one JSON line: the
card, the root; per kernel and bf16 shape the median CUDA-event time of
one launch over `reps` launches (``median_ms``, the wrapper's host work
included) and the median over `reps` // 5 of the time of 20 launches back
to back over 20 (``device_ms``: the queue runs ahead of the host); per lite
stage the host ms per guided DDIM step (8 captions, 16 rows, random weights
and text encodings: the time does not depend on their values), the median
of `reps` // 10 runs of 5 steps, each ending in a synchronize; and the
device ms per step of each kernel family (attention by kind, and
GroupNorm; by kernel name) in those steps and in a lite train step (batch
16), from a torch.profiler trace. The float32 attention kernels are timed
too (``F32_SHAPES``, keys ending in "float32", with each launched kernel's
device ms per call by name from a trace), and the float32 lite
cascade's guided step per stage and train step (batch 16; float32 compute,
as the train CLI without --BF16 and the inference CLI run), host ms and
kernel families alike. ``--kernels`` times only the named kernels (e.g. mha_forward,
mha_backward) and no steps: the card then runs nothing else between their
launches. ``--forms`` times only GroupNorm's cluster and streaming forms at
FORM_SHAPES (the measurements behind the form rule). ``--train-default``
times only STEPS train steps of the default Base+Super cascade (train.py's,
seed 0) at batch 2 with clip-50 Adam and the EMA, as ``chip_smoke.py``
trains it: the host ms of each synchronized step and the peak of allocated
memory over them. Run it for trees A
and B in turns (A, B, B, A) within one call: the card and its neighbours
then stay the same.
"""
import argparse
import json
import os
import statistics
import sys
import time

# (kernel, shape): attention (b, h, n, j[, with the mask bias]), GroupNorm (b, h, w, c, with scale-shift),
# depth-to-space + bias (b, h, w, f*f*c, f); torch_group_norm is
# F.group_norm on the channels-last tensor, a row for reference that does
# less work (no scale-shift, no SiLU) and is no yardstick of the kernels
SHAPES = [("mqa_forward", (16, 8, 1024, 1025)), ("mha_forward", (16, 8, 1024, 259)),
          ("mqa_backward", (16, 8, 1024, 1025)), ("mha_backward", (16, 8, 1024, 259)),
          ("mha_backward", (16, 8, 1024, 259, True)),
          ("group_norm_forward", (16, 256, 256, 32, False)),
          ("group_norm_forward", (16, 256, 256, 32, True)),
          ("group_norm_forward", (16, 128, 128, 64, True)),
          ("group_norm_forward", (16, 64, 64, 64, True)),
          ("group_norm_forward", (8, 8, 8, 3584, True)),
          ("group_norm_backward", (16, 256, 256, 32, False)),
          ("group_norm_backward", (16, 128, 128, 64, True)),
          ("group_norm_backward", (16, 64, 64, 64, True)),
          ("group_norm_backward", (2, 8, 8, 2048, True)),
          ("torch_group_norm", (16, 256, 256, 32, False)),
          ("torch_group_norm", (16, 64, 64, 64, False)),
          ("depth_to_space_bias", (16, 64, 64, 512, 4))]


# float32 attention at the path's heaviest shapes, the multi-head pair with
# a mask bias dropping about a quarter of the keys (the train step's
# cross-attention)
F32_SHAPES = [("mqa_forward", (16, 8, 1024, 1025)), ("mqa_backward", (16, 8, 1024, 1025)),
              ("mha_forward", (16, 8, 1024, 259)), ("mha_backward", (16, 8, 1024, 259))]


def median_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps, inner=20):
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# attention kernel families by name tag: the Hopper multi-query and
# multi-head kernels, the attention_ kernels (the float32 ones: the 3xTF32
# attention_tf32_* kernels and their split pre-passes; in older trees the
# CUDA-core float32 kernels and the bf16 mma.sync ones) and the dk/dv slice
# sum
ATTENTION_FAMILIES = {"mqa (wgmma)": "mqa_", "mha (wgmma)": "mha_",
                      "attention_ (float32; older trees' mma.sync)": "attention_",
                      "kv_reduce": "kv_reduce"}
# GroupNorm by name tags: the gn_ kernels (and older trees' group_partial /
# group_apply forward kernels)
GROUP_NORM_TAGS = ("gn_", "group_partial", "group_apply")
# every family whose device ms per step the profiles report: family -> tags
FAMILIES = {**{family: (tag,) for family, tag in ATTENTION_FAMILIES.items()},
            "group_norm": GROUP_NORM_TAGS}


def family_ms(items, calls):
    """Device ms per call of each family of FAMILIES among (kernel name,
    device us) trace items of `calls` calls."""
    return {family: sum(us for name, us in items if any(t in name for t in tags)) / 1e3 / calls
            for family, tags in FAMILIES.items()}


def traced_kernel_ms(fn, calls):
    """Device ms per call of `fn` of each kernel it launches, by name, from
    a torch.profiler trace of `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0}


def traced_family_ms(fn, calls):
    """Device ms per call of `fn` of each kernel family, from a
    torch.profiler trace of `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    items = [(e.key, e.self_device_time_total) for e in prof.key_averages()
             if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    return family_ms(items, calls)


# (b, h, w, c): GroupNorm shapes of the lite and default paths at which
# --forms times both forms, the 8x8 maps on either side of the form rule's
# sample count and larger maps
FORM_SHAPES = [(16, 8, 8, 256), (8, 8, 8, 1024), (8, 8, 8, 3584), (2, 8, 8, 2048),
               (16, 16, 16, 256), (8, 16, 16, 512), (16, 64, 64, 64), (16, 64, 64, 128),
               (16, 256, 256, 32)]


def form_times(gen, calls=20):
    """Per GroupNorm shape of FORM_SHAPES, bf16 with scale-shift and SiLU:
    the form the rule takes, and for each form (where it fits) the forward's
    and backward's device ms per call, the group_norm family's kernels in a
    torch.profiler trace of `calls` calls."""
    import torch
    from minimagen_tpu_torch.ops import group_norm as gn

    out = {}
    for b, h, w, c in FORM_SHAPES:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
        x, g, gamma, beta = rnd(b, h, w, c), rnd(b, h, w, c), rnd(c) * 0.2 + 1.0, rnd(c) * 0.1
        scale, shift = rnd(b, 1, 1, c) * 0.3, rnd(b, 1, 1, c) * 0.3
        row = {"rule": [gn.plan_info(False, x, 8)["form"], gn.plan_info(True, x, 8)["form"]]}
        for form in ("cluster", "stream"):
            kw = dict(groups=8, silu=True, form=form)
            for name in ("forward", "backward"):
                try:
                    gn.plan_info(name == "backward", x, 8, form)
                except ValueError:  # the slab does not fit a cluster
                    continue
                _, mean, rstd = gn.group_norm_forward_kernel(x, gamma, beta, scale, shift,
                                                             eps=1e-5, **kw)
                call = (lambda: gn.group_norm_forward_kernel(x, gamma, beta, scale, shift,
                                                             eps=1e-5, **kw)) \
                    if name == "forward" else \
                    (lambda: gn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean,
                                                           rstd, g, **kw))
                call()
                row[f"{name} {form}"] = traced_family_ms(call, calls)["group_norm"]
        out[str((b, h, w, c))] = row
    return out


def launcher(kernel, shape, gen, dtype=None):
    """A no-argument call of `kernel` on seeded inputs of `shape` in `dtype`
    (default bf16); float32 multi-head attention, and bf16 where the shape
    asks for it, with a mask bias."""
    import torch
    from minimagen_tpu_torch.ops import flash_attention as fa
    from minimagen_tpu_torch.ops import group_norm as gn

    dtype = dtype or torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    if kernel == "depth_to_space_bias":
        from minimagen_tpu_torch.ops import stem_conv as sc

        b, h, w, cf, f = shape
        y2, bias = rnd(b, h, w, cf), rnd(cf // (f * f))
        return lambda: sc.depth_to_space_bias(y2, bias, f)
    if kernel.startswith(("mqa", "mha")):
        kind = kernel[:3]
        b, h, n, j = shape[:4]
        q = rnd(b, h, n, 64) * 0.125
        kv = (b, j, 64) if kind == "mqa" else (b, h, j, 64)
        k, v, g = rnd(*kv), rnd(*kv), rnd(b, h, n, 64)
        bias = None
        if kind == "mha" and (dtype == torch.float32 or len(shape) > 4):
            keep = torch.rand(b, j, generator=gen, device="cuda") >= 0.25
            keep[:, 0] = True
            bias = torch.where(keep, 0.0, fa.NEG_INF).float()[:, None, None, :].contiguous()
        if kernel.endswith("forward"):
            return lambda: fa.attention_forward_kernel(kind, q, k, v, bias)
        out, lse = fa.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
        return lambda: fa.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)
    b, h, w, c, with_ss = shape
    x, gamma, beta = rnd(b, h, w, c), rnd(c) * 0.2 + 1.0, rnd(c) * 0.1
    if kernel == "torch_group_norm":
        import torch.nn.functional as F

        xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor: channels-last strides
        return lambda: F.group_norm(xc, 8, gamma, beta)
    scale, shift = (rnd(b, 1, 1, c) * 0.3, rnd(b, 1, 1, c) * 0.3) if with_ss else (None, None)
    kw = dict(groups=8, silu=True)
    if kernel.endswith("forward"):
        return lambda: gn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    _, mean, rstd = gn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    g = rnd(b, h, w, c)
    return lambda: gn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)


def step_ms(stage, runs, steps=5, dtype=None):
    """Host ms per guided DDIM step of lite stage `stage` at 8 captions in
    `dtype` (default the lite cascade's bf16), and the kernel families'
    device ms per step."""
    import torch
    from minimagen_tpu_torch.generate import lite_imagen

    torch.manual_seed(0)
    imagen = lite_imagen(device="cuda", dtype=dtype or torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    size = imagen.image_sizes[stage]
    embeds = torch.randn(8, 16, imagen.text_embed_dim, generator=gen, device="cuda")
    masks = torch.ones(8, 16, dtype=torch.bool, device="cuda")
    kw = {}
    if stage:
        kw = dict(lowres_cond_img=torch.rand(8, size, size, 3, generator=gen, device="cuda"),
                  lowres_noise_times=torch.full((8,), 200, device="cuda"))
    init = torch.randn(8, size, size, 3, generator=gen, device="cuda")

    def run():
        imagen.sample_stage(stage, embeds, masks, 3.0, init_noise=init, sampler="ddim",
                            sample_steps=steps, **kw)
        torch.cuda.synchronize()

    run()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    fams = {k: v / steps for k, v in traced_family_ms(run, 1).items()}
    return statistics.median(times), fams


def train_family_ms(steps=3):
    """The kernel families' device ms per lite train step (batch 16)."""
    from minimagen_tpu_torch.training import train_lite

    run = train_lite(1, 16, items=32, device="cuda")

    def go():
        k = run.state.step % run.batches["image"].shape[0]
        run.step_fn(run.state, {name: v[k] for name, v in run.batches.items()}, seed=0)

    return traced_family_ms(go, steps)


def train_f32_ms(runs, steps=3):
    """Host ms per synchronized lite train step in float32 compute (batch
    16, float32 parameters, clip-50 Adam and the EMA at the lite recipe's
    settings: the train CLI without --BF16), the median of `runs` runs of
    `steps` steps after a warm-up, and the kernel families' device ms per
    step."""
    import torch
    from minimagen_tpu_torch.generate import lite_imagen
    from minimagen_tpu_torch.training import (create_train_state, make_optimizer,
                                              make_train_step, stage_batches)

    torch.manual_seed(0)
    imagen = lite_imagen(dtype=torch.float32, param_dtype=torch.float32, device="cuda")
    batch = {k: v[0] for k, v in stage_batches(16, 16, imagen.image_sizes[-1], 16, "t5_tiny",
                                               device="cuda").items()}
    opt = make_optimizer(1e-4)
    state = [create_train_state(imagen, opt, ema=True)]
    step = make_train_step(imagen, opt, ema_decay=0.9995)

    def go():
        state[0], _ = step(state[0], batch, seed=0)

    go()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(steps):
            go()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    return statistics.median(times), traced_family_ms(go, steps)


def train_default(steps):
    """Host ms per synchronized train step of the default cascade (batch 2
    of the synthetic set at 128px, t5_base hash encodings of at most 64
    words) and the peak allocated GiB over the steps."""
    import torch
    from minimagen_tpu_torch.generate import default_imagen
    from minimagen_tpu_torch.training import (create_train_state, make_optimizer,
                                              make_train_step, stage_batches)

    imagen = default_imagen(device="cuda", seed=0)
    batch = {k: v[0] for k, v in stage_batches(2, 2, 128, 64, "t5_base", device="cuda").items()}
    opt = make_optimizer(1e-4)
    state = create_train_state(imagen, opt, ema=True)
    step = make_train_step(imagen, opt, ema_decay=0.9995)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, _ = step(state, batch, seed=0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"ms_per_step": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True, help="checkout whose minimagen_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--kernels", help="comma-separated kernel names to time alone (no steps)")
    p.add_argument("--forms", action="store_true",
                   help="only GroupNorm's two forms at FORM_SHAPES (this tree's package)")
    p.add_argument("--train-default", type=int, metavar="STEPS",
                   help="only STEPS train steps of the default cascade: ms and peak memory")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from minimagen_tpu_torch.ops import kernels

    kernels.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.forms:
        print(json.dumps({"card": torch.cuda.get_device_name(0), "root": args.root,
                          "group_norm_forms_device_ms": form_times(gen)}), flush=True)
        return 0
    if args.train_default:
        print(json.dumps({"card": torch.cuda.get_device_name(0), "root": args.root,
                          "default_train": train_default(args.train_default)}), flush=True)
        return 0
    only = set(args.kernels.split(",")) if args.kernels else None
    times, device, by_kernel = {}, {}, {}
    rows = [(k, s, None, f"{k} {s}") for k, s in SHAPES] \
        + [(k, s, torch.float32, f"{k} {s} float32") for k, s in F32_SHAPES]
    for k, s, dtype, key in rows:
        if only is not None and k not in only:
            continue
        fn = launcher(k, s, gen, dtype)
        times[key] = median_ms(fn, args.reps)
        device[key] = device_ms(fn, max(1, args.reps // 5))
        if dtype is not None:
            by_kernel[key] = traced_kernel_ms(fn, 5)
    steps, families = {}, {}
    if only is None:
        for i in (0, 1):
            steps[f"lite stage {i} host ms/step"], families[f"lite stage {i}"] = \
                step_ms(i, max(1, args.reps // 10))
        families["lite train step"] = train_family_ms()
        for i in (0, 1):
            steps[f"lite stage {i} float32 host ms/step"], families[f"lite stage {i} float32"] = \
                step_ms(i, max(1, args.reps // 10), dtype=torch.float32)
        steps["lite train step float32 host ms/step"], families["lite train step float32"] = \
            train_f32_ms(max(1, args.reps // 10))
    print(json.dumps({"card": torch.cuda.get_device_name(0), "root": args.root,
                      "package": os.path.dirname(kernels.__file__), "median_ms": times,
                      "device_ms": device, "device_ms_by_kernel": by_kernel, "steps": steps,
                      "family_device_ms_per_step": families}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
