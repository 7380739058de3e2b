#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minimagen_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each with elapsed seconds; any failure exits non-zero:

1. build: compile csrc/*.cu with one nvcc call (ops/kernels.py).
2. load: ``load_lite(device="cuda")`` from assets/lite_ckpt and assets/t5_tiny.
3. kernels: every kernel against its plain PyTorch version at every shape the
   main path gives it (recorded from one guided forward of each U-Net), in
   bfloat16 and float32, with the limit beside each max-abs difference, and
   the kernel's, the plain version's and one PyTorch call's median times.
4. reference: one guided forward per U-Net on the card in float32 (kernels)
   against the port on the CPU in float32 (plain versions).
5-7. the main path, with the launch counts reset just before it: the base
   stage (DDIM-50, cond_scale 3.0, the 8 eval captions of
   assets/lite_ckpt/eval/metrics.json), the cascade truncated at 0.2, and the
   full-reverse cascade. Colour distances are held to 0.06 (committed rows:
   base 0.0245, truncated 0.0189).
8. a measurement, not a check: the host time of 5 guided DDIM steps per
   stage, and a torch.profiler trace of them for the device's busy time and
   its largest kernels.
9. record the training step's kernel shapes: one step of both stages at
   batch 16 with hooks on the modules that call the kernels.
10. backward kernels against their plain versions at those shapes, in
   bfloat16 and float32 (the biased multi-head forward and backward with a
   bias from a mask dropping about a quarter of the keys), with the same
   limits and times as phase 3 and, for attention, autograd through
   ``F.scaled_dot_product_attention`` as the yardstick.
11. reference train step: the committed weights as float32 master
   parameters, one step at batch 2 with injected draws, on the card
   (kernels) and on the CPU (plain versions), TF32 off: losses within 1e-4
   relative, each U-Net's gradient within 1e-3 relative L2, the updated
   parameters and EMA within 1e-4; and on each device the EMA within 2
   float32 ulps of ``ema0 * d + p * (1 - d)`` taken in float64 from that
   device's own updated parameters (a wrong decay or a skipped update is
   tens of ulps off, where card against CPU the EMA moves only ~1e-6).
12. learn, with the launch counts reset just before it: ``train_lite`` from
   a fresh init (seed 0), float32 master parameters, bf16 compute, 400
   steps; the mean loss of each stage over steps 201-400 must stay within
   1.5x the committed run's (base 0.25, SR 1.10) and below its own mean
   over steps 1-200, every loss finite, every backward kernel launched.
13. a measurement, not a check: host ms per training step and a
   torch.profiler trace of 5 steps.

The reference's default cascade (``generate.default_imagen``: Base at 64px,
Super at 128px, t5_base through the hash encoder, 2.33B parameters, fresh
seeded init, float32 master parameters, bf16 compute), after the lite
objects are freed:

14. record its kernel shapes: one guided forward per stage at 8 rows and one
   forward and backward of both stage losses at batch 2, with the hooks.
15. every forward and backward kernel against its plain version at those
   shapes (GroupNorm at 128-3584 channels, depth-to-space + bias bit-equal),
   attention forward and backward at batch * heads = 65544, and the whole
   stem alone at each stem shape of both cascades in three formulations
   (reference convs, s2d-4 + kernel 8, s2d-2 + kernel 8), a measurement.
16. reference: Base at 16px and Super at 32px (over a 16px low-res image),
   full width and depth, one caption guided, float32 on the card against a
   CPU copy of the same weights.
17. serve, with the launch counts reset just before it: 4 eval captions,
   cond_scale 3.0, DDIM-50 through both stages; images finite in [0, 1],
   every forward kernel launched, peak memory; then the per-step profile of
   each stage.
18. train, with the launch counts reset just before it: 3 steps of both
   stages at batch 2 (train.py's default) with make_train_step: losses
   finite, parameters moved, the EMA within 2 float32 ulps of its
   definition, every backward kernel launched, peak memory.

The lite sampling profile (phase 8) also times the stem alone (a
record_function range around it, and a trace of the SR stem by itself).

Then it prints the kernels' JSON line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. It exits non-zero without a result when no CUDA card is present or the
package is missing.
"""
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

COLOR_LIMIT = 0.06
REFERENCE_LIMIT = 1e-3  # relative L2, float32 on the card vs float32 on the CPU
# reference train step, card vs CPU in float32: relative loss, relative L2
# of each U-Net's gradient, relative L2 of the updated parameters and EMA;
# and the EMA against its own definition, in float32 ulps (one rounding of
# ema0 * d, one of the sum: 1.5 ulps at most)
TRAIN_LOSS_LIMIT, TRAIN_GRAD_LIMIT, TRAIN_PARAM_LIMIT = 1e-4, 1e-3, 1e-4
EMA_ULP_LIMIT = 2.0
EMA_DECAY = 0.9995
LEARN_STEPS = 400
TRAIN_BATCH = 16
# the committed lite run's mean losses (base, SR) over steps 1-200 and
# 201-400 (examples/lite_r5/history.json), and the learning limits, 1.5x the
# latter
COMMITTED_LOSSES = ((0.6443, 1.1758), (0.1639, 0.7355))
LEARN_LIMITS = (0.25, 1.10)
SAMPLE_STEPS = 50
COND_SCALE = 3.0
SEED = 0
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

KERNEL_INFO = {
    "mqa_forward": ("minimagen_tpu_torch/csrc/flash_attention.cu",
                    "minimagen_tpu/ops/flash_attention.py:92"),
    "mha_forward": ("minimagen_tpu_torch/csrc/flash_attention.cu",
                    "minimagen_tpu/ops/flash_attention.py:97"),
    "group_norm_forward": ("minimagen_tpu_torch/csrc/group_norm.cu",
                           "minimagen_tpu/ops/group_norm.py:89"),
    "depth_to_space_bias": ("minimagen_tpu_torch/csrc/depth_to_space.cu",
                            "minimagen_tpu/ops/stem_conv.py:146"),
}
BACKWARD_INFO = {
    "mqa_backward": ("minimagen_tpu_torch/csrc/flash_attention.cu",
                     "minimagen_tpu/ops/flash_attention.py:174"),
    "mha_backward": ("minimagen_tpu_torch/csrc/flash_attention.cu",
                     "minimagen_tpu/ops/flash_attention.py:394"),
    "group_norm_backward": ("minimagen_tpu_torch/csrc/group_norm.cu",
                            "minimagen_tpu/ops/group_norm.py:156"),
}
REPLACES = {"mha_forward": "minimagen_tpu/ops/flash_attention.py:97 and :349"}
# the default cascade: captions served, training batch (train.py's
# --BATCH_SIZE) and steps, and its caption length (--MAX_NUM_WORDS)
DEFAULT_CAPTIONS = 4
DEFAULT_TRAIN_BATCH = 2
DEFAULT_TRAIN_STEPS = 3
DEFAULT_MAX_WORDS = 64
# (b, h, w, cin, dim) of every stem input the hooks saw, for the formulation
# timings
STEM_SHAPES = set()


class PhaseError(RuntimeError):
    pass


LOG_PATH = os.path.join(REPO, "build", "chip_smoke.log")  # the whole log (gitignored)
_log_file = None


def log(msg):
    print(msg, flush=True)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


def device_kernel_times(prof):
    """(name, device us) of every kernel in a torch.profiler trace; user
    annotations (e.g. Optimizer.step) are ranges over kernels, not kernels."""
    return [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]


def traced(fn, ranges=()):
    """Run fn() under a torch.profiler trace of the card; returns the trace's
    (name, device us) kernel items and {name: device us of the kernels
    inside that record_function range} for each name of `ranges`; both
    empty (zeros) when the profiler itself cannot start or stop (no CUPTI on
    the machine). An error raised by fn() is never caught."""
    from torch.profiler import ProfilerActivity, profile

    items, spans = [], {name: 0.0 for name in ranges}
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except (RuntimeError, AttributeError) as e:
        log(f"  the profiler did not start ({type(e).__name__}: {e}): device time not measured")
        fn()
        return items, spans
    try:
        fn()
    except BaseException:
        prof.stop()
        raise
    try:
        prof.stop()
        items = device_kernel_times(prof)
        for e in prof.key_averages():
            if e.key in spans and e.device_type.name == "CPU":
                spans[e.key] = max(spans[e.key], e.device_time_total)
    except (RuntimeError, AttributeError) as e:
        log(f"  the profiler did not stop ({type(e).__name__}: {e}): device time not measured")
    return items, spans


def stem_ranges(imagen):
    """A record_function range named "stem" around every U-Net's stem
    (forward pre- and post-hooks); returns the hook handles."""
    from torch.profiler import record_function

    handles, open_ranges = [], []

    def enter(mod, args):
        rf = record_function("stem")
        rf.__enter__()
        open_ranges.append(rf)

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for unet in imagen.unets:
        handles += [unet.init_conv.register_forward_pre_hook(enter),
                    unet.init_conv.register_forward_hook(leave)]
    return handles


def device_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def ptxas_summary(build_log):
    """One line per compiled kernel: its name, template type, registers,
    spills and shared memory, from ptxas's -v report."""
    import re

    out, name, spill = [], "?", ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = mangled  # the length-prefixed identifier that ends in "kernel"
            for k in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
                ident = k.group(2)[:int(k.group(1))]
                if ident.endswith("kernel") and len(ident) == int(k.group(1)):
                    name = ident
                    break
            kind = "bf16" if "bfloat16" in mangled or "bf16" in mangled else "f32"
            name, spill = f"{name} [{kind}]", ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def median_ms(fn, reps=10, warmup=2):
    """Median of per-call CUDA-event times, after warm-up."""
    import torch

    for _ in range(warmup):
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


# --------------------------------------------------------------------------- #
# the main path's kernel shapes                                               #
# --------------------------------------------------------------------------- #
def hook_kernel_shapes(imagen):
    """Forward pre-hooks on the modules of every U-Net that call the
    forward kernels. Returns (per-stage {kernel: Counter(shape)}, hook
    handles): attention shapes (b, h, n, j), GroupNorm (b, h, w, c,
    groups, with scale-shift), depth-to-space + bias (b, H', W', f*f*c, f).
    Stem inputs are also added to STEM_SHAPES."""
    import collections

    from minimagen_tpu_torch.models import layers

    per_stage = [{k: collections.Counter() for k in KERNEL_INFO} for _ in imagen.unets]
    handles = []
    for unet, counts in zip(imagen.unets, per_stage):
        def on_gn(mod, args, kwargs, counts=counts):
            shape = (*args[0].shape, mod.groups, kwargs.get("scale_shift") is not None)
            counts["group_norm_forward"][shape] += 1

        def on_attn(mod, args, kwargs, counts=counts):
            b, n, _ = args[0].shape
            counts["mqa_forward"][(b, mod.heads, n, n + 1)] += 1

        def on_cross(mod, args, kwargs, counts=counts):
            b, n, _ = args[0].shape
            ctx = kwargs["context"] if "context" in kwargs else args[1]
            counts["mha_forward"][(b, mod.heads, n, ctx.shape[1] + 1)] += 1

        def on_stem(mod, args, kwargs, counts=counts):
            b, h, w, cin = args[0].shape
            dim = sum(getattr(mod, f"conv_{i}").out_channels for i in range(mod.num_convs))
            STEM_SHAPES.add((b, h, w, cin, dim))
            if mod.stride == 1 and h % 4 == 0 and w % 4 == 0:  # the s2d-4 forward
                counts["depth_to_space_bias"][(b, h // 4, w // 4, 16 * dim, 4)] += 1

        table = {layers.GroupNorm: on_gn, layers.Attention: on_attn,
                 layers.CrossAttention: on_cross, layers.CrossEmbedLayer: on_stem}
        for mod in unet.modules():
            if type(mod) in table:
                handles.append(mod.register_forward_pre_hook(table[type(mod)], with_kwargs=True))
    return per_stage, handles


def record_path_shapes(imagen, embeds, masks):
    """One guided forward per U-Net with the shape hooks. Returns, per
    stage, {kernel: Counter(shape)}: the launches of one sampling step, by
    shape."""
    import torch

    per_stage, handles = hook_kernel_shapes(imagen)
    try:
        b = embeds.shape[0]
        dev = embeds.device
        with torch.inference_mode():
            for stage, size in enumerate(imagen.image_sizes):
                kw = dict(text_embeds=embeds, text_mask=masks, lowres_cond_img=None,
                          lowres_noise_times=None, cond_scale=COND_SCALE)
                if stage > 0:
                    kw["lowres_cond_img"] = torch.zeros(b, size, size, 3, device=dev)
                    kw["lowres_noise_times"] = torch.full((b,), 200, device=dev)
                imagen._cfg_forward(stage, torch.zeros(b, size, size, 3, device=dev),
                                    torch.full((b,), 500, device=dev), **kw)
    finally:
        for h in handles:
            h.remove()
    return per_stage


def per_step_kernel_ms(per_stage, rows):
    """Per stage and kernel: launches per sampling step and the sum of their
    bf16 median times (kernel and plain version) at the path's shapes."""
    times = {(r["kernel"], tuple(r["shape"])): r for r in rows if r["dtype"] == "bfloat16"}
    out = []
    for counts in per_stage:
        out.append({name: dict(
            launches=sum(c.values()),
            kernel_ms=sum(n * times[(name, s)]["ms"] for s, n in c.items()),
            plain_ms=sum(n * times[(name, s)]["plain_ms"] for s, n in c.items()))
            for name, c in counts.items()})
    return out


# --------------------------------------------------------------------------- #
# kernel checks                                                               #
# --------------------------------------------------------------------------- #
def _limit(dtype_name, ref):
    """bfloat16: two roundings of the largest output (2^-6 relative);
    float32: 2e-5 relative (summation order and expf)."""
    scale = max(1.0, float(ref.abs().max()))
    return (2.0 ** -6 if dtype_name == "bfloat16" else 2e-5) * scale


def check_attention(kind, shape, dtype, gen):
    import torch
    import torch.nn.functional as F
    from minimagen_tpu_torch.ops import flash_attention as fa

    b, h, n, j = shape
    d = 64
    kv_shape = (b, j, d) if kind == "mqa" else (b, h, j, d)
    q = (torch.randn(b, h, n, d, generator=gen, device=DEVICE) * d ** -0.5).to(dtype)
    k = torch.randn(kv_shape, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(kv_shape, generator=gen, device=DEVICE).to(dtype)
    kernel, plain = (fa.mqa_flash, fa.mqa_plain) if kind == "mqa" else (fa.mha_flash, fa.mha_plain)
    out, ref = kernel(q, k, v), plain(q, k, v)
    sync()
    err = float((out.float() - ref.float()).abs().max())
    row = dict(kernel=f"{kind}_forward", shape=list(shape), dtype=str(dtype).split(".")[-1],
               max_abs_err=err, limit=_limit(str(dtype).split(".")[-1], ref.float()))
    kx, vx = (k[:, None].expand(b, h, j, d), v[:, None].expand(b, h, j, d)) if kind == "mqa" else (k, v)
    row["ms"] = median_ms(lambda: kernel(q, k, v))
    row["plain_ms"] = median_ms(lambda: plain(q, k, v))
    row["library_ms"] = median_ms(lambda: F.scaled_dot_product_attention(q, kx, vx, scale=1.0))
    itemsize = q.element_size()
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * itemsize
    ops = 4 * b * h * n * j * d
    row.update(_bound(nbytes, ops, row["dtype"]))
    return row


def check_group_norm(shape, dtype, gen):
    import torch
    from minimagen_tpu_torch.ops import group_norm as gn

    b, h, w, c, g, with_ss = shape
    x = (torch.randn(b, h, w, c, generator=gen, device=DEVICE) * 2.0 + 0.3).to(dtype)
    gamma = (1.0 + 0.2 * torch.randn(c, generator=gen, device=DEVICE)).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen, device=DEVICE)).to(dtype)
    ss = None
    if with_ss:
        ss = tuple((0.3 * torch.randn(b, 1, 1, c, generator=gen, device=DEVICE)).to(dtype)
                   for _ in range(2))
    kw = dict(groups=g, scale_shift=ss, silu=True)
    out = gn.group_norm_silu(x, gamma, beta, **kw)
    ref = gn.group_norm_silu_plain(x, gamma, beta, **kw)
    sync()
    name = str(dtype).split(".")[-1]
    err = float((out.float() - ref.float()).abs().max())
    row = dict(kernel="group_norm_forward", shape=list(shape), dtype=name, max_abs_err=err,
               limit=_limit(name, ref.float()))
    row["ms"] = median_ms(lambda: gn.group_norm_silu(x, gamma, beta, **kw))
    row["plain_ms"] = median_ms(lambda: gn.group_norm_silu_plain(x, gamma, beta, **kw))
    row["library_ms"] = None  # no single PyTorch call fuses norm, scale-shift and SiLU
    nbytes = (2 * x.numel() + 2 * c + (2 * b * c if with_ss else 0)) * x.element_size()
    # ~12 float32 operations per element on the CUDA cores, whatever the input type
    row.update(_bound(nbytes, 12 * x.numel(), "float32"))
    return row


def check_depth_to_space(shape, dtype, gen):
    """Kernel 8 against its plain version: the same bits (limit 0)."""
    import torch
    from minimagen_tpu_torch.ops import stem_conv as sc

    b, h, w, cf, f = shape
    y2 = torch.randn(b, h, w, cf, generator=gen, device=DEVICE).to(dtype)
    bias = torch.randn(cf // (f * f), generator=gen, device=DEVICE).to(dtype)
    out = sc.depth_to_space_bias(y2, bias, f)
    ref = sc.depth_to_space_bias_plain(y2, bias, f)
    sync()
    name = str(dtype).split(".")[-1]
    err = float((out.float() - ref.float()).abs().max())
    row = dict(kernel="depth_to_space_bias", shape=list(shape), dtype=name,
               max_abs_err=err if torch.equal(out, ref) or err > 0 else float("nan"), limit=0.0)
    row["ms"] = median_ms(lambda: sc.depth_to_space_bias(y2, bias, f))
    row["plain_ms"] = median_ms(lambda: sc.depth_to_space_bias_plain(y2, bias, f))
    row["library_ms"] = None  # pixel_shuffle orders channels (c, py, px) and adds no bias
    # read y2 and the bias, write the output; one float32 add per element
    row.update(_bound((2 * y2.numel() + bias.numel()) * y2.element_size(), y2.numel(), "float32"))
    return row


def _bound(nbytes, ops, dtype_name):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS[dtype_name] * 1e3
    return dict(bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations")


def run_checks(per_stage, checks, seed, extra_mha_j=()):
    """Each checker of `checks` ({forward kernel whose recorded shapes it
    takes: checker}) at every shape of `per_stage`, in bfloat16 then
    float32; multi-head attention also at the context lengths
    `extra_mha_j`. Prints one line per shape, raises if any exceeds its
    limit."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shapes = {name: set() for name in checks}
    for counts in per_stage:
        for name, c in counts.items():
            if name in shapes:
                shapes[name].update(c)
    if "mha_forward" in shapes:
        for b, h, n, _ in list(shapes["mha_forward"]):
            shapes["mha_forward"].update((b, h, n, j) for j in extra_mha_j)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, check in checks.items():
            rows += [check(shape, dtype, gen) for shape in sorted(shapes[name])]
    return _report(rows)


FORWARD_CHECKS = {"mqa_forward": lambda *a: check_attention("mqa", *a),
                  "mha_forward": lambda *a: check_attention("mha", *a),
                  "group_norm_forward": check_group_norm,
                  "depth_to_space_bias": check_depth_to_space}


def kernel_checks(per_stage, extra_mha_j=(19, 21)):
    """The forward kernels, multi-head attention also at short text contexts
    (max_length 16)."""
    return run_checks(per_stage, FORWARD_CHECKS, SEED, extra_mha_j=extra_mha_j)


# --------------------------------------------------------------------------- #
# reference and main path                                                     #
# --------------------------------------------------------------------------- #
def reference_check(captions):
    """Guided forward of each U-Net: float32 on the card (kernels) vs float32
    on the CPU (plain versions), same weights and inputs."""
    import torch
    from minimagen_tpu_torch.generate import load_lite

    results = {}
    models = {dev: load_lite(device=dev, dtype=torch.float32) for dev in (DEVICE, "cpu")}
    embeds, masks = models["cpu"].encode_text(captions)
    gen = torch.Generator().manual_seed(SEED)
    b = len(captions)
    for stage, size in enumerate(models["cpu"].image_sizes):
        x = torch.randn(b, size, size, 3, generator=gen)
        low = torch.rand(b, size, size, 3, generator=gen) if stage else None
        outs = {}
        for dev, model in models.items():
            to = lambda t: None if t is None else t.to(dev)  # noqa: E731
            with torch.inference_mode():
                outs[dev] = model._cfg_forward(
                    stage, to(x), torch.full((b,), 500, device=dev), text_embeds=to(embeds),
                    text_mask=to(masks), lowres_cond_img=to(low),
                    lowres_noise_times=torch.full((b,), 200, device=dev) if stage else None,
                    cond_scale=COND_SCALE).cpu()
        rel = float((outs[DEVICE] - outs["cpu"]).norm() / outs["cpu"].norm())
        results[f"stage{stage}_rel_l2"] = rel
        log(f"  stage {stage}: relative L2 card f32 vs cpu f32 = {rel:.3e} (limit {REFERENCE_LIMIT})")
        if not rel <= REFERENCE_LIMIT:
            raise PhaseError(f"stage {stage} disagrees with the CPU reference")
    return results


def run_main_path(imagen, captions):
    """The three sampling runs; returns per-phase launch snapshots."""
    import numpy as np
    import torch
    from minimagen_tpu_torch.ops import kernels
    from minimagen_tpu_torch.quality import color_metric, grad_mean

    snapshots = {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def snap(name):
        snapshots[name] = dict(kernels.LAUNCHES)

    kernels.reset_launch_counts()
    with phase("base stage: DDIM-50, cond_scale 3.0, 8 captions"):
        embeds, masks = imagen.encode_text(captions)
        init = torch.randn(len(captions), 64, 64, 3, generator=gen, device=DEVICE)
        base = imagen.sample_stage(0, embeds, masks, COND_SCALE, init_noise=init,
                                   sampler="ddim", sample_steps=SAMPLE_STEPS)
        arr = base.float().cpu().numpy()
        cd, gm = color_metric(arr, captions), grad_mean(arr)
        log(f"  base color_dist {cd:.4f} (limit {COLOR_LIMIT}, committed 0.0245) grad_mean {gm:.4f}")
        if not (np.isfinite(arr).all() and cd <= COLOR_LIMIT):
            raise PhaseError("base stage color distance above the limit")
    snap("base")
    with phase("cascade truncated at 0.2"):
        out = imagen.sample(captions, cond_scale=COND_SCALE, sampler="ddim",
                            sample_steps=SAMPLE_STEPS, sr_start_noise_levels=0.2, generator=gen)
        arr = out.float().cpu().numpy()
        cd, gm = color_metric(arr, captions), grad_mean(arr)
        log(f"  trunc/sr0.2 color_dist {cd:.4f} (limit {COLOR_LIMIT}, committed 0.0189) "
            f"grad_mean {gm:.4f}")
        if not (np.isfinite(arr).all() and cd <= COLOR_LIMIT):
            raise PhaseError("truncated cascade color distance above the limit")
    snap("trunc")
    with phase("cascade full reverse"):
        out = imagen.sample(captions, cond_scale=COND_SCALE, sampler="ddim",
                            sample_steps=SAMPLE_STEPS, generator=gen)
        arr = out.float().cpu().numpy()
        cd, gm = color_metric(arr, captions), grad_mean(arr)
        log(f"  fullrev shape {arr.shape} finite {bool(np.isfinite(arr).all())} "
            f"color_dist {cd:.4f} (committed 0.6127) grad_mean {gm:.4f}")
        if arr.shape != (len(captions), 256, 256, 3) or not np.isfinite(arr).all():
            raise PhaseError("full-reverse cascade output is not finite (8, 256, 256, 3)")
    snap("fullrev")
    return snapshots


def profile_steps(imagen, captions, steps=5):
    """Time `steps` guided DDIM steps of each stage: host time per step
    without the profiler, then device busy time per step (sum of kernel
    times in a torch.profiler trace of the same steps), the kernels that
    take the most of it, and the device time inside the stem's range."""
    import torch

    embeds, masks = imagen.encode_text(captions)
    b = len(captions)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = []
    for stage, size in enumerate(imagen.image_sizes):
        kw = {}
        if stage > 0:
            kw = dict(lowres_cond_img=torch.rand(b, size, size, 3, generator=gen, device=DEVICE),
                      lowres_noise_times=torch.full((b,), 200, device=DEVICE))
        init = torch.randn(b, size, size, 3, generator=gen, device=DEVICE)

        def run():
            imagen.sample_stage(stage, embeds, masks, COND_SCALE, init_noise=init, sampler="ddim",
                                sample_steps=steps, **kw)
            torch.cuda.synchronize()

        run()  # warm-up
        t0 = time.perf_counter()
        run()  # host time, without the profiler's own overhead
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        handles = stem_ranges(imagen)
        try:
            kernels_us, spans = traced(run, ranges=("stem",))
        finally:
            for h in handles:
                h.remove()
        busy_ms = sum(us for _, us in kernels_us) / 1e3 / steps
        stem_ms = spans["stem"] / 1e3 / steps
        top = sorted(kernels_us, key=lambda kv: -kv[1])[:8]
        row = dict(stage=stage, wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
                   stem_ms_per_step=stem_ms,
                   top=[(name[:60], us / 1e3 / steps) for name, us in top])
        out.append(row)
        log(f"  stage {stage}: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
            f"({'not measured' if busy_ms == 0 else f'{100 * busy_ms / wall_ms:.0f}%'}), "
            f"stem (record_function range) {stem_ms:.3f} ms/step")
        for name, ms in row["top"]:
            log(f"    {ms:8.3f} ms/step  {name}")
    return out


# --------------------------------------------------------------------------- #
# training                                                                    #
# --------------------------------------------------------------------------- #
def record_train_shapes(imagen, state, step_fn, batch):
    """One training step with the shape hooks. Returns ({kernel:
    Counter(shape)} per stage for the forward kernels, the launches of that
    step by kernel name)."""
    from minimagen_tpu_torch.ops import kernels

    per_stage, handles = hook_kernel_shapes(imagen)
    kernels.reset_launch_counts()
    try:
        step_fn(state, batch, seed=SEED)
        sync()
    finally:
        for h in handles:
            h.remove()
    return per_stage, dict(kernels.LAUNCHES)


def train_step_shapes():
    """Kernel shapes and launches of one training step of a fresh lite
    cascade (float32 parameters, bf16 compute) at batch TRAIN_BATCH."""
    import torch
    from minimagen_tpu_torch.generate import lite_imagen
    from minimagen_tpu_torch.training import make_optimizer, create_train_state, make_train_step

    torch.manual_seed(SEED)
    imagen = lite_imagen(dtype=torch.bfloat16, param_dtype=torch.float32, device=DEVICE)
    opt = make_optimizer(1e-4)
    state = create_train_state(imagen, opt, ema=True)
    batch = {k: v.to(DEVICE) for k, v in _train_batch(TRAIN_BATCH).items()}
    return record_train_shapes(imagen, state, make_train_step(imagen, opt, 0.9995), batch)


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _worst(pairs, dtype_name):
    """(max_abs_err, limit) of the output whose error is the largest share
    of its limit, over (got, ref) pairs."""
    worst = (0.0, 1.0)
    for got, ref in pairs:
        err = float((got.float() - ref.float()).abs().max())
        lim = _limit(dtype_name, ref.float())
        if err / lim >= worst[0] / worst[1]:
            worst = (err, lim)
    return worst


def check_attention_backward(kind, shape, dtype, gen):
    """The backward kernel (and, for multi-head, the biased forward) against
    the plain versions; multi-head with a bias from a mask dropping ~1/4 of
    the keys. The yardstick is autograd through SDPA, graph built first."""
    import torch
    import torch.nn.functional as F
    from minimagen_tpu_torch.ops import attention as attn
    from minimagen_tpu_torch.ops import flash_attention as fa

    b, h, n, j = shape
    d = 64
    kv_shape = (b, j, d) if kind == "mqa" else (b, h, j, d)
    q = (torch.randn(b, h, n, d, generator=gen, device=DEVICE) * d ** -0.5).to(dtype)
    k = torch.randn(kv_shape, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(kv_shape, generator=gen, device=DEVICE).to(dtype)
    g = torch.randn(b, h, n, d, generator=gen, device=DEVICE).to(dtype)
    keep = None
    if kind == "mha":
        keep = torch.rand(b, j, generator=gen, device=DEVICE) >= 0.25
        keep[:, 0] = True
    bias = None if keep is None else attn.mask_bias(keep)
    plain, plain_bwd = fa._PLAIN[kind]
    name = str(dtype).split(".")[-1]
    out, lse = fa.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
    grads = fa.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)
    refs = plain_bwd(q, k, v, g, attn_bias=bias)
    fwd_ref = plain(q, k, v, attn_bias=bias)
    sync()
    err, lim = _worst([(out, fwd_ref), *zip(grads, refs)], name)
    row = dict(kernel=f"{kind}_backward", shape=list(shape), dtype=name, max_abs_err=err,
               limit=lim, bias=bias is not None)
    row["ms"] = median_ms(lambda: fa.attention_backward_kernel(kind, q, k, v, bias, out, g, lse))
    row["plain_ms"] = median_ms(lambda: plain_bwd(q, k, v, g, attn_bias=bias))
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    kx, vx = ((kk[:, None].expand(b, h, j, d), vv[:, None].expand(b, h, j, d)) if kind == "mqa"
              else (kk, vv))
    mask = None if keep is None else keep[:, None, None, :]
    ys = F.scaled_dot_product_attention(qq, kx, vx, attn_mask=mask, scale=1.0)
    row["library_ms"] = median_ms(
        lambda: torch.autograd.grad(ys, (qq, kk, vv), g, retain_graph=True))
    if bias is not None:  # the biased forward (with the log-sum-exp) and its yardstick
        row["fwd_ms"] = median_ms(
            lambda: fa.attention_forward_kernel(kind, q, k, v, bias, with_lse=True))
        row["fwd_plain_ms"] = median_ms(lambda: plain(q, k, v, attn_bias=bias))
        row["fwd_library_ms"] = median_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0))
        fwd_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + 4 * (b * h * n + b * j)
        row["fwd_bound_ms"] = _bound(fwd_bytes, 4 * b * h * n * j * d, name)["bound_ms"]
    itemsize = q.element_size()
    # read q, k, v, o, do (and lse, bias); write dq, dk, dv
    nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * itemsize + 4 * b * h * n \
        + (0 if bias is None else 4 * b * j)
    row.update(_bound(nbytes, 10 * b * h * n * j * d, name))
    return row


def check_group_norm_backward(shape, dtype, gen):
    import torch
    from minimagen_tpu_torch.ops import group_norm as gn

    b, h, w, c, groups, with_ss = shape
    x = (torch.randn(b, h, w, c, generator=gen, device=DEVICE) * 2.0 + 0.3).to(dtype)
    gamma = (1.0 + 0.2 * torch.randn(c, generator=gen, device=DEVICE)).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen, device=DEVICE)).to(dtype)
    scale = shift = None
    if with_ss:
        scale, shift = ((0.3 * torch.randn(b, 1, 1, c, generator=gen, device=DEVICE)).to(dtype)
                        for _ in range(2))
    g = torch.randn(b, h, w, c, generator=gen, device=DEVICE).to(dtype)
    kw = dict(groups=groups, silu=True)
    _, mean, rstd = gn.group_norm_forward_kernel(x, gamma, beta, scale, shift, eps=1e-5, **kw)
    got = gn.group_norm_backward_kernel(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    ref = gn.group_norm_silu_bwd_plain(x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    sync()
    name = str(dtype).split(".")[-1]
    err, lim = _worst([(a, r) for a, r in zip(got, ref) if r is not None], name)
    row = dict(kernel="group_norm_backward", shape=list(shape), dtype=name, max_abs_err=err,
               limit=lim)
    row["ms"] = median_ms(lambda: gn.group_norm_backward_kernel(
        x, gamma, beta, scale, shift, mean, rstd, g, **kw))
    row["plain_ms"] = median_ms(lambda: gn.group_norm_silu_bwd_plain(
        x, gamma, beta, scale, shift, mean, rstd, g, **kw))
    row["library_ms"] = None  # no single PyTorch call computes this backward
    # read x and dy, write dx; ~20 float32 operations per element
    row.update(_bound(3 * x.numel() * x.element_size(), 20 * x.numel(), "float32"))
    return row


def backward_checks(per_stage):
    return run_checks(per_stage, {"mqa_forward": lambda *a: check_attention_backward("mqa", *a),
                                  "mha_forward": lambda *a: check_attention_backward("mha", *a),
                                  "group_norm_forward": check_group_norm_backward}, SEED + 1)


def _report(rows):
    bad = []
    for r in rows:
        ok = r["max_abs_err"] <= r["limit"]
        lib = r["library_ms"]
        log(f"  {r['kernel']:<19} {r['dtype']:<8} {str(tuple(r['shape'])):<28}"
            f"{' +bias' if r.get('bias') else ''} "
            f"max_abs_err {r['max_abs_err']:.3e} (limit {r['limit']:.3e}) "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"library {lib if lib is None else round(lib, 4)} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) {'ok' if ok else 'FAIL'}"
            + (f"; biased forward {r['fwd_ms']:.4f} ms plain {r['fwd_plain_ms']:.4f} ms "
               f"library {r['fwd_library_ms']:.4f} ms bound {r['fwd_bound_ms']:.4f} ms"
               if "fwd_ms" in r else ""))
        if not ok:
            bad.append(r)
    if bad:
        raise PhaseError(f"{len(bad)} kernel checks exceed their limit")
    return rows


def _train_batch(n, size=256):
    """n items of the synthetic set (the lite run's training combos) as a
    batch on the CPU."""
    from minimagen_tpu_torch.training import stage_batches

    held = {0, 10, 13}
    batches = stage_batches(n, n, size, 16, "t5_tiny", combos=[i for i in range(18) if i not in held],
                            device="cpu")
    return {k: v[0] for k, v in batches.items()}


def ema_ulps(ema0s, params, emas, decay):
    """Largest distance, in float32 ulps, of each updated EMA tensor from
    ema0 * d + params * (1 - d) computed in float64, with d and 1 - d rounded
    to float32 as make_train_step uses them; tensor by tensor on the EMA's
    device (ema0 may lie elsewhere), the ulp that of the larger of |ema0|
    and |ema|."""
    import numpy as np
    import torch

    d = np.float32(decay)
    d_hi, d_lo = float(d), float(np.float32(1) - d)
    worst = 0.0
    with torch.no_grad():
        for e0, p, e in zip(ema0s, params, emas):
            e0 = e0.to(e.device)
            want = e0.double() * d_hi + p.detach().double() * d_lo
            m = torch.maximum(e0.abs(), e.abs()).float()
            ulp = (torch.nextafter(m, torch.full_like(m, float("inf"))) - m).double()
            worst = max(worst, float(((e.double() - want).abs() / ulp).max()))
    return worst


def reference_train_step():
    """One train step of the committed weights as float32 master parameters
    at batch 2 with injected draws, on the card (kernels) and on the CPU
    (plain versions)."""
    import torch
    from minimagen_tpu_torch.generate import load_lite
    from minimagen_tpu_torch.training import make_optimizer, create_train_state, make_train_step

    batch = _train_batch(2)
    gen = torch.Generator().manual_seed(SEED)
    draws = []
    for stage, size in enumerate((64, 256)):
        d = dict(times=torch.tensor([120, 730]),
                 noise=torch.randn(2, size, size, 3, generator=gen),
                 keep_mask=torch.tensor([True, False]))
        if stage:
            d.update(lowres_aug_times=torch.tensor([310, 310]),
                     lowres_noise=torch.randn(2, size, size, 3, generator=gen))
        draws.append(d)
    results = {}
    for dev in (DEVICE, "cpu"):
        imagen = load_lite(device=dev, dtype=torch.float32, param_dtype=torch.float32)
        opt = make_optimizer(1e-4)
        state = create_train_state(imagen, opt, ema=True)
        step = make_train_step(imagen, opt, ema_decay=EMA_DECAY)
        ema0 = torch.cat([e.reshape(-1).cpu() for e in state.ema_params])
        to = lambda dd: {k: v.to(dev) for k, v in dd.items()}  # noqa: E731
        state, losses = step(state, to(batch), draws=[to(d) for d in draws])
        per_unet = []
        for unet in imagen.unets:
            ps = list(unet.parameters())
            per_unet.append([torch.cat([t.detach().float().reshape(-1).cpu() for t in ts])
                             for ts in ([p.grad for p in ps], ps)])
        ema = torch.cat([e.reshape(-1).cpu() for e in state.ema_params])
        params = torch.cat([p for _, p in per_unet])
        results[dev] = (losses.cpu(), per_unet, ema, ema_ulps([ema0], [params], [ema], EMA_DECAY))
        del imagen, state
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    (lc, uc, ec, ulc), (lr_, ur, er, ulr) = results[DEVICE], results["cpu"]
    checks = [("loss", float(((lc - lr_).abs() / lr_.abs()).max()), TRAIN_LOSS_LIMIT)]
    for i, ((gc, pc), (gr, pr)) in enumerate(zip(uc, ur)):
        checks += [(f"unet_{i} gradient", rel(gc, gr), TRAIN_GRAD_LIMIT),
                   (f"unet_{i} parameters", rel(pc, pr), TRAIN_PARAM_LIMIT)]
    checks += [("EMA", rel(ec, er), TRAIN_PARAM_LIMIT),
               ("EMA vs its definition, card (ulps)", ulc, EMA_ULP_LIMIT),
               ("EMA vs its definition, cpu (ulps)", ulr, EMA_ULP_LIMIT)]
    log(f"  losses card {lc.tolist()} cpu {lr_.tolist()}")
    for name, val, lim in checks:
        log(f"  {name}: {val:.3e} (limit {lim}) {'ok' if val <= lim else 'FAIL'}")
    if any(val > lim for _, val, lim in checks):
        raise PhaseError("the card's train step disagrees with the CPU reference")
    return {name: val for name, val, _ in checks}


def learn():
    """train_lite for LEARN_STEPS steps with the launch counts reset just
    before; checks the learning curve against the committed run."""
    import numpy as np
    from minimagen_tpu_torch.ops import kernels
    from minimagen_tpu_torch.training import train_lite, window_means

    kernels.reset_launch_counts()
    run = train_lite(LEARN_STEPS, TRAIN_BATCH, device=DEVICE)
    launches = dict(kernels.LAUNCHES)
    losses = run.losses
    first, second = np.array(window_means(losses[:400]))
    for stage, name in enumerate(("base", "SR")):
        log(f"  {name}: mean loss steps 1-200 {first[stage]:.4f} (committed "
            f"{COMMITTED_LOSSES[0][stage]}), steps 201-400 {second[stage]:.4f} (committed "
            f"{COMMITTED_LOSSES[1][stage]}, limit {LEARN_LIMITS[stage]})")
    log(f"  host {run.host_ms_per_step:.1f} ms/step (synchronized), launches per step: "
        + ", ".join(f"{k} {v / LEARN_STEPS:g}" for k, v in launches.items()))
    failures = []
    if not np.isfinite(losses).all():
        failures.append("a loss is not finite")
    for stage in range(2):
        if not second[stage] <= LEARN_LIMITS[stage]:
            failures.append(f"stage {stage} mean over 201-400 above {LEARN_LIMITS[stage]}")
        if not second[stage] < first[stage]:
            failures.append(f"stage {stage} did not improve from 1-200 to 201-400")
    missing = [k for k in [*BACKWARD_INFO, "depth_to_space_bias"] if launches[k] == 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    if failures:
        raise PhaseError("; ".join(failures))
    return run, launches, dict(first=first.tolist(), second=second.tolist(),
                               ms_per_step=run.host_ms_per_step)


def profile_train(run, steps=5):
    """Host ms per training step (synchronized) and a torch.profiler trace
    of `steps` steps: device busy ms per step and the largest items."""
    n_batches = run.batches["image"].shape[0]

    def go():
        for _ in range(steps):
            k = run.state.step % n_batches
            run.step_fn(run.state, {name: v[k] for name, v in run.batches.items()}, seed=SEED)
        sync()

    go()  # warm-up
    t0 = time.perf_counter()
    go()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    items, _ = traced(go)
    busy_ms = sum(us for _, us in items) / 1e3 / steps
    log(f"  train step: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
        f"({'not measured' if busy_ms == 0 else f'{100 * busy_ms / wall_ms:.0f}%'})")
    for name, us in sorted(items, key=lambda kv: -kv[1])[:10]:
        log(f"    {us / 1e3 / steps:8.3f} ms/step  {name[:70]}")
    return dict(wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms)


# --------------------------------------------------------------------------- #
# the stem                                                                    #
# --------------------------------------------------------------------------- #
# (b, h, w, cin, dim) of the stems the sampling paths run: lite base 64px and
# SR 256px at 16 guided rows, Base 64px and Super 128px at 8
STEM_PATH_SHAPES = {"lite base": (16, 64, 64, 3, 64), "lite SR": (16, 256, 256, 6, 32),
                    "Base": (8, 64, 64, 3, 512), "Super": (8, 128, 128, 6, 128)}


def _stem_inputs(shape, gen):
    """A bf16 input and float32 kernels/biases of a 3/7/15 stem of `dim`
    channels split as CrossEmbedLayer splits them."""
    import torch

    b, h, w, cin, dim = shape
    dims = [dim // 2, dim // 4, dim - dim // 2 - dim // 4]
    x = torch.randn(b, h, w, cin, generator=gen, device=DEVICE).to(torch.bfloat16)
    ws = [torch.randn(d, cin, k, k, generator=gen, device=DEVICE) / (k * cin ** 0.5)
          for k, d in zip((3, 7, 15), dims)]
    bs = [torch.randn(d, generator=gen, device=DEVICE) for d in dims]
    return x, ws, bs


def time_stem_formulations():
    """The stem alone, forward in bf16, at each sampling path's stem shape:
    the reference convs, s2d-4 + kernel 8 (the path's) and s2d-2 + kernel 8;
    each formulation within 2^-6 of the reference's largest output. A
    measurement beside a check."""
    import torch
    from minimagen_tpu_torch.ops import stem_conv as sc

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    rows = []
    for name, shape in STEM_PATH_SHAPES.items():
        x, ws, bs = _stem_inputs(shape, gen)
        forms = {"reference": lambda: sc.cross_embed_reference(x, ws, bs, 1),
                 "s2d-4": lambda: sc.cross_embed_s2d_conv(x, ws, bs, 4),
                 "s2d-2": lambda: sc.cross_embed_s2d_conv(x, ws, bs, 2)}
        with torch.no_grad():
            ref = forms["reference"]().float()
            errs = {k: float((f().float() - ref).abs().max()) for k, f in forms.items()}
            ms = {k: median_ms(f) for k, f in forms.items()}
        sync()
        lim = _limit("bfloat16", ref)
        row = dict(stem=name, shape=list(shape), on_path=shape in STEM_SHAPES, ms=ms,
                   max_abs_err=errs, limit=lim)
        rows.append(row)
        log(f"  stem {name} {shape} (on a path: {row['on_path']}): "
            + ", ".join(f"{k} {ms[k]:.4f} ms (err {errs[k]:.2e})" for k in forms)
            + f"; limit {lim:.2e}")
        if any(e > lim for e in errs.values()):
            raise PhaseError(f"stem formulations disagree at {name}")
    return rows


def stem_kernels(shape, calls=5):
    """The kernels of the stem by itself (the path's dispatch, bf16, no
    gradient) at `shape`, from a trace of `calls` calls: (name, ms per call)."""
    import torch
    from minimagen_tpu_torch.ops import stem_conv as sc

    x, ws, bs = _stem_inputs(shape, torch.Generator(device=DEVICE).manual_seed(SEED + 3))

    def go():
        with torch.no_grad():
            for _ in range(calls):
                sc.cross_embed_conv(x, ws, bs, stride=1)
        sync()

    go()
    items = sorted(traced(go)[0], key=lambda kv: -kv[1])
    for name, us in items:
        log(f"    {us / 1e3 / calls:8.3f} ms/call  {name[:90]}")
    return [(name, us / 1e3 / calls) for name, us in items]


# --------------------------------------------------------------------------- #
# the default cascade                                                         #
# --------------------------------------------------------------------------- #
def default_train_batch():
    """train.py's default batch of the synthetic set at 128px, captions
    encoded by t5_base (the hash encoder) to at most 64 words."""
    from minimagen_tpu_torch.training import stage_batches

    batches = stage_batches(DEFAULT_TRAIN_BATCH, DEFAULT_TRAIN_BATCH, 128, DEFAULT_MAX_WORDS,
                            "t5_base", device=DEVICE)
    return {k: v[0] for k, v in batches.items()}


def default_path_shapes(imagen, captions, batch):
    """The kernel shapes of the default cascade's paths: one guided forward
    per stage (sampling) and one forward and backward of both stage losses
    at the training batch (gradients dropped after)."""
    import torch

    embeds, masks = imagen.encode_text(captions)
    sampling = record_path_shapes(imagen, embeds, masks)
    training, handles = hook_kernel_shapes(imagen)
    try:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        loss = sum(imagen.stage_loss(i, batch["image"], batch["encoding"], batch["mask"],
                                     generator=gen) for i in range(imagen.num_unets))
        loss.backward()
        sync()
    finally:
        for h in handles:
            h.remove()
        for p in imagen.unets.parameters():
            p.grad = None
    return sampling, training


def cpu_copy(imagen):
    """The imagen with float32 CPU copies of its U-Nets (built on the meta
    device, then given the card's weights), for _cfg_forward."""
    import copy

    import torch
    from minimagen_tpu_torch.models.unet import UnetModel

    unets = []
    for unet in imagen.unets:
        with torch.device("meta"):
            u = UnetModel(unet.config, torch.float32)
        u.load_state_dict({k: v.to("cpu", torch.float32) for k, v in unet.state_dict().items()},
                          assign=True)
        unets.append(u.eval())
    out = copy.copy(imagen)
    out.unets = torch.nn.ModuleList(unets)
    return out


def default_reference(captions):
    """Guided forward of Base at 16px and Super at 32px (over a 16px
    low-res image resized up), full width and depth, one caption (2 rows):
    float32 on the card (kernels) against a CPU copy of the same weights
    (plain versions), TF32 off."""
    import torch
    from minimagen_tpu_torch.generate import default_imagen
    from minimagen_tpu_torch.ops.resize import resize_image_to

    card = default_imagen(device=DEVICE, seed=SEED, dtype=torch.float32)
    models = {DEVICE: card, "cpu": cpu_copy(card)}
    embeds, masks = card.encode_text(captions)
    embeds, masks = embeds.cpu(), masks.cpu()
    gen = torch.Generator().manual_seed(SEED)
    b = len(captions)
    results = {}
    for stage, size in enumerate((16, 32)):
        x = torch.randn(b, size, size, 3, generator=gen)
        low = resize_image_to(torch.rand(b, 16, 16, 3, generator=gen), size) if stage else None
        outs = {}
        for dev, model in models.items():
            to = lambda t: None if t is None else t.to(dev)  # noqa: E731
            with torch.inference_mode():
                outs[dev] = model._cfg_forward(
                    stage, to(x), torch.full((b,), 500, device=dev), text_embeds=to(embeds),
                    text_mask=to(masks), lowres_cond_img=to(low),
                    lowres_noise_times=torch.full((b,), 200, device=dev) if stage else None,
                    cond_scale=COND_SCALE).cpu()
        rel = float((outs[DEVICE] - outs["cpu"]).norm() / outs["cpu"].norm())
        finite = bool(torch.isfinite(outs[DEVICE]).all())
        results[f"stage{stage}_rel_l2"] = rel
        log(f"  stage {stage} ({size}px): relative L2 card f32 vs cpu f32 = {rel:.3e} "
            f"(limit {REFERENCE_LIMIT}), finite {finite}")
        if not (finite and rel <= REFERENCE_LIMIT):
            raise PhaseError(f"default cascade stage {stage} disagrees with the CPU reference")
    return results


def serve(imagen, captions):
    """Guided DDIM-50 through both stages with the launch counts reset just
    before; returns the launches."""
    import numpy as np
    import torch
    from minimagen_tpu_torch.ops import kernels

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = imagen.sample(captions, cond_scale=COND_SCALE, sampler="ddim",
                        sample_steps=SAMPLE_STEPS, generator=gen)
    sync()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    arr = out.float().cpu().numpy()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  images {arr.shape} min {arr.min():.4f} max {arr.max():.4f} mean {arr.mean():.4f} "
        f"std {arr.std():.4f}; {seconds:.2f} s for {len(captions)} images "
        f"({seconds / len(captions):.3f} s/image, host clock, synchronized); "
        f"peak memory {peak:.2f} GiB")
    log(f"  launches: {launches}")
    failures = []
    if arr.shape != (len(captions), 128, 128, 3) or not np.isfinite(arr).all():
        failures.append(f"images {arr.shape} not finite ({len(captions)}, 128, 128, 3)")
    if not (arr.min() >= 0.0 and arr.max() <= 1.0):
        failures.append("images outside [0, 1]")
    missing = [k for k in KERNEL_INFO if launches[k] == 0]
    if missing:
        failures.append(f"forward kernels never launched: {missing}")
    if failures:
        raise PhaseError("; ".join(failures))
    return launches, dict(seconds=seconds, peak_gib=peak)


def train_default(imagen, batch, train_shapes):
    """DEFAULT_TRAIN_STEPS steps of both stages with make_train_step (clip-50
    Adam, EMA), the launch counts reset just before."""
    import numpy as np
    import torch
    from minimagen_tpu_torch.ops import kernels
    from minimagen_tpu_torch.training import create_train_state, make_optimizer, make_train_step

    opt = make_optimizer(1e-4)
    state = create_train_state(imagen, opt, ema=True)
    step = make_train_step(imagen, opt, ema_decay=EMA_DECAY)
    names = ("init_conv.conv_2.weight", "text_to_cond.weight", "final_conv.weight")
    watched = {(i, name): p.detach().clone() for i, unet in enumerate(imagen.unets)
               for name, p in unet.named_parameters() if name in names}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, ms = [], []
    for i in range(DEFAULT_TRAIN_STEPS):
        if i == DEFAULT_TRAIN_STEPS - 1:
            ema0 = [e.to("cpu", copy=True) for e in state.ema_params]
        t0 = time.perf_counter()
        state, step_losses = step(state, batch, seed=SEED)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(step_losses.float().cpu().numpy())
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ulps = ema_ulps(ema0, state.params, state.ema_params, EMA_DECAY)
    del ema0
    moved = {f"unet_{i}.{name}": not torch.equal(p0, imagen.unets[i].get_parameter(name).detach())
             for (i, name), p0 in watched.items()}
    widest = max(s[3] for counts in train_shapes for s in counts["group_norm_forward"])
    log(f"  losses per step (base, super): {[l.tolist() for l in losses]}")
    log(f"  host ms per step (synchronized): {[round(m, 1) for m in ms]}; peak memory "
        f"{peak:.2f} GiB")
    log(f"  EMA vs its definition: {ulps:.4f} ulps (limit {EMA_ULP_LIMIT}); parameters moved: "
        f"{moved}; widest GroupNorm in the step: {widest} channels")
    log(f"  launches: {launches}")
    failures = []
    if not np.isfinite(np.array(losses)).all():
        failures.append("a loss is not finite")
    if not all(moved.values()):
        failures.append("a watched parameter did not move")
    if not ulps <= EMA_ULP_LIMIT:
        failures.append(f"EMA {ulps} ulps from its definition")
    missing = [k for k in [*BACKWARD_INFO, "depth_to_space_bias"] if launches[k] == 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    if failures:
        raise PhaseError("; ".join(failures))
    return launches, dict(losses=[l.tolist() for l in losses], ms=ms, peak_gib=peak, ulps=ulps)


def kernel_entries(rows, launches):
    """One entry per kernel for the JSON line, at the heaviest bf16 shape
    checked (largest bound), with its launches summed over the runs of the
    paths (lite sampling and learning, default serving and training), each
    counted from 0."""
    entries = []
    for name, (source, replaces) in {**KERNEL_INFO, **BACKWARD_INFO}.items():
        bf16 = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"]
        top = max(bf16, key=lambda r: r["bound_ms"])
        entries.append(dict(name=name, route="cuda", source=source,
                            replaces=REPLACES.get(name, replaces), launches=launches[name],
                            max_abs_err=top["max_abs_err"], ms=top["ms"],
                            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                            bound_by=top["bound_by"], library_ms=top["library_ms"]))
        log(f"  {name}: numbers at {tuple(top['shape'])} bfloat16")
    return entries


class phase:
    """Context manager printing one line per phase with its elapsed seconds."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        log(f"[phase] {self.name} ...")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.time() - self.t0
        if exc_type is None:
            log(f"[phase] {self.name}: ok ({dt:.1f} s)")
            return False
        log(f"[phase] {self.name}: FAILED ({dt:.1f} s): {exc_type.__name__}: {exc}")
        if not isinstance(exc, PhaseError):
            traceback.print_exception(exc_type, exc, tb, file=sys.stdout)
        raise PhaseError(self.name) from exc


def main():
    global _log_file
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from minimagen_tpu_torch.generate import LITE_CKPT_DIR, load_lite
        from minimagen_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the minimagen_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    _log_file = open(LOG_PATH, "w")
    # float32 references in full precision (no TF32 in matmuls or convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    with open(os.path.join(LITE_CKPT_DIR, "eval", "metrics.json")) as f:
        captions = json.load(f)["_config"]["eval_captions"]

    with phase("build kernels (one nvcc call)"):
        kernels.library()
        with open(os.path.join(kernels.BUILD_DIR, "build.log")) as f:
            for line in ptxas_summary(f.read()):
                log("  ptxas: " + line)
    with phase("load_lite(device='cuda')"):
        imagen = load_lite(device=DEVICE)
    with phase("record the main path's kernel shapes"):
        embeds, masks = imagen.encode_text(captions)
        per_stage = record_path_shapes(imagen, embeds, masks)
        for stage, counts in enumerate(per_stage):
            log(f"  stage {stage}: " + ", ".join(
                f"{name} {len(c)} shapes {sum(c.values())} launches/step" for name, c in counts.items()))
    with phase("kernels vs plain versions at the path's shapes"):
        rows = kernel_checks(per_stage)
        for stage, sums in enumerate(per_step_kernel_ms(per_stage, rows)):
            log(f"  stage {stage} per step: " + ", ".join(
                f"{name} {v['launches']} x = {v['kernel_ms']:.3f} ms (plain {v['plain_ms']:.3f} ms)"
                for name, v in sums.items()))
    with phase("reference: card float32 vs cpu float32"):
        reference_check(captions[:1])

    snapshots = run_main_path(imagen, captions)
    launches = snapshots["fullrev"]
    missing = [k for k in KERNEL_INFO if launches[k] == 0]
    if missing:
        log(f"kernels never launched on the main path: {missing}")
        return 1

    # a measurement, not a check: a profiler that cannot trace the card
    # leaves the device numbers "not measured"; a failing launch still fails
    with phase("measure: profile guided DDIM steps of each stage"):
        profile_steps(imagen, captions)
        log("  the lite SR stem alone (s2d-4 + kernel 8), kernels per call:")
        stem_kernels(STEM_PATH_SHAPES["lite SR"])

    with phase("record the training step's kernel shapes (batch 16, both stages)"):
        train_shapes, step_launches = train_step_shapes()
        for stage, counts in enumerate(train_shapes):
            log(f"  stage {stage}: " + ", ".join(
                f"{name} {len(c)} shapes {sum(c.values())} launches/step"
                for name, c in counts.items()))
        log(f"  launches in one training step: {step_launches}")
    with phase("backward kernels vs plain versions at the training step's shapes"):
        bwd_rows = backward_checks(train_shapes)
    with phase("reference train step: card float32 vs cpu float32"):
        reference_train_step()
    with phase(f"learn: train_lite, {LEARN_STEPS} steps, batch {TRAIN_BATCH}"):
        run, train_launches, _ = learn()
    with phase("measure: profile training steps"):
        profile_train(run)
    del run

    # ---- the reference's default cascade ----------------------------------
    with phase("free the lite objects; build the default cascade (Base + Super, seed 0)"):
        import gc

        from minimagen_tpu_torch.generate import default_imagen

        del imagen, embeds, masks
        gc.collect()
        torch.cuda.empty_cache()
        big = default_imagen(device=DEVICE, seed=SEED)
        n_params = [sum(p.numel() for p in u.parameters()) for u in big.unets]
        log(f"  parameters: Base {n_params[0] / 1e6:.1f}M, Super {n_params[1] / 1e6:.1f}M "
            f"(float32 masters, bf16 compute); allocated "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    default_captions = captions[:DEFAULT_CAPTIONS]
    with phase("record the default cascade's kernel shapes"):
        big_batch = default_train_batch()
        big_sampling, big_training = default_path_shapes(big, default_captions, big_batch)
        for label, per in (("sampling", big_sampling), ("training", big_training)):
            for stage, counts in enumerate(per):
                log(f"  {label} stage {stage}: " + ", ".join(
                    f"{name} {len(c)} shapes {sum(c.values())} launches/step"
                    for name, c in counts.items()))
    with phase("kernels vs plain versions at the default cascade's shapes"):
        big_rows = kernel_checks(big_sampling + big_training, extra_mha_j=())
        big_bwd_rows = backward_checks(big_training)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
        log("  attention at batch * heads = 8193 * 8 = 65544:")
        _report([check_attention_backward(kind, (8193, 8, 16, 17), torch.bfloat16, gen)
                 for kind in ("mqa", "mha")])
        log("  the stem alone, forward bf16, three formulations:")
        time_stem_formulations()
    with phase("reference: Base 16px + Super 32px, card float32 vs cpu float32"):
        default_reference(default_captions[:1])
    with phase(f"serve the default cascade: {DEFAULT_CAPTIONS} captions, DDIM-{SAMPLE_STEPS}, "
               f"cond_scale {COND_SCALE}, 64 -> 128"):
        serve_launches, _ = serve(big, default_captions)
    with phase("measure: profile guided DDIM steps of the default cascade"):
        profile_steps(big, default_captions)
    with phase(f"train the default cascade: {DEFAULT_TRAIN_STEPS} steps, batch "
               f"{DEFAULT_TRAIN_BATCH}, both stages"):
        big_train_launches, _ = train_default(big, big_batch, big_training)
    del big

    runs = {"lite sampling": launches, "lite learning": train_launches,
            "default serving": serve_launches, "default training": big_train_launches}
    for name, counts in runs.items():
        log(f"launches, {name}: {counts}")
    totals = {k: sum(counts[k] for counts in runs.values()) for k in launches}
    # the 65544-pair attention check is not a path shape: logged above, not in the line
    entries = kernel_entries(rows + bwd_rows + big_rows + big_bwd_rows, totals)
    log(f"launches per base run {snapshots['base']}; elapsed {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError:
        sys.exit(1)
