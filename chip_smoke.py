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
}


class PhaseError(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def device_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


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
def record_path_shapes(imagen, embeds, masks):
    """One guided forward per U-Net with hooks on the modules that call the
    kernels. Returns, per stage, {kernel: Counter(shape)}: the launches of
    one sampling step, by shape (attention (b, h, n, j); GroupNorm
    (b, h, w, c, groups, with scale-shift))."""
    import collections

    import torch
    from minimagen_tpu_torch.models import layers

    per_stage = []

    def on_gn(mod, args, kwargs):
        shape = (*args[0].shape, mod.groups, kwargs.get("scale_shift") is not None)
        per_stage[-1]["group_norm_forward"][shape] += 1

    def on_attn(mod, args, kwargs):
        b, n, _ = args[0].shape
        per_stage[-1]["mqa_forward"][(b, mod.heads, n, n + 1)] += 1

    def on_cross(mod, args, kwargs):
        b, n, _ = args[0].shape
        ctx = kwargs["context"] if "context" in kwargs else args[1]
        per_stage[-1]["mha_forward"][(b, mod.heads, n, ctx.shape[1] + 1)] += 1

    handles = []
    for unet in imagen.unets:
        for mod in unet.modules():
            hook = {layers.GroupNorm: on_gn, layers.Attention: on_attn,
                    layers.CrossAttention: on_cross}.get(type(mod))
            if hook is not None:
                handles.append(mod.register_forward_pre_hook(hook, with_kwargs=True))
    try:
        b = embeds.shape[0]
        dev = embeds.device
        with torch.inference_mode():
            for stage, size in enumerate(imagen.image_sizes):
                per_stage.append({k: collections.Counter() for k in KERNEL_INFO})
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
    torch.cuda.synchronize()
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
    torch.cuda.synchronize()
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


def _bound(nbytes, ops, dtype_name):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS[dtype_name] * 1e3
    return dict(bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations")


def kernel_checks(per_stage):
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shapes = {name: set() for name in KERNEL_INFO}
    for counts in per_stage:
        for name, c in counts.items():
            shapes[name].update(c)
    for b, h, n, _ in list(shapes["mha_forward"]):  # short text contexts (max_length 16) too
        shapes["mha_forward"].update({(b, h, n, 19), (b, h, n, 21)})
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in sorted(shapes["mqa_forward"]):
            rows.append(check_attention("mqa", shape, dtype, gen))
        for shape in sorted(shapes["mha_forward"]):
            rows.append(check_attention("mha", shape, dtype, gen))
        for shape in sorted(shapes["group_norm_forward"]):
            rows.append(check_group_norm(shape, dtype, gen))
    bad = []
    for r in rows:
        ok = r["max_abs_err"] <= r["limit"]
        log(f"  {r['kernel']:<18} {r['dtype']:<8} {str(tuple(r['shape'])):<28} "
            f"max_abs_err {r['max_abs_err']:.3e} (limit {r['limit']:.3e}) "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(r)
    if bad:
        raise PhaseError(f"{len(bad)} kernel checks exceed their limit")
    return rows


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
    """Time `steps` guided DDIM steps of each stage (batch 8): host time per
    step without the profiler, then device busy time per step (sum of kernel
    times in a torch.profiler trace of the same steps) and the kernels that
    take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        kernels_us = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                      if e.self_device_time_total > 0 and e.device_type.name == "CUDA"]
        busy_ms = sum(us for _, us in kernels_us) / 1e3 / steps
        top = sorted(kernels_us, key=lambda kv: -kv[1])[:8]
        row = dict(stage=stage, wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
                   top=[(name[:60], us / 1e3 / steps) for name, us in top])
        out.append(row)
        log(f"  stage {stage}: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
            f"({'not measured' if busy_ms == 0 else f'{100 * busy_ms / wall_ms:.0f}%'})")
        for name, ms in row["top"]:
            log(f"    {ms:8.3f} ms/step  {name}")
    return out


def kernel_entries(rows, launches):
    """One entry per kernel for the JSON line, at the path's heaviest bf16
    shape (largest bound), with its launches on the main path."""
    entries = []
    for name, (source, replaces) in KERNEL_INFO.items():
        bf16 = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"]
        top = max(bf16, key=lambda r: r["bound_ms"])
        entries.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=top["max_abs_err"],
                            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
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
            for line in f:
                if "registers" in line or "spill" in line:
                    log("  ptxas: " + line.strip())
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        log(f"kernels never launched on the main path: {missing}")
        return 1

    # a measurement, not a check: a profiler that cannot trace the card
    # leaves the device numbers "not measured" and fails nothing
    log("[measure] profile: guided DDIM steps of each stage")
    try:
        profile_steps(imagen, captions)
    except (RuntimeError, AttributeError) as e:
        log(f"  profile not measured: {type(e).__name__}: {e}")

    entries = kernel_entries(rows, launches)
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
