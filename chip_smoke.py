#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minimagen_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each with elapsed seconds; any failure exits non-zero:

1. build: compile csrc/*.cu with one nvcc call (ops/kernels.py).
2. load: ``load_lite(device="cuda")`` from assets/lite_ckpt and assets/t5_tiny.
3. kernels: every kernel against its plain PyTorch version at every shape the
   main path gives it (recorded from one guided forward of each U-Net), in
   bfloat16 and float32, with the limit beside each max-abs difference, and
   the kernel's, the plain version's and one PyTorch call's median times
   (CUDA events around one call, the wrapper's host work included); for
   attention and GroupNorm also ``device_ms``, events around 20 launches back
   to back over 20 (GroupNorm rows also name the form each shape took and
   time F.group_norm on the channels-last tensor, which does less work, for
   reference), for the kernel and for attention's yardstick (for multi-query the faster
   of SDPA over K/V expanded to every head and SDPA's grouped-query form),
   and a bound that counts the exponentials (16 per SM per clock at the SM
   clock nvidia-smi reports) beside bytes and tensor operations.
4. reference: one guided forward per U-Net on the card in float32 (kernels)
   against the port on the CPU in float32 (plain versions).
5-7. the main path, with the launch counts reset just before it: the base
   stage (DDIM-50, cond_scale 3.0, the 8 eval captions of
   assets/lite_ckpt/eval/metrics.json), the cascade truncated at 0.2, and the
   full-reverse cascade, all without encoder-feature caching
   (``cache_interval=None``, as the committed rows were made). Colour
   distances are held to 0.06 (committed rows: base 0.0245, truncated
   0.0189).
7q. quality rows of metrics.json on the committed weights, each a mean over
   4 generator seeds (``quality.py``): sr/start0.2 above its bicubic
   baseline, sr/start0.4 above its committed row less 1 dB (that row is
   itself below bicubic), holdout/trained and holdout/held (base stage and
   cascade truncated at 0.2) and trunc/sr0.4 colour distances at most 0.06.
7a. solvers: the base stage at 10 steps as DDIM on the lambda grid, DPM++ on
   the lambda grid and UniPC on the karras grid, each colour distance held
   to 0.06 (committed 0.0312, 0.0266, 0.0277).
7b. cache drift: the full-reverse DDIM-50 cascade with cache_interval 2 and
   None from one seed, PSNR at least 30 dB (committed 38.51).
7c. the fast recipe: DPM++ at (10, 50) steps, the super-res stage truncated
   at 0.2, cache_interval 'auto' (each stage's decision printed with the cost
   model's numbers); colour distance held to 0.06 (committed 0.018), s/image
   beside the DDIM-50 full reverse of 7b.
7d. cache bit identity: cache_interval 1 against None (and None against
   None) on the card, equal bits.
7e. a measurement, not a check: host ms per guided DDIM step of each stage
   with cache_interval None and 2, in turns, three times over, with the
   spread, beside the caching cost model's decision (repeated for the
   default cascade in 17b, after which each stage's verdict and the
   constants the runs imply are printed).
8. a measurement, not a check: the host time of 5 guided DDIM steps per
   stage, and a torch.profiler trace of them for the device's busy time and
   its largest kernels, and the device ms per step of each kernel family
   (the wgmma multi-query kernels, the wgmma multi-head kernels, the
   float32 attention_ kernels, the dk/dv slice sum, GroupNorm).
9. record the training step's kernel shapes: one step of both stages at
   batch 16 with hooks on the modules that call the kernels.
10. backward kernels against their plain versions at those shapes, in
   bfloat16 and float32 (the biased multi-head forward and backward with a
   bias from a mask dropping about a quarter of the keys), with the same
   limits and times as phase 3 and, for attention, autograd through
   ``F.scaled_dot_product_attention`` as the yardstick.
10a. every attention kernel, forward and backward, bfloat16 and float32, on
   a batch whose sample 1 drops every key: uniform rows, P = 1/j, against
   the plain versions at the same limits.
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
   torch.profiler trace of 5 steps, with the kernel families as in
   phase 8.
13a. the harness: ``python -m minimagen_tpu_torch.train`` on the lite
   cascade at full width (a written parameters/ directory, batch 16, 512
   synthetic items, checkpoints and validation every 10 batches, bf16
   compute, EMA 0.9995, a bf16 Adam first moment), a ``-rd`` restart for one
   more epoch, then ``python -m minimagen_tpu_torch.inference`` (DDIM-50,
   seed 0) on the 8 eval captions, as subprocesses, each counting its own
   launches: losses finite, the progress log's checkpoint and validation
   lines, the restart resuming at the dumped step with Adam's count equal
   to it, 8 PNGs of 256x256x3 whose pixels equal ``Imagen.sample``'s from
   the same weights, seed and arguments; MinimagenTrain's steps/sec beside
   ``train_lite``'s at the same recipe.
13b. mesh M1, a world of one process over NCCL on cuda:0: each collective
   (all-reduce, reduce-scatter, all-gather, broadcast, an object, a
   barrier) against its expected value; 5 train steps of the lite cascade
   from a fresh init at batch 16 (bf16 compute, a bf16 Adam first moment,
   the EMA) on one device and under ``--ZERO1`` off, on and fsdp
   (``training.make_train_step(mesh=)``), in turns one/off/on/fsdp/fsdp/
   on/off/one: losses, parameters and EMA equal bits to the one-device
   step, host ms per step over the last 4 (a measurement); the cascade
   truncated at 0.2 (DDIM-10, 8 captions) by ``sample(mesh=)`` equal bits
   to ``sample()``.
13c. mesh M2, two processes sharing the card over gloo (every collective
   staged through host memory, which the children's log says), started
   by ``parallel.collectives.spawn``; each runs 2 float32 steps per mode
   against the one-device step (losses within 2e-4 relative, parameters
   and EMA within 1e-5 relative L2: the CPU tests' tolerances) and reports
   its bytes of parameters, moments and EMA per mode (held equal to the
   plan's reckoning, which is also printed for the default cascade); bf16
   ``sample(mesh=)`` of the cascade truncated at 0.2 (DDIM-50, 8 captions,
   4 per process): base and cascade colour distances at most 0.06, and in
   float32 within 1e-3 relative L2 of ``sample()``; the pipelined server
   (stage 0 on process 0, stage 1 on process 1, two requests of 4
   captions): colour at most 0.06 in bf16 and within 1e-3 relative L2 of
   ``Imagen.sample`` in float32. Each process counts its launches, and
   each must have launched every kernel.
13d. mesh M3, two processes sharing the card over gloo on the mesh {data 1,
   model 2} (``make_mesh(model_parallel=2)``: the wide kernels split over
   the model axis by the JAX package's rule, ``parallel/tensor.py``): 2
   float32 lite train steps against the one-device step (losses, parameters
   and EMA within 1e-5 relative) and the process's bytes of parameters,
   moments and EMA equal to the plan's reckoning (printed for the default
   cascade too); a sharded dump written on {data 2} (ZeRO-1, after a step)
   restored on {model 2}, every tensor equal bits; ``sample(mesh=)`` of the
   cascade truncated at 0.2 (8 captions): bf16 colours at most 0.06
   (DDIM-50), float32 within 1e-5 of ``sample()`` (DDIM-10); the default
   cascade at full
   width, each stage's float32 guided forward (one caption) with its
   kernels split against the same seeded weights whole, within 1e-5. The
   launches are the tensor-parallel calls' alone, and every kernel must
   have launched. Gloo stages every collective through host memory: no
   time of this phase is tensor parallelism's speed.
13e. the tools: ``Imagen.stage_memory_analysis`` of both lite stages (8
   captions, DDIM-10; the pass's measured peak beside the allocator's),
   the lite cascade exported to reference ``.pth`` files and imported
   back (``tools/torch_import.py``), sampling equal bits; a trace of 5
   guided base steps written and read back through ``utils/profiling``
   (its kernels' sum against the profile's, within 5%), and every trace
   the profile phases wrote (``build/traces/``) summarized by family.

The reference's default cascade (``generate.default_imagen``: Base at 64px,
Super at 128px, t5_base through the hash encoder, 2.33B parameters, fresh
seeded init, float32 master parameters, bf16 compute), after the lite
objects are freed:

13f. ``stage_memory_analysis`` of Base (4 captions, DDIM-10).
14. record its kernel shapes: one guided forward per stage at 8 rows and one
   forward and backward of both stage losses at batch 2, with the hooks.
15. every forward and backward kernel against its plain version at those
   shapes (GroupNorm at 128-3584 channels, depth-to-space + bias bit-equal),
   attention forward and backward at batch * heads = 65544, and the whole
   stem alone at each stem shape of both cascades in three formulations
   (reference convs, s2d-4 + kernel 8, s2d-2 + kernel 8), a measurement.
16. reference: Base at 16px and Super at 32px (over a 16px low-res image),
   full width and depth, one caption guided, float32 on the card against a
   CPU copy of the same weights; then 3-step DPM++ (lambda grid) and UniPC
   (karras grid) cascades at 16/32px with cache_interval 2, guidance_rescale
   0.7 and the super-res stage truncated at 0.2, draws injected from numpy,
   each stage within 1e-3 relative L2.
17. serve, with the launch counts reset just before it: 4 eval captions,
   cond_scale 3.0, DDIM-50 through both stages; images finite in [0, 1],
   every forward kernel launched, peak memory.
17a. serve the same captions with DPM++-10 and cache_interval 'auto', the
   counts reset just before: finite images in [0, 1], every forward kernel
   launched, s/image beside 17's.
17b. the cache measurement of 7e for Base and Super; then the per-step
   profile of each stage.
18. train, with the launch counts reset just before it: 3 steps of both
   stages at batch 2 (train.py's default) with make_train_step: losses
   finite, parameters moved, the EMA within 2 float32 ulps of its
   definition, every backward kernel launched, peak memory.

The lite sampling profile (phase 8) also times the stem alone (a
record_function range around it, and a trace of the SR stem by itself).

Then it prints the kernels' JSON line (attention and GroupNorm entries also
carry ``device_ms``, attention ``library_device_ms``, GroupNorm the
``form``), the card's name and power limit, and
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
# the base stage's solver rows of metrics.json (sampler, grid, committed
# colour distance), 10 steps each, held to COLOR_LIMIT
SOLVER_STEPS = 10
SOLVER_ROWS = (("ddim", "lambda", 0.0312), ("dpmpp", "lambda", 0.0266), ("unipc", "karras", 0.0277))
# the committed fast recipe (recipe/fast-dpmpp10+trunc0.2+cacheauto, colour 0.018)
FAST_RECIPE = dict(sampler="dpmpp", sample_steps=(10, 50), sr_start_noise_levels=0.2,
                   cache_interval="auto")
# cache_interval=2 against None, DDIM-50 full reverse: PSNR in dB (committed
# cache/2 row 38.51, bf16 on another device)
CACHE_PSNR_LIMIT = 30.0
# the default cascade's float32 solver check, card vs CPU at 16/32px: (sampler,
# grid, steps per stage), the super-res steps chosen so that 3 survive the
# truncation at 0.2
REFERENCE_SOLVERS = (("dpmpp", "lambda", (3, 6)), ("unipc", "karras", (3, 10)))
REFERENCE_SOLVER_KW = dict(cache_interval=2, guidance_rescale=0.7, sr_start_noise_levels=0.2)
# guided DDIM steps per timed run, runs per setting, and repetitions of the
# whole measurement (the host's pace shifts between blocks of runs)
CACHE_TIMING_STEPS, CACHE_TIMING_RUNS, CACHE_TIMING_REPS = 4, 20, 3
# quality rows of metrics.json checked on the committed weights: truncated
# super-resolution PSNR (sr/start0.2 must beat its bicubic baseline;
# sr/start0.4's committed row, 24.44 dB, is itself below its 27.08 dB
# baseline, so it is held to the committed value less SR_PSNR_SLACK_DB) and
# the holdout colour distances (COLOR_LIMIT each)
SR_COMMITTED = {0.2: (27.96, 27.08), 0.4: (24.44, 27.08)}  # (psnr, bicubic) dB
SR_PSNR_SLACK_DB = 1.0
SR_NUMPY_SEEDS = (3, 4)  # the sr rows also on quality.numpy_noise draws (logged)
# each row is a mean over this many generator seeds: one draw of 8 images
# per holdout tag moved a colour distance by ~0.04 on the card (one image
# of another colour), where the rows and their limit are ~0.02-0.06 apart
QUALITY_SEEDS = 4
HOLDOUT_COMMITTED = {"trained": (0.0216, 0.015), "held": (0.0321, 0.0499)}  # base, truncated
# the harness phase: train.py's CLI on the lite cascade at full width (512
# synthetic items, batch 16: 32 steps an epoch), a restart for one more
# epoch, then the inference CLI (DDIM-50, seed 0) on the eval captions
HARNESS_CHCKPT_NUM = 10
HARNESS_TRAIN_ARGS = ["-b", "16", "-e", "1", "-f", "0.25", "-vn", "15", "-cn",
                      str(HARNESS_CHCKPT_NUM), "--BF16", "--EMA", "0.9995", "--MU_DTYPE", "bf16"]
HARNESS_INFER_ARGS = ["--SAMPLER", "ddim", "--SAMPLE_STEPS", str(SAMPLE_STEPS), "--SEED", "0"]
HARNESS_SIDE = 256
# each run: 2048 * 0.25 = 512 items at batch 16, and a checkpoint and a
# validation at every HARNESS_CHCKPT_NUM-th batch from 0; a progress-log line
# with one of the HARNESS_FAULTS means a failure the harness caught and
# trained past
HARNESS_STEPS = 32
HARNESS_FAULTS = ("ABORTED", "SKIPPED", "FAILED", "RESTORED")
HARNESS_TIMEOUT_S = 600
MESH_BATCH = 16  # the lite training batch (train_lite), split over the mesh
MESH_STEPS, MESH_TIMED_STEPS = 5, 4  # world 1: the last 4 steps timed
MESH_TIMING_ORDER = ("one", "off", "on", "fsdp", "fsdp", "on", "off", "one")  # in turns
MESH_F32_STEPS = 2  # two processes, float32
MESH_SAMPLE_STEPS = 10
MESH_LOSS_RTOL, MESH_PARAM_REL = 2e-4, 1e-5  # the CPU tests' (tests/test_torch_parallel.py)
MESH_TP_REL = 1e-5  # M3: float32 under a model axis against one device, relative
MESH_TIMEOUT_S = 600
SEED = 0
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# exponentials: 16 per SM per clock (the special-function units), at the SM
# clock nvidia-smi reports as clocks.max.sm (read in main)
EXP_PER_SM_CLOCK = 16
SM_CLOCK_HZ = None
SM_COUNT = None

# kernel -> (source, the TPU kernel it replaces, the design its bf16 calls
# launch: csrc/ kernel names)
KERNEL_INFO = {
    "mqa_forward": ("minimagen_tpu_torch/csrc/flash_attention.cu",
                    "minimagen_tpu/ops/flash_attention.py:92",
                    "mqa_fwd_hopper_kernel: TMA ring, wgmma, rows across heads"),
    "mha_forward": ("minimagen_tpu_torch/csrc/flash_attention.cu",
                    "minimagen_tpu/ops/flash_attention.py:97 and :349",
                    "mha_fwd_hopper_kernel: TMA ring, wgmma, per-head K/V, narrow tail first, "
                    "row blocks of a head in turn"),
    "group_norm_forward": ("minimagen_tpu_torch/csrc/group_norm.cu",
                           "minimagen_tpu/ops/group_norm.py:89",
                           "gn_fwd_cluster_kernel (a sample held across a cluster, one launch) or "
                           "gn_fwd_stats/apply_kernel (tile statistics, Chan merge, two launches)"),
    "depth_to_space_bias": ("minimagen_tpu_torch/csrc/depth_to_space.cu",
                            "minimagen_tpu/ops/stem_conv.py:146", "depth_to_space_bias_kernel"),
}
BACKWARD_INFO = {
    "mqa_backward": ("minimagen_tpu_torch/csrc/flash_attention.cu",
                     "minimagen_tpu/ops/flash_attention.py:174",
                     "mqa_bwd_dq/dkdv_hopper_kernel: TMA ring, wgmma, dk/dv summed over heads"),
    "mha_backward": ("minimagen_tpu_torch/csrc/flash_attention.cu",
                     "minimagen_tpu/ops/flash_attention.py:394",
                     "mha_bwd_dq/dkdv_hopper_kernel: TMA ring, wgmma, per-head K/V, narrow tail, "
                     "bf16 dk/dv from registers"),
    "group_norm_backward": ("minimagen_tpu_torch/csrc/group_norm.cu",
                            "minimagen_tpu/ops/group_norm.py:156",
                            "gn_bwd_cluster_kernel (one launch) or gn_bwd_partial/apply_kernel "
                            "(two launches)"),
}
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
TRACE_DIR = os.path.join(REPO, "build", "traces")  # the profiles' Chrome traces (gitignored)
_log_file = None


def log(msg):
    print(msg, flush=True)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


def traced(fn, ranges=(), name="trace"):
    """Run fn() under a torch.profiler trace of the card, written as a
    Chrome trace into TRACE_DIR/`name`; returns the trace's (name, device
    us) kernel items and {name: device us of the kernels inside that
    record_function range} for each name of `ranges`; both empty (zeros)
    when the profiler itself cannot start or stop (no CUPTI on the
    machine). An error raised by fn() is never caught."""
    from minimagen_tpu_torch.utils import profiling
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
        profiling.save_trace(prof, os.path.join(TRACE_DIR, name))
        items = profiling.kernel_times(prof)
        for e in prof.key_averages():
            if e.key in spans and e.device_type.name == "CPU":
                spans[e.key] = max(spans[e.key], e.device_time_total)
    except (RuntimeError, AttributeError) as e:
        log(f"  the profiler did not stop ({type(e).__name__}: {e}): device time not measured")
    return items, spans


def kernel_families(items, steps):
    """Device ms per step of each kernel family of
    ``utils/profiling.py::op_category`` among trace items."""
    from minimagen_tpu_torch.utils.profiling import family_ms

    return family_ms(items, steps)


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


def sm_clock_line():
    """The SM clock ceiling as nvidia-smi gives it (e.g. "1980 MHz"), or
    None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
            else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def device_ms(fn, reps=10):
    """``device_ms`` of minimagen_tpu_torch/ab_times.py: the median over
    `reps` of CUDA-event time around 20 back-to-back calls, over 20, so the
    queue runs ahead of the host and the wrapper's host work hides behind
    the device's (unless it is the longer)."""
    from minimagen_tpu_torch.ab_times import device_ms as measure

    return measure(fn, reps)


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
    row["ms"] = median_ms(lambda: kernel(q, k, v))
    row["device_ms"] = device_ms(lambda: kernel(q, k, v))
    row["plain_ms"] = median_ms(lambda: plain(q, k, v))
    forms = {"sdpa": lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)}
    if kind == "mqa":  # K/V expanded over the heads, or SDPA's grouped-query form
        kx, vx = k[:, None].expand(b, h, j, d), v[:, None].expand(b, h, j, d)
        forms = {"sdpa expanded": lambda: F.scaled_dot_product_attention(q, kx, vx, scale=1.0),
                 "sdpa gqa": lambda: F.scaled_dot_product_attention(
                     q, k[:, None], v[:, None], scale=1.0, enable_gqa=True)}
    row.update(_library(forms))
    itemsize = q.element_size()
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * itemsize
    ops = 4 * b * h * n * j * d
    row.update(_bound(nbytes, ops, row["dtype"], exps=b * h * n * j))
    return row


def _library(forms):
    """The yardstick: each one-call PyTorch form timed both ways; the faster
    form by device time is the row's library call (timed only, never used
    by the port)."""
    times = {name: (median_ms(fn), device_ms(fn)) for name, fn in forms.items()}
    best = min(times, key=lambda name: times[name][1])
    return dict(library_ms=times[best][0], library_device_ms=times[best][1], library_form=best)


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
    if DEVICE == "cuda":
        row["form"] = gn.plan_info(False, x, g)["form"]
    row["ms"] = median_ms(lambda: gn.group_norm_silu(x, gamma, beta, **kw))
    row["device_ms"] = device_ms(lambda: gn.group_norm_silu(x, gamma, beta, **kw))
    row["plain_ms"] = median_ms(lambda: gn.group_norm_silu_plain(x, gamma, beta, **kw))
    row["library_ms"] = None  # no single PyTorch call fuses norm, scale-shift and SiLU
    # for reference only, doing less work (no scale-shift, no SiLU): PyTorch's
    # GroupNorm on the channels-last tensor
    xc = x.permute(0, 3, 1, 2)
    row["torch_group_norm_device_ms"] = device_ms(
        lambda: torch.nn.functional.group_norm(xc, g, gamma, beta))
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


def _bound(nbytes, ops, dtype_name, exps=0):
    """The least time: bytes over the memory rate, operations over the
    type's peak, and `exps` exponentials over the special-function units
    (EXP_PER_SM_CLOCK per SM per clock); bound_by "bytes" or "operations",
    bound_detail which of bytes, tensor or CUDA-core operations and
    exponentials."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS[dtype_name] * 1e3
    exp_ms = exps / (SM_COUNT * EXP_PER_SM_CLOCK * SM_CLOCK_HZ) * 1e3 if exps else 0.0
    bound = max(byte_ms, op_ms, exp_ms)
    detail = ("bytes" if bound == byte_ms else "exponentials" if bound == exp_ms
              else "operations")
    return dict(bound_ms=bound, bound_by="bytes" if bound == byte_ms else "operations",
                bound_detail=detail, exp_bound_ms=exp_ms)


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
                                   sampler="ddim", sample_steps=SAMPLE_STEPS, cache_interval=None)
        arr = base.float().cpu().numpy()
        cd, gm = color_metric(arr, captions), grad_mean(arr)
        log(f"  base color_dist {cd:.4f} (limit {COLOR_LIMIT}, committed 0.0245) grad_mean {gm:.4f}")
        if not (np.isfinite(arr).all() and cd <= COLOR_LIMIT):
            raise PhaseError("base stage color distance above the limit")
    snap("base")
    with phase("cascade truncated at 0.2"):
        out = imagen.sample(captions, cond_scale=COND_SCALE, sampler="ddim",
                            sample_steps=SAMPLE_STEPS, sr_start_noise_levels=0.2,
                            cache_interval=None, generator=gen)
        arr = out.float().cpu().numpy()
        cd, gm = color_metric(arr, captions), grad_mean(arr)
        log(f"  trunc/sr0.2 color_dist {cd:.4f} (limit {COLOR_LIMIT}, committed 0.0189) "
            f"grad_mean {gm:.4f}")
        if not (np.isfinite(arr).all() and cd <= COLOR_LIMIT):
            raise PhaseError("truncated cascade color distance above the limit")
    snap("trunc")
    with phase("cascade full reverse"):
        out = imagen.sample(captions, cond_scale=COND_SCALE, sampler="ddim",
                            sample_steps=SAMPLE_STEPS, cache_interval=None, generator=gen)
        arr = out.float().cpu().numpy()
        cd, gm = color_metric(arr, captions), grad_mean(arr)
        log(f"  fullrev shape {arr.shape} finite {bool(np.isfinite(arr).all())} "
            f"color_dist {cd:.4f} (committed 0.6127) grad_mean {gm:.4f}")
        if arr.shape != (len(captions), 256, 256, 3) or not np.isfinite(arr).all():
            raise PhaseError("full-reverse cascade output is not finite (8, 256, 256, 3)")
    snap("fullrev")
    return snapshots


def require_launched(launches, what, names=tuple(KERNEL_INFO)):
    """Fail the phase if a kernel of `names` never launched in `launches`."""
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise PhaseError(f"{what}: kernels never launched: {missing}")


def counted(fn):
    """fn() with the launch counts set to 0 just before and read just after;
    returns (its result, the launches, host seconds, synchronized)."""
    from minimagen_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, dict(kernels.LAUNCHES), time.perf_counter() - t0


def log_cache_decisions(imagen, rows, text_len):
    """Each stage's 'auto' decision at `rows` guided rows, with the cost
    model's numbers."""
    for stage in range(imagen.num_unets):
        m = imagen.encoder_cache_cost_model(stage, rows, text_len)
        log(f"  stage {stage} 'auto' at {rows} rows: cache_interval "
            f"{2 if m['enable'] else None}; cache {m['cache_bytes'] / 2 ** 20:.2f} MiB, down-path "
            f"FLOPs {m['down_flops_est']:.4g}, saved {m['saved_s_per_step'] * 1e3:.3f} ms/step "
            f"against {m['cost_s_per_step'] * 1e3:.3f} ms")


def solver_phase(imagen, captions):
    """The base stage at SOLVER_STEPS steps through each solver row of
    metrics.json, one initial image for all, no caching (as the rows were
    made); colour distances held to COLOR_LIMIT. Returns the launches."""
    import numpy as np
    import torch
    from minimagen_tpu_torch.quality import color_metric

    embeds, masks = imagen.encode_text(captions)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    init = torch.randn(len(captions), 64, 64, 3, generator=gen, device=DEVICE)

    def run():
        out = {}
        for sampler, grid, _ in SOLVER_ROWS:
            img = imagen.sample_stage(0, embeds, masks, COND_SCALE, init_noise=init,
                                      sampler=sampler, sample_steps=SOLVER_STEPS, grid=grid,
                                      cache_interval=None)
            out[(sampler, grid)] = img.float().cpu().numpy()
        return out

    outs, launches, seconds = counted(run)
    failures = []
    for sampler, grid, committed in SOLVER_ROWS:
        arr = outs[(sampler, grid)]
        cd = color_metric(arr, captions)
        log(f"  {sampler}-{SOLVER_STEPS}@{grid}: color_dist {cd:.4f} (limit {COLOR_LIMIT}, "
            f"committed {committed})")
        if not (np.isfinite(arr).all() and cd <= COLOR_LIMIT):
            failures.append(f"{sampler}@{grid} color distance {cd:.4f}")
    log(f"  {seconds:.2f} s for the three runs; launches {launches}")
    if failures:
        raise PhaseError("; ".join(failures))
    require_launched(launches, "solver runs")
    return launches


def lite_cascade(imagen, captions, seed, **kw):
    """One guided lite cascade from a fresh generator seeded `seed`: (images
    on the card, launches, host seconds)."""
    import torch

    def run():
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        return imagen.sample(captions, cond_scale=COND_SCALE, generator=gen, **kw)

    return counted(run)


def cache_phases(imagen, captions):
    """Caching on the lite cascade: DDIM-50 full reverse with
    cache_interval 2 against None from one seed (PSNR held to
    CACHE_PSNR_LIMIT); the fast recipe (colour held to COLOR_LIMIT, s/image
    beside DDIM-50's); cache_interval 1 against None, and None against
    None, equal bits. Returns {path: launches}."""
    import numpy as np
    import torch
    from minimagen_tpu_torch.quality import color_metric, grad_mean, psnr_db

    b = len(captions)
    paths = {}
    with phase("cache drift: DDIM-50 full reverse, cache_interval 2 vs None"):
        exact, paths["lite DDIM-50 exact"], s_exact = lite_cascade(
            imagen, captions, SEED + 6, sampler="ddim", sample_steps=SAMPLE_STEPS,
            cache_interval=None)
        cached, paths["lite DDIM-50 cache 2"], s_cached = lite_cascade(
            imagen, captions, SEED + 6, sampler="ddim", sample_steps=SAMPLE_STEPS,
            cache_interval=2)
        exact, cached = (a.float().cpu().numpy() for a in (exact, cached))
        db = psnr_db(cached, exact)
        log(f"  PSNR cache 2 vs exact {db:.2f} dB (limit {CACHE_PSNR_LIMIT}, committed 38.51); "
            f"color_dist exact {color_metric(exact, captions):.4f} cache 2 "
            f"{color_metric(cached, captions):.4f}; s/image exact {s_exact / b:.4f} cache 2 "
            f"{s_cached / b:.4f} (host clock, synchronized)")
        if not (np.isfinite(cached).all() and db >= CACHE_PSNR_LIMIT):
            raise PhaseError(f"cache_interval=2 drifts {db:.2f} dB from exact")
        for name in ("lite DDIM-50 exact", "lite DDIM-50 cache 2"):
            require_launched(paths[name], name)
    with phase("fast recipe: DPM++ (10, 50), SR truncated at 0.2, cache_interval 'auto'"):
        embeds, _ = imagen.encode_text(captions)
        log_cache_decisions(imagen, 2 * b, embeds.shape[1])
        out, paths["lite fast recipe"], s_fast = lite_cascade(imagen, captions, SEED + 7,
                                                              **FAST_RECIPE)
        arr = out.float().cpu().numpy()
        cd, gm = color_metric(arr, captions), grad_mean(arr)
        log(f"  color_dist {cd:.4f} (limit {COLOR_LIMIT}, committed 0.018) grad_mean {gm:.4f}; "
            f"{s_fast / b:.4f} s/image against DDIM-50 full reverse {s_exact / b:.4f} "
            f"(host clock, synchronized); launches {paths['lite fast recipe']}")
        if not (np.isfinite(arr).all() and cd <= COLOR_LIMIT):
            raise PhaseError("fast recipe color distance above the limit")
        require_launched(paths["lite fast recipe"], "fast recipe")
        # a measurement beside the check: the same recipe and seed without caching
        exact_recipe, _, s_exact_recipe = lite_cascade(
            imagen, captions, SEED + 7, **dict(FAST_RECIPE, cache_interval=None))
        log(f"  the same without caching: color_dist "
            f"{color_metric(exact_recipe.float().cpu().numpy(), captions):.4f}, "
            f"{s_exact_recipe / b:.4f} s/image")
    with phase("cache bit identity: cache_interval 1 vs None (and None vs None)"):
        kw = dict(FAST_RECIPE, sample_steps=(SOLVER_STEPS, SAMPLE_STEPS))
        runs = {}
        for label, cache in (("none", None), ("one", 1), ("none again", None)):
            runs[label], _, _ = lite_cascade(imagen, captions, SEED + 8,
                                             **dict(kw, cache_interval=cache))
        same_none = torch.equal(runs["none"], runs["none again"])
        same_one = torch.equal(runs["one"], runs["none"])
        log(f"  None twice equal: {same_none}; cache_interval 1 equal to None: {same_one}")
        if not (same_none and same_one):
            raise PhaseError("cache_interval=1 does not give the bits of no cache")
    return paths


def measure_cache_steps(imagen, captions, label, rep=0):
    """A measurement, not a check: host ms per guided DDIM step of each
    stage with cache_interval None and 2 (CACHE_TIMING_RUNS runs of
    CACHE_TIMING_STEPS steps each, in turns N 2 2 N ...), synchronized. The
    gain is the difference of the medians, the spread the distance between
    the quartiles of the uncached runs; a stage got faster when the cached
    run of a turn wins at least nine in ten turns and the gain exceeds the
    spread. Prints the caching cost model's inputs and decision beside
    them. Returns one row per stage."""
    import torch
    from minimagen_tpu_torch.models.unet import encoder_cache_shapes

    embeds, masks = imagen.encode_text(captions)
    b = len(captions)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    rows = []
    for stage, size in enumerate(imagen.image_sizes):
        kw = {}
        if stage > 0:
            kw = dict(lowres_cond_img=torch.rand(b, size, size, 3, generator=gen, device=DEVICE),
                      lowres_noise_times=torch.full((b,), 200, device=DEVICE))
        init = torch.randn(b, size, size, 3, generator=gen, device=DEVICE)

        def run(cache):
            t0 = time.perf_counter()
            imagen.sample_stage(stage, embeds, masks, COND_SCALE, init_noise=init,
                                sampler="ddim", sample_steps=CACHE_TIMING_STEPS,
                                cache_interval=cache, **kw)
            sync()
            return (time.perf_counter() - t0) * 1e3 / CACHE_TIMING_STEPS

        run(None), run(2)  # warm-up
        times = {None: [], 2: []}
        for i in range(CACHE_TIMING_RUNS):
            for cache in ((None, 2) if i % 2 == 0 else (2, None)):
                times[cache].append(run(cache))
        med = {k: statistics.median(v) for k, v in times.items()}
        q1, _, q3 = statistics.quantiles(times[None], n=4)
        spread = q3 - q1
        wins = sum(c < n for n, c in zip(times[None], times[2]))
        model = imagen.encoder_cache_cost_model(stage, 2 * b, embeds.shape[1])
        maps = len(encoder_cache_shapes(imagen.unet_configs[stage], 2 * b, size))
        gain = med[None] - med[2]
        row = dict(path=f"{label} stage {stage}", rep=rep, rows=2 * b, ms_none=times[None],
                   ms_cache2=times[2],
                   median_none=med[None], median_cache2=med[2], gain_ms=gain, spread_ms=spread,
                   wins=wins, cached_maps=maps, down_flops_est=model["down_flops_est"],
                   faster=gain > spread and wins >= 0.9 * CACHE_TIMING_RUNS,
                   auto=model["enable"])
        rows.append(row)
        log(f"  {row['path']} rep {rep} ({2 * b} rows): ms/step None {med[None]:.3f} "
            f"{[round(t, 3) for t in times[None]]}, cache 2 {med[2]:.3f} "
            f"{[round(t, 3) for t in times[2]]}; gain {gain:.3f} ms, spread {spread:.3f} ms, "
            f"cached faster in {wins}/{CACHE_TIMING_RUNS} turns: faster {row['faster']}; "
            f"model: {maps} cached maps, "
            f"down-path FLOPs {model['down_flops_est']:.4g}, saved "
            f"{model['saved_s_per_step'] * 1e3:.3f} ms against {model['cost_s_per_step'] * 1e3:.3f}"
            f" ms, 'auto' {'on' if row['auto'] else 'off'}")
    return rows


def fit_cache_constants(rows):
    """The cost model's constants these measurements imply (Imagen's
    _HOST_S_PER_CACHED_MAP, _DOWN_FLOPS_PER_S, _CACHE_MIN_SAVING_S), and
    per stage the verdict over its repetitions: faster when the median gain
    exceeds the median spread and the cached run won nine in ten turns. A
    cached step at interval 2 saves, on average over two steps, half a
    step's down path: the host s per cached map is the least-squares fit of
    gain = 0.5 * maps * host_s over every measurement; the FLOP rate is the
    largest 0.5 * FLOPs / gain (so the device term predicts no measurement a
    larger saving than it showed); the least saving that counts is the
    median spread of every measurement."""
    gains = [r["gain_ms"] * 1e-3 for r in rows]
    maps = [r["cached_maps"] for r in rows]
    host = 2.0 * sum(g * m for g, m in zip(gains, maps)) / sum(m * m for m in maps)
    rate = max(0.5 * r["down_flops_est"] / g for r, g in zip(rows, gains) if g > 0)
    least = statistics.median(r["spread_ms"] for r in rows) * 1e-3
    stages = {}
    for r in rows:
        stages.setdefault(r["path"], []).append(r)
    verdicts = {}
    for path, rs in stages.items():
        gain = statistics.median(r["gain_ms"] for r in rs)
        spread = statistics.median(r["spread_ms"] for r in rs)
        wins = sum(r["wins"] for r in rs) / (CACHE_TIMING_RUNS * len(rs))
        saved = 0.5 * max(rs[0]["down_flops_est"] / rate, rs[0]["cached_maps"] * host)
        verdicts[path] = dict(gain_ms=gain, spread_ms=spread, wins=wins,
                              faster=gain > spread and wins >= 0.9, predicted_ms=saved * 1e3,
                              fitted_auto=saved > least, port_auto=rs[0]["auto"])
    return dict(host_s_per_cached_map=host, down_flops_per_s=rate, cache_min_saving_s=least,
                stages=verdicts)


def log_cache_fit(rows, imagen):
    fit = fit_cache_constants(rows)
    log(f"  constants these runs imply: host s per cached map {fit['host_s_per_cached_map']:.4g}, "
        f"down-path FLOP/s {fit['down_flops_per_s']:.4g}, least saving "
        f"{fit['cache_min_saving_s']:.4g} s; in the port: {imagen._HOST_S_PER_CACHED_MAP}, "
        f"{imagen._DOWN_FLOPS_PER_S}, {imagen._CACHE_MIN_SAVING_S}")
    for path, v in fit["stages"].items():
        log(f"  {path}: median gain {v['gain_ms']:.3f} ms, median spread {v['spread_ms']:.3f} ms, "
            f"cached faster in {100 * v['wins']:.0f}% of turns: faster {v['faster']}; 'auto' "
            f"{'on' if v['port_auto'] else 'off'} in the port "
            f"({'agrees' if v['port_auto'] == v['faster'] else 'DISAGREES'}), "
            f"{'on' if v['fitted_auto'] else 'off'} with these runs' constants (predicted saving "
            f"{v['predicted_ms']:.3f} ms)")
    return fit


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
                                sample_steps=steps, cache_interval=None, **kw)
            torch.cuda.synchronize()

        run()  # warm-up
        t0 = time.perf_counter()
        run()  # host time, without the profiler's own overhead
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        handles = stem_ranges(imagen)
        try:
            kernels_us, spans = traced(run, ranges=("stem",),
                                       name=f"steps_{size}px_stage{stage}")
        finally:
            for h in handles:
                h.remove()
        busy_ms = sum(us for _, us in kernels_us) / 1e3 / steps
        stem_ms = spans["stem"] / 1e3 / steps
        top = sorted(kernels_us, key=lambda kv: -kv[1])[:8]
        row = dict(stage=stage, wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
                   stem_ms_per_step=stem_ms,
                   family_ms_per_step=kernel_families(kernels_us, steps),
                   top=[(name[:60], us / 1e3 / steps) for name, us in top])
        out.append(row)
        log(f"  stage {stage}: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
            f"({'not measured' if busy_ms == 0 else f'{100 * busy_ms / wall_ms:.0f}%'}), "
            f"stem (record_function range) {stem_ms:.3f} ms/step")
        log("    kernels by family, device ms/step: "
            + ", ".join(f"{k} {v:.3f}" for k, v in row["family_ms_per_step"].items()))
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
    call = lambda: fa.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)  # noqa: E731
    row["ms"] = median_ms(call)
    row["device_ms"] = device_ms(call)
    row["plain_ms"] = median_ms(lambda: plain_bwd(q, k, v, g, attn_bias=bias))
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    mask = None if keep is None else keep[:, None, None, :]

    def grad_form(kx, vx, **kw):
        ys = F.scaled_dot_product_attention(qq, kx, vx, attn_mask=mask, scale=1.0, **kw)
        return lambda: torch.autograd.grad(ys, (qq, kk, vv), g, retain_graph=True)

    if kind == "mqa":
        forms = {"sdpa expanded": grad_form(kk[:, None].expand(b, h, j, d),
                                            vv[:, None].expand(b, h, j, d)),
                 "sdpa gqa": grad_form(kk[:, None], vv[:, None], enable_gqa=True)}
    else:
        forms = {"sdpa": grad_form(kk, vv)}
    row.update(_library(forms))
    if bias is not None:  # the biased forward (with the log-sum-exp) and its yardstick
        fwd = lambda: fa.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)  # noqa: E731
        row["fwd_ms"], row["fwd_device_ms"] = median_ms(fwd), device_ms(fwd)
        row["fwd_plain_ms"] = median_ms(lambda: plain(q, k, v, attn_bias=bias))
        row["fwd_library_ms"], row["fwd_library_device_ms"] = median_ms(lib), device_ms(lib)
        fwd_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + 4 * (b * h * n + b * j)
        row["fwd_bound_ms"] = _bound(fwd_bytes, 4 * b * h * n * j * d, name,
                                     exps=b * h * n * j)["bound_ms"]
    itemsize = q.element_size()
    # read q, k, v, o, do (and lse, bias); write dq, dk, dv; P rebuilt in
    # both passes: 2 b h n j exponentials
    nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * itemsize + 4 * b * h * n \
        + (0 if bias is None else 4 * b * j)
    row.update(_bound(nbytes, 10 * b * h * n * j * d, name, exps=2 * b * h * n * j))
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
    if DEVICE == "cuda":
        row["form"] = gn.plan_info(True, x, groups)["form"]
    call = lambda: gn.group_norm_backward_kernel(  # noqa: E731
        x, gamma, beta, scale, shift, mean, rstd, g, **kw)
    row["ms"] = median_ms(call)
    row["device_ms"] = device_ms(call)
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
        dev = (f" (device {r['device_ms']:.4f})" if "device_ms" in r else "")
        lib_dev = (f" (device {r['library_device_ms']:.4f}, {r['library_form']})"
                   if "library_device_ms" in r else "")
        log(f"  {r['kernel']:<19} {r['dtype']:<8} {str(tuple(r['shape'])):<28}"
            f"{' +bias' if r.get('bias') else ''}"
            f"{' ' + r['form'] if r.get('form') else ''} "
            f"max_abs_err {r['max_abs_err']:.3e} (limit {r['limit']:.3e}) "
            f"kernel {r['ms']:.4f}{dev} ms plain {r['plain_ms']:.4f} ms "
            f"library {lib if lib is None else round(lib, 4)}{lib_dev} ms "
            f"bound {r['bound_ms']:.4f} ms ({r.get('bound_detail', r['bound_by'])}"
            + (f"; exponentials {r['exp_bound_ms']:.4f}" if r.get("exp_bound_ms") else "")
            + f") {'ok' if ok else 'FAIL'}"
            + (f"; biased forward {r['fwd_ms']:.4f} (device {r['fwd_device_ms']:.4f}) ms plain "
               f"{r['fwd_plain_ms']:.4f} ms library {r['fwd_library_ms']:.4f} (device "
               f"{r['fwd_library_device_ms']:.4f}) ms bound {r['fwd_bound_ms']:.4f} ms"
               if "fwd_ms" in r else "")
            + (f"; F.group_norm channels-last, no scale-shift or SiLU (less work): device "
               f"{r['torch_group_norm_device_ms']:.4f} ms"
               if "torch_group_norm_device_ms" in r else ""))
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
    items, _ = traced(go, name="train")
    busy_ms = sum(us for _, us in items) / 1e3 / steps
    log(f"  train step: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
        f"({'not measured' if busy_ms == 0 else f'{100 * busy_ms / wall_ms:.0f}%'})")
    log("    kernels by family, device ms/step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in kernel_families(items, steps).items()))
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
    items = sorted(traced(go, name="stem_" + "x".join(map(str, shape)))[0],
                   key=lambda kv: -kv[1])
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
    results.update(default_solver_reference(models, embeds, masks))
    return results


def resized_copy(imagen, device, sizes):
    """A shallow copy of `imagen` that samples at `sizes` on `device` (its
    U-Nets must already be there): the schedules are made anew there."""
    import copy

    import torch
    from minimagen_tpu_torch.ops.diffusion import GaussianDiffusion

    out = copy.copy(imagen)
    out.device = torch.device(device)
    out.image_sizes = tuple(sizes)
    out.noise_schedulers = [GaussianDiffusion(s.num_timesteps, device)
                            for s in imagen.noise_schedulers]
    out.lowres_noise_schedule = GaussianDiffusion(imagen.lowres_noise_schedule.num_timesteps,
                                                  device)
    return out


def default_solver_reference(models, embeds, masks):
    """Short guided cascades of the default cascade at 16/32px, float32, on
    the card and on the CPU, each REFERENCE_SOLVERS solver with
    REFERENCE_SOLVER_KW (caching every 2nd step, the guidance rescale, the
    super-res stage truncated), every draw injected from numpy: each stage's
    output within REFERENCE_LIMIT relative L2."""
    import numpy as np
    import torch

    b = embeds.shape[0]
    rng = np.random.default_rng(SEED)
    draws = [rng.normal(size=(b, s, s, 3)).astype(np.float32) for s in (16, 32, 32)]
    results = {}
    for sampler, grid, steps in REFERENCE_SOLVERS:
        outs = {}
        for dev, model in models.items():
            it = iter(draws)
            small = resized_copy(model, dev, (16, 32))
            imgs = small.sample(text_embeds=embeds.to(dev), text_masks=masks.to(dev),
                                cond_scale=COND_SCALE, sampler=sampler, sample_steps=steps,
                                grid=grid, noise=lambda shape: torch.from_numpy(next(it)).to(dev),
                                return_all_stage_outputs=True, **REFERENCE_SOLVER_KW)
            outs[dev] = [im.float().cpu() for im in imgs]
        for stage, (got, want) in enumerate(zip(outs[DEVICE], outs["cpu"])):
            rel = float((got - want).norm() / want.norm())
            finite = bool(torch.isfinite(got).all())
            results[f"{sampler}_stage{stage}_rel_l2"] = rel
            log(f"  {sampler}@{grid} steps {steps} {REFERENCE_SOLVER_KW}: stage {stage} relative "
                f"L2 card f32 vs cpu f32 = {rel:.3e} (limit {REFERENCE_LIMIT}), finite {finite}")
            if not (finite and rel <= REFERENCE_LIMIT):
                raise PhaseError(f"default cascade {sampler} stage {stage} disagrees with the CPU")
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
                        sample_steps=SAMPLE_STEPS, cache_interval=None, generator=gen)
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


def serve_fast(imagen, captions, ddim_seconds):
    """DPM++-10 through both stages with cache_interval 'auto', the launch
    counts reset just before: images finite in [0, 1], every forward kernel
    launched, s/image beside DDIM-50's. Returns the launches."""
    import numpy as np
    import torch

    embeds, _ = imagen.encode_text(captions)
    log_cache_decisions(imagen, 2 * len(captions), embeds.shape[1])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out, launches, seconds = counted(lambda: imagen.sample(
        captions, cond_scale=COND_SCALE, sampler="dpmpp", sample_steps=SOLVER_STEPS,
        cache_interval="auto", generator=gen))
    arr = out.float().cpu().numpy()
    n = len(captions)
    log(f"  images {arr.shape} min {arr.min():.4f} max {arr.max():.4f} mean {arr.mean():.4f}; "
        f"{seconds / n:.3f} s/image against DDIM-{SAMPLE_STEPS} {ddim_seconds / n:.3f} "
        f"(host clock, synchronized)")
    log(f"  launches: {launches}")
    if arr.shape != (n, 128, 128, 3) or not np.isfinite(arr).all() \
            or not (arr.min() >= 0.0 and arr.max() <= 1.0):
        raise PhaseError(f"images {arr.shape} not finite in [0, 1]")
    require_launched(launches, "default DPM++ serving")
    return launches


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
    for name, (source, replaces, design) in {**KERNEL_INFO, **BACKWARD_INFO}.items():
        bf16 = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"]
        top = max(bf16, key=lambda r: r["bound_ms"])
        entry = dict(name=name, route="cuda", source=source, design=design, replaces=replaces,
                     launches=launches[name],
                     max_abs_err=top["max_abs_err"], ms=top["ms"],
                     plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                     bound_by=top["bound_by"], library_ms=top["library_ms"])
        for key in ("device_ms", "library_device_ms", "form"):  # device: 20 launches back to back
            if key in top:
                entry[key] = top[key]
        entries.append(entry)
        log(f"  {name}: numbers at {tuple(top['shape'])} bfloat16")
    return entries


# --------------------------------------------------------------------------- #
# quality rows on the committed weights (tools/flagship_quality_eval.py)       #
# --------------------------------------------------------------------------- #
def eval_sr(imagen):
    """``eval_sr`` (tools/flagship_quality_eval.py:384-408) through
    ``quality.sr_rows``: items 0, 1, 7 and 13 of the synthetic set at 256px,
    resized to 64px, super-resolved from start levels 0.2 and 0.4 (DDIM-50,
    cond_scale 3.0, no caching) at QUALITY_SEEDS generator seeds; the mean
    PSNR against the originals is held to its limit. The same seeds in
    float32 are logged beside it."""
    import numpy as np
    import torch
    from minimagen_tpu_torch.quality import mean_rows, sr_rows

    per_seed = [sr_rows(imagen, 3 + i, SAMPLE_STEPS, COND_SCALE) for i in range(QUALITY_SEEDS)]
    rows, failures = mean_rows(per_seed), []
    for level, (committed, committed_bicubic) in SR_COMMITTED.items():
        row = rows[f"sr/start{level}"]
        p, bicubic = row["psnr_db"], row["bicubic_baseline_db"]
        limit = bicubic if level == 0.2 else committed - SR_PSNR_SLACK_DB
        seeds = ", ".join(f"{r[f'sr/start{level}']['psnr_db']:.2f}" for r in per_seed)
        log(f"  sr/start{level}: {p:.2f} dB over {QUALITY_SEEDS} seeds ({seeds}), bicubic "
            f"{bicubic:.2f} dB (committed {committed} / {committed_bicubic}); limit: above "
            f"{limit:.2f} dB ({'the bicubic baseline' if level == 0.2 else 'the committed row less 1 dB'})")
        if not (row["finite"] and p > limit):
            failures.append(f"sr/start{level} {p:.2f} dB not above {limit:.2f}")
    # measurements, not checks, of the bf16 path's open loss at start 0.4
    # (ROADMAP section 3): the same seeds in float32 (TF32 is off), and both
    # dtypes on numpy draws that tests/test_torch_quality_witness.py
    # --sr-numpy gives the JAX package too
    from minimagen_tpu_torch.generate import load_lite

    f32 = load_lite(device=DEVICE, dtype=torch.float32)
    per_seed32 = [sr_rows(f32, 3 + i, SAMPLE_STEPS, COND_SCALE) for i in range(QUALITY_SEEDS)]
    for level in SR_COMMITTED:
        vals = [r[f"sr/start{level}"]["psnr_db"] for r in per_seed32]
        bf16 = rows[f"sr/start{level}"]["psnr_db"]
        log(f"  sr/start{level} in float32: {float(np.mean(vals)):.2f} dB over {QUALITY_SEEDS} "
            f"seeds ({', '.join(f'{v:.2f}' for v in vals)}); bf16 {bf16:.2f} dB")
    for seed in SR_NUMPY_SEEDS:
        same = {name: sr_rows(m, seed, SAMPLE_STEPS, COND_SCALE, numpy_draws=True)
                for name, m in (("bf16", imagen), ("float32", f32))}
        log(f"  numpy draws seeded {seed}: " + "; ".join(
            f"sr/start{level} bf16 {same['bf16'][f'sr/start{level}']['psnr_db']:.2f} / float32 "
            f"{same['float32'][f'sr/start{level}']['psnr_db']:.2f} dB" for level in SR_COMMITTED))
    del f32
    if failures:
        raise PhaseError("; ".join(failures))
    return rows


def eval_holdout(imagen):
    """``eval_holdout`` (tools/flagship_quality_eval.py:320-356) through
    ``quality.holdout_rows``: 8 captions cycling through the trained combos,
    then through the 3 held-out ones; the base stage alone and the cascade
    truncated at 0.2 (DDIM-50, cond_scale 3.0, no caching) at QUALITY_SEEDS
    generator seeds; the mean colour distances held to COLOR_LIMIT."""
    from minimagen_tpu_torch.generate import LITE_CKPT_DIR
    from minimagen_tpu_torch.quality import holdout_rows, mean_rows

    with open(os.path.join(LITE_CKPT_DIR, "eval", "metrics.json")) as f:
        held = json.load(f)["_config"]["held_combos"]
    per_seed = [holdout_rows(imagen, held, 23 + i, SAMPLE_STEPS, COND_SCALE)
                for i in range(QUALITY_SEEDS)]
    rows, failures = mean_rows(per_seed), []
    for tag, (cb, cc) in HOLDOUT_COMMITTED.items():
        row = rows[f"holdout/{tag}"]
        mb, mc = row["base64_color_dist"], row["trunc_cascade_color_dist"]
        seeds = ", ".join(f"{r[f'holdout/{tag}']['base64_color_dist']:.4f} / "
                          f"{r[f'holdout/{tag}']['trunc_cascade_color_dist']:.4f}" for r in per_seed)
        log(f"  holdout/{tag}: base {mb:.4f} (committed {cb}), truncated {mc:.4f} (committed "
            f"{cc}) over {QUALITY_SEEDS} seeds ({seeds}); limit {COLOR_LIMIT}, margins "
            f"{COLOR_LIMIT - mb:.4f} / {COLOR_LIMIT - mc:.4f} ({row['captions']})")
        for name, value in (("base", mb), ("truncated", mc)):
            if not (row["finite"] and value <= COLOR_LIMIT):
                failures.append(f"holdout/{tag} {name} colour distance {value:.4f}")
    if failures:
        raise PhaseError("; ".join(failures))
    return rows


def eval_trunc(imagen, captions, level=0.4, committed=0.037):
    """``trunc/sr0.4``: the cascade truncated at 0.4 on the eval captions
    (``quality.trunc_row``, DDIM-50, no caching) at QUALITY_SEEDS seeds;
    the mean colour distance held to COLOR_LIMIT."""
    from minimagen_tpu_torch.quality import mean_rows, trunc_row

    per_seed = [trunc_row(imagen, captions, level, SEED + 30 + i, SAMPLE_STEPS, COND_SCALE)
                for i in range(QUALITY_SEEDS)]
    row = mean_rows(per_seed)[f"trunc/sr{level}"]
    seeds = ", ".join(f"{r[f'trunc/sr{level}']['color_dist']:.4f}" for r in per_seed)
    log(f"  trunc/sr{level}: color_dist {row['color_dist']:.4f} over {QUALITY_SEEDS} seeds "
        f"({seeds}; limit {COLOR_LIMIT}, committed {committed}) grad_mean {row['grad_mean']:.4f}")
    if not (row["finite"] and row["color_dist"] <= COLOR_LIMIT):
        raise PhaseError(f"trunc/sr{level} colour distance {row['color_dist']:.4f}")
    return row


def check_dropped_rows():
    """Every forward and backward attention kernel on a batch whose sample 1
    drops every key (the others about a quarter), bfloat16 and float32,
    against the plain versions, at the limits of the other checks: the
    dropped rows attend uniformly, P = 1/j per key. Returns the rows."""
    import torch
    from minimagen_tpu_torch.ops import attention as attn
    from minimagen_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    rows = []
    for kind, (b, h, n, j) in (("mqa", (3, 8, 1024, 1025)), ("mqa", (3, 8, 64, 65)),
                               ("mha", (3, 8, 1024, 259)), ("mha", (3, 8, 256, 261)),
                               ("mha", (3, 8, 100, 7))):
        for dtype in (torch.bfloat16, torch.float32):
            kv_shape = (b, j, 64) if kind == "mqa" else (b, h, j, 64)
            q = (torch.randn(b, h, n, 64, generator=gen, device=DEVICE) / 8.0).to(dtype)
            k, v = (torch.randn(kv_shape, generator=gen, device=DEVICE).to(dtype) for _ in "kv")
            g = torch.randn(b, h, n, 64, generator=gen, device=DEVICE).to(dtype)
            keep = torch.rand(b, j, generator=gen, device=DEVICE) >= 0.25
            keep[:, 0] = True
            keep[1] = False
            bias = attn.mask_bias(keep)
            plain, plain_bwd = fa._PLAIN[kind]
            out, lse = fa.attention_forward_kernel(kind, q, k, v, bias, with_lse=True)
            grads = fa.attention_backward_kernel(kind, q, k, v, bias, out, g, lse)
            refs = (plain(q, k, v, attn_bias=bias), *plain_bwd(q, k, v, g, attn_bias=bias))
            sync()
            name = str(dtype).split(".")[-1]
            err, lim = _worst(list(zip((out, *grads), refs)), name)
            rows.append(dict(kind=kind, shape=[b, h, n, j], dtype=name, max_abs_err=err,
                             limit=lim))
            log(f"  {kind} {(b, h, n, j)} {name}, sample 1 fully dropped: forward and backward "
                f"max_abs_err {err:.3e} (limit {lim:.3e}) {'ok' if err <= lim else 'FAIL'}")
    if any(r["max_abs_err"] > r["limit"] for r in rows):
        raise PhaseError("an attention kernel disagrees with the plain version on dropped rows")
    return rows


# --------------------------------------------------------------------------- #
# the harness and the CLIs on the lite cascade                                 #
# --------------------------------------------------------------------------- #
def read_png(path):
    """An 8-bit RGB PNG as written by ``generate.write_png`` (filter 0 on
    every row) -> (h, w, 3) uint8; the card has no imaging library."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise PhaseError(f"{path} is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if (depth, color) != (8, 2):
                raise PhaseError(f"{path}: not 8-bit RGB")
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(size[0], 1 + 3 * size[1])
    if rows[:, 0].any():
        raise PhaseError(f"{path}: row filters other than 0")
    return rows[:, 1:].reshape(size[0], size[1], 3)


def write_lite_parameters(dest):
    """A parameters/ directory of the lite cascade: its U-Net configs
    (``generate.lite_unet_configs``), its Imagen config and the flags the
    committed run was trained with."""
    from minimagen_tpu_torch.generate import lite_unet_configs
    from minimagen_tpu_torch.training import imagen_config_dict

    os.makedirs(dest)
    for i, cfg in enumerate(lite_unet_configs()):
        with open(os.path.join(dest, f"unet_{i}_params_lite.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=4)
    with open(os.path.join(dest, "imagen_params_lite.json"), "w") as f:
        json.dump(imagen_config_dict(dict(image_sizes=[HARNESS_SIDE // 4, HARNESS_SIDE],
                                          timesteps=1000,
                                          cond_drop_prob=0.1, text_encoder_name="t5_tiny")),
                  f, indent=4)
    with open(os.path.join(dest, "training_parameters_lite.txt"), "w") as f:
        f.write(f"--MAX_NUM_WORDS=16\n--IMG_SIDE_LEN={HARNESS_SIDE}\n--T5_NAME=t5_tiny\n"
                "--TIMESTEPS=1000\n")


def run_cli(module, args, cwd):
    """``python -m minimagen_tpu_torch.<module> args`` in `cwd`; returns the
    JSON object of its last output line and its seconds. Its output goes to
    the log."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", f"minimagen_tpu_torch.{module}", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=HARNESS_TIMEOUT_S)
    seconds = time.time() - t0
    if _log_file is not None:
        _log_file.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        log(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise PhaseError(f"{module} exited {proc.returncode}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise PhaseError(f"{module} printed no summary line")
    return json.loads(lines[-1]), seconds


def _finite_losses(summary):
    import numpy as np

    vals = [v for h in summary["history"] for key in ("train", "valid", "batch_train")
            for v in h[key]]
    return bool(vals) and bool(np.isfinite(vals).all())


def harness_phase(captions):
    """The lite cascade through the port's CLIs: train (``-p`` a written
    parameters/ directory, 32 steps), restart with ``-rd`` for one more
    epoch, sample the eval captions with the inference CLI; then the same
    samples from ``Imagen.sample`` in this process with the directory's
    weights, seed and arguments (torch's default TF32 settings, as the CLI
    runs); and ``train_lite``'s host ms per step at the same recipe.
    Returns the launch counts of the three CLI runs."""
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch
    from minimagen_tpu_torch.generate import load_minimagen
    from minimagen_tpu_torch.models.imagen import to_uint8
    from minimagen_tpu_torch.training import train_lite

    work = tempfile.mkdtemp(prefix="harness_", dir=os.path.join(REPO, "build"))
    try:
        params = os.path.join(work, "parameters")
        write_lite_parameters(params)
        first, t_first = run_cli("train", ["-p", params, *HARNESS_TRAIN_ARGS, "-ts", "lite_a",
                                           "--DEVICE", DEVICE], work)
        second, t_second = run_cli("train", ["-rd", "training_lite_a", *HARNESS_TRAIN_ARGS,
                                             "-ts", "lite_b", "--DEVICE", DEVICE], work)
        cap_file = os.path.join(work, "captions.txt")
        with open(cap_file, "w") as f:
            f.writelines(f"{c}\n" for c in captions)
        infer, t_infer = run_cli("inference", ["-d", "training_lite_b", "-c", cap_file,
                                               *HARNESS_INFER_ARGS, "--DEVICE", DEVICE], work)
        failures = []
        for name, summary, seconds in (("train", first, t_first), ("restart", second, t_second)):
            s = summary["summary"]
            perf = s["perf"]
            log(f"  {name}: {seconds:.1f} s, steps {s['start_step']} -> {s['final_step']}, Adam "
                f"count {s['start_adam_count']} -> {s['adam_count']}, train step "
                f"{perf['steps_per_sec']:.3f} steps/s ({1e3 * perf['mean_s']:.1f} ms), loader "
                f"wait {s['loader_s']:.2f} s; history " + json.dumps(s["history"]))
            if not _finite_losses(s):
                failures.append(f"{name}: a loss is not finite")
            log_text = open(os.path.join(summary["training_directory"],
                                         "training_progess.txt")).read()
            for needle in ("Checkpoint created at batch number 0", "U-Nets Avg Valid Losses",
                           "Train steps/sec"):
                if needle not in log_text:
                    failures.append(f"{name}: training_progess.txt lacks {needle!r}")
            caught = [ln for ln in log_text.splitlines() if any(f in ln for f in HARNESS_FAULTS)]
            if caught:
                failures.append(f"{name}: training_progess.txt reports {caught}")
            validated = [h["batch"] for h in s["history"]]
            if validated != list(range(0, HARNESS_STEPS, HARNESS_CHCKPT_NUM)):
                failures.append(f"{name}: validations at batches {validated}")
        s1, s2 = first["summary"], second["summary"]
        if s1["final_step"] != HARNESS_STEPS or s2["final_step"] != 2 * HARNESS_STEPS:
            failures.append(f"the runs ended at steps {s1['final_step']} and {s2['final_step']}, "
                            f"not {HARNESS_STEPS} and {2 * HARNESS_STEPS}")
        if not (s2["start_step"] == s1["final_step"] and s2["start_adam_count"] == s2["start_step"]
                and s2["final_step"] == s2["adam_count"]):
            failures.append(f"the restart did not resume at step {s1['final_step']}")
        pngs = sorted(glob.glob(os.path.join(work, "generated_images_*", "generated_images",
                                             "image_*.png")),
                      key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
        images = np.stack([read_png(p) for p in pngs]) if pngs else None
        log(f"  inference: {t_infer:.1f} s, {len(pngs)} PNGs "
            f"{None if images is None else images.shape}")
        if images is None or images.shape != (len(captions), HARNESS_SIDE, HARNESS_SIDE, 3):
            failures.append(f"inference wrote {len(pngs)} PNGs")
        else:
            prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
            try:
                imagen = load_minimagen(os.path.join(work, "training_lite_b"), device=DEVICE)
                gen = torch.Generator(device=DEVICE).manual_seed(0)
                direct = imagen.sample(texts=captions, cond_scale=COND_SCALE, sampler="ddim",
                                       sample_steps=SAMPLE_STEPS, grid="time", generator=gen)
                direct = to_uint8(direct.float().cpu().numpy())
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
            diff = int((direct != images).sum())
            log(f"  the CLI's pixels against Imagen.sample's, same weights, seed and arguments: "
                f"{diff} of {images.size} differ")
            if diff:
                failures.append(f"{diff} pixels differ from Imagen.sample")
            del imagen
        run = train_lite(16, TRAIN_BATCH, mu_dtype=torch.bfloat16, device=DEVICE)
        for name, s in (("train", s1), ("restart", s2)):
            perf = s["perf"]
            loop_s = perf["mean_s"] + s["loader_s"] / max(s["final_step"] - s["start_step"], 1)
            log(f"  MinimagenTrain ({name}): {perf['steps_per_sec']:.3f} steps/s of the train step "
                f"({1e3 * perf['mean_s']:.1f} ms), {1.0 / loop_s:.3f} steps/s with the loader's "
                f"wait ({1e3 * loop_s:.1f} ms); train_lite at the same recipe (bf16 first moment, "
                f"16 steps, staged batches): {run.host_ms_per_step:.1f} ms/step, "
                f"{1e3 / run.host_ms_per_step:.3f} steps/s")
        del run
        if failures:
            raise PhaseError("; ".join(failures))
        return {"harness train": first["launches"], "harness restart": second["launches"],
                "harness inference": infer["launches"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------------------- #
# the multi-device modes: world 1 over NCCL, two processes sharing the card  #
# --------------------------------------------------------------------------- #
def _mesh_imagen(dtype):
    """The lite cascade from a fresh init (seed 0): float32 masters, `dtype`
    compute, t5_tiny, as train_lite builds it."""
    import torch
    from minimagen_tpu_torch.generate import lite_imagen

    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(SEED)
        return lite_imagen("t5_tiny", dtype=dtype, param_dtype=torch.float32, device=DEVICE)


def mesh_train_modes(mesh, dtype, steps, timed=0, order=("one", "off", "on", "fsdp")):
    """`steps` train steps of the lite cascade at batch MESH_BATCH (this
    process's rows on the mesh) in each mode of `order`: one device on the
    whole batch, off (data parallel), on (ZeRO-1) or fsdp on `mesh`. Each
    run starts from the same init, Adam with a bf16 first moment (the
    committed recipe) and the EMA; per mode, a list of its runs' losses,
    whole parameters and EMA (float32, on the card), the state's bytes and
    the plan's reckoning of them, the peak bytes the run allocated above
    what the process held before it, and host ms per step over the last
    `timed` steps. Mode tp is tensor parallelism over the mesh's model axis
    (the default rule). The launch counts are the mesh modes' runs only,
    each counted from 0."""
    import torch
    from minimagen_tpu_torch.ops import kernels
    from minimagen_tpu_torch.parallel import mesh as pmesh
    from minimagen_tpu_torch.training import (
        DATA_SEED, create_train_state, make_optimizer, make_train_step, state_bytes)

    batch = {k: v.to(DEVICE) for k, v in _train_batch(MESH_BATCH).items()}
    out, launches = {}, {}
    for mode in order:
        sync()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        imagen = _mesh_imagen(dtype)
        on_mesh = mode != "one"
        plan = {"on": pmesh.zero1_plan, "fsdp": pmesh.fsdp_plan,
                "tp": pmesh.replicated_plan}.get(mode)
        opt = make_optimizer(1e-4, mu_dtype=torch.bfloat16)
        state = create_train_state(imagen, opt, ema=True, mesh=mesh if on_mesh else None,
                                   plan=plan(imagen.unets, mesh) if plan else None)
        step = make_train_step(imagen, opt, ema_decay=EMA_DECAY, mesh=mesh if on_mesh else None)
        rows = pmesh.shard_batch(batch, mesh) if on_mesh else batch
        nbytes = state_bytes(state)
        reckoned = pmesh.reckon_state_bytes(state.shapes, state.plan, state.mesh, mu_bytes=2)
        kernels.reset_launch_counts()
        losses, t0 = [], None
        for i in range(steps):
            if i == steps - timed:
                sync()
                t0 = time.perf_counter()
            state, l_ = step(state, rows, seed=DATA_SEED)
            losses.append(l_)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / timed if timed else None
        if on_mesh:
            launches[f"{mode} {len(out.get(mode, []))}"] = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - before
        whole = lambda ts: torch.cat([t.reshape(-1).float() for t in pmesh.full_tensors(  # noqa: E731
            ts, state.plan, state.mesh, state.shapes)])
        out.setdefault(mode, []).append(dict(
            losses=torch.stack(losses).float(), params=whole(state.local_params()),
            ema=whole(state.ema_params), bytes=nbytes, reckoned=reckoned, peak=peak, ms=ms))
        del imagen, state, step
        torch.cuda.empty_cache()
    return out, launches


def mesh_world1(imagen, captions):
    """M1: a world of one process over NCCL on cuda:0. Every collective
    against its expected value; the lite train step under off, on and fsdp
    against the one-device step, and ``sample(mesh=)`` against ``sample()``,
    each to the bit; host ms per step beside the one-device step's."""
    import torch
    import torch.distributed as dist
    from minimagen_tpu_torch.ops import kernels
    from minimagen_tpu_torch.parallel import collectives
    from minimagen_tpu_torch.parallel import mesh as pmesh

    group = collectives.init_process(0, 1, backend="nccl", device="cuda:0", store=dist.HashStore())
    try:
        mesh = pmesh.make_mesh(group)
        log(f"  backend {group.backend}, world {group.size}, device {group.device}")
        x = torch.arange(12, dtype=torch.float32, device=DEVICE)
        got = {"all_reduce": collectives.all_reduce(x.clone(), group),
               "reduce_scatter": collectives.reduce_scatter(torch.empty_like(x), x.clone(), group),
               "all_gather": collectives.all_gather(torch.empty_like(x), x, group),
               "broadcast": collectives.broadcast(x.clone(), group)}
        bad = [k for k, v in got.items() if not torch.equal(v, x)]
        if collectives.broadcast_object({"a": 1}, group) != {"a": 1}:
            bad.append("broadcast_object")
        collectives.barrier(group)
        if bad:
            raise PhaseError(f"NCCL collectives at world 1 gave wrong values: {bad}")
        runs, launches = mesh_train_modes(mesh, torch.bfloat16, MESH_STEPS, MESH_TIMED_STEPS,
                                          order=MESH_TIMING_ORDER)
        one = runs["one"][0]
        for mode in ("one", "off", "on", "fsdp"):
            same = [k for k in ("losses", "params", "ema")
                    if all(torch.equal(r[k], one[k]) for r in runs[mode])]
            ms = ", ".join(f"{r['ms']:.1f}" for r in runs[mode])
            peak = ", ".join(f"{r['peak'] / 1e9:.3f}" for r in runs[mode])
            name = "one device" if mode == "one" else f"--ZERO1 {mode}"
            log(f"  {name}: equal bits {same}; host ms/step {ms} (runs in the order "
                f"{'/'.join(MESH_TIMING_ORDER)}); state {one['bytes'] / 1e9:.3f} GB at rest, "
                f"peak GB allocated in the steps {peak}")
            if len(same) != 3:
                raise PhaseError(f"mesh step ({mode}) at world 1 differs from the one-device step")
        kw = dict(cond_scale=COND_SCALE, sampler="ddim", sample_steps=MESH_SAMPLE_STEPS,
                  sr_start_noise_levels=0.2, cache_interval=None)
        embeds, masks = imagen.encode_text(captions)
        kernels.reset_launch_counts()
        got = imagen.sample(text_embeds=embeds, text_masks=masks, mesh=mesh,
                            generator=torch.Generator(device=DEVICE).manual_seed(SEED), **kw)
        sync()
        launches["sample(mesh=)"] = dict(kernels.LAUNCHES)
        want = imagen.sample(text_embeds=embeds, text_masks=masks,
                             generator=torch.Generator(device=DEVICE).manual_seed(SEED), **kw)
        log(f"  sample(mesh=) {tuple(got.shape)}: equal bits {torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise PhaseError("sample(mesh=) at world 1 differs from sample()")
        total = {k: sum(c[k] for c in launches.values()) for k in kernels.LAUNCHES}
        log(f"  launches of the mesh calls (the one-device runs not counted): {total}")
        require_launched(total, "mesh world 1", names=tuple(KERNEL_INFO) + tuple(BACKWARD_INFO))
        return total
    finally:
        collectives.destroy()


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def mesh_rank(group, captions):
    """M2, in each of two processes sharing cuda:0 over gloo: the float32
    steps against the one-device step, the per-process state bytes, bf16
    ``sample(mesh=)`` and its float32 twin against ``sample()``, and the
    pipelined server (stage 0 on process 0, stage 1 on process 1) in bf16
    and float32. Returns numbers; the parent holds them to their limits.
    The launches are those of the mesh calls alone (the off/on/fsdp steps,
    ``sample(mesh=)``, ``serve``), each counted from 0: the one-device
    step and the ``sample()`` references are not counted."""
    import torch
    from minimagen_tpu_torch.generate import load_lite
    from minimagen_tpu_torch.ops import kernels
    from minimagen_tpu_torch.parallel import cascade, pipeline
    from minimagen_tpu_torch.parallel import mesh as pmesh
    from minimagen_tpu_torch.quality import color_metric

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = pmesh.make_mesh(group)
    out = {"rank": mesh.rank}
    runs, launches = mesh_train_modes(mesh, torch.float32, MESH_F32_STEPS)
    runs = {m: r[0] for m, r in runs.items()}
    one = runs["one"]
    out["train"] = {m: dict(loss_rtol=float(((r["losses"] - one["losses"]).abs()
                                            / one["losses"].abs()).max()),
                            params=_rel(r["params"], one["params"]), ema=_rel(r["ema"], one["ema"]),
                            bytes=r["bytes"], peak=r["peak"])
                    for m, r in runs.items() if m != "one"}
    out["train"]["one"] = dict(bytes=one["bytes"], peak=one["peak"])

    gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)  # noqa: E731
    kw = dict(cond_scale=COND_SCALE, sampler="ddim", sample_steps=SAMPLE_STEPS,
              sr_start_noise_levels=0.2, cache_interval=None)
    for dtype in (torch.bfloat16, torch.float32):
        imagen = load_lite(device=DEVICE, dtype=dtype)
        embeds, masks = imagen.encode_text(captions)
        kernels.reset_launch_counts()
        base, final = imagen.sample(text_embeds=embeds, text_masks=masks, mesh=mesh,
                                    generator=gen(), return_all_stage_outputs=True, **kw)
        sync()
        launches[f"sample(mesh=) {dtype}"] = dict(kernels.LAUNCHES)
        if dtype == torch.bfloat16:
            out["sample_bf16"] = dict(
                base=color_metric(base.float().cpu().numpy(), captions),
                trunc=color_metric(final.float().cpu().numpy(), captions),
                finite=bool(torch.isfinite(final).all()), shape=tuple(final.shape))
        else:
            want = imagen.sample(text_embeds=embeds, text_masks=masks, generator=gen(), **kw)
            out["sample_f32"] = dict(rel=_rel(final, want), equal=bool(torch.equal(final, want)))
        # the pipelined server: stage s on process s, two requests of 4 captions
        server = pipeline.CascadePipelineServer(imagen, cascade.make_stage_meshes(2),
                                                cond_scale=COND_SCALE, sampler="ddim",
                                                sample_steps=SAMPLE_STEPS, cache_interval=None,
                                                sr_start_noise_levels=0.2, depth=2)
        half = len(captions) // 2
        reqs = [dict(text_embeds=embeds[i * half:(i + 1) * half],
                     text_masks=masks[i * half:(i + 1) * half], seed=SEED + i) for i in range(2)]
        kernels.reset_launch_counts()
        served = list(server.serve(reqs))
        sync()
        launches[f"pipeline {dtype}"] = dict(kernels.LAUNCHES)
        if server.stage == 1:
            images = torch.cat(served)
            if dtype == torch.bfloat16:
                out["pipeline_bf16"] = dict(color=color_metric(images.float().cpu().numpy(), captions),
                                            finite=bool(torch.isfinite(images).all()))
            else:
                want = torch.cat([imagen.sample(text_embeds=r["text_embeds"],
                                                text_masks=r["text_masks"],
                                                generator=torch.Generator(device=DEVICE)
                                                .manual_seed(r["seed"]), **kw) for r in reqs])
                out["pipeline_f32"] = dict(rel=_rel(images, want),
                                           equal=bool(torch.equal(images, want)))
        del imagen, server
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(c[k] for c in launches.values()) for k in kernels.LAUNCHES}
    return out


def reckoned_state_bytes(imagen, world):
    """Per-process bytes of float32 parameters, a bf16 first moment, float32
    second moment and float32 EMA under off, on (ZeRO-1) and fsdp at data
    size `world`, and under tensor parallelism over a model axis of
    `world` (tp), from the plans over the U-Nets' shapes (no process)."""
    import torch
    from minimagen_tpu_torch.parallel import mesh as pmesh
    from minimagen_tpu_torch.parallel.collectives import Group

    cpu = torch.device("cpu")
    data = pmesh.Mesh(Group(None, tuple(range(world)), 0, "gloo", cpu))
    model = pmesh.Mesh(Group(None, (0,), 0, "gloo", cpu),
                       Group(None, tuple(range(world)), 0, "gloo", cpu),
                       Group(None, tuple(range(world)), 0, "gloo", cpu))
    shapes = [p.shape for u in imagen.unets for p in u.parameters()]
    plans = {"off": (None, None), "on": (pmesh.zero1_plan(imagen.unets, data), data),
             "fsdp": (pmesh.fsdp_plan(imagen.unets, data), data),
             "tp": (pmesh.replicated_plan(imagen.unets, model), model)}
    return {mode: pmesh.reckon_state_bytes(shapes, plan, mesh, mu_bytes=2)
            for mode, (plan, mesh) in plans.items()}


def mesh_two_processes(captions):
    """M2: two processes on the one card (gloo, collectives staged through
    the host); each one's numbers held to the CPU tests' tolerances and the
    colour limit."""
    import torch
    from minimagen_tpu_torch.parallel import collectives

    ranks = collectives.spawn("chip_smoke:mesh_rank", 2, (captions,), backend="gloo",
                              devices=["cuda:0", "cuda:0"], timeout=MESH_TIMEOUT_S, echo=log)
    failures = []
    for r in ranks:
        tag = f"  rank {r['rank']}:"
        for mode, t in r["train"].items():
            name = "one device" if mode == "one" else f"--ZERO1 {mode}"
            line = (f"{tag} {name}: params + moments + EMA {t['bytes'] / 1e9:.3f} GB at rest, "
                    f"peak {t['peak'] / 1e9:.3f} GB allocated in the steps")
            if mode != "one":
                line += (f" ({t['bytes'] / r['train']['off']['bytes']:.3f} of off); float32 "
                         f"against one device: loss {t['loss_rtol']:.2e} (limit {MESH_LOSS_RTOL}), "
                         f"params {t['params']:.2e}, EMA {t['ema']:.2e} rel L2 "
                         f"(limit {MESH_PARAM_REL})")
                if not (t["loss_rtol"] <= MESH_LOSS_RTOL and t["params"] <= MESH_PARAM_REL
                        and t["ema"] <= MESH_PARAM_REL):
                    failures.append(f"rank {r['rank']} {mode} step")
            log(line)
        s = r["sample_bf16"]
        log(f"{tag} bf16 sample(mesh=) {s['shape']}: base color_dist {s['base']:.4f}, "
            f"trunc/sr0.2 {s['trunc']:.4f} (limit {COLOR_LIMIT}); float32 against sample(): "
            f"{r['sample_f32']['rel']:.2e} rel L2 (limit {REFERENCE_LIMIT}), equal bits "
            f"{r['sample_f32']['equal']}")
        if not (s["finite"] and s["base"] <= COLOR_LIMIT and s["trunc"] <= COLOR_LIMIT
                and r["sample_f32"]["rel"] <= REFERENCE_LIMIT):
            failures.append(f"rank {r['rank']} sample(mesh=)")
        if "pipeline_bf16" in r:
            p, q = r["pipeline_bf16"], r["pipeline_f32"]
            log(f"{tag} pipeline bf16 color_dist {p['color']:.4f} (limit {COLOR_LIMIT}); float32 "
                f"against Imagen.sample {q['rel']:.2e} rel L2 (limit {REFERENCE_LIMIT}), "
                f"equal bits {q['equal']}")
            if not (p["finite"] and p["color"] <= COLOR_LIMIT and q["rel"] <= REFERENCE_LIMIT):
                failures.append("the pipelined server")
        log(f"{tag} launches {r['launches']}")
        require_launched(r["launches"], f"rank {r['rank']}",
                         names=tuple(KERNEL_INFO) + tuple(BACKWARD_INFO))
    if not any("pipeline_bf16" in r for r in ranks):
        failures.append("no process ran the pipeline's last stage")
    from minimagen_tpu_torch.generate import default_imagen, lite_imagen

    with torch.device("meta"):  # shapes only
        shapes = (("lite", lite_imagen(device="meta")), ("default", default_imagen(device="meta")))
    for name, imagen in shapes:
        n = sum(p.numel() for u in imagen.unets for p in u.parameters())
        want = reckoned_state_bytes(imagen, 2)
        log(f"  reckoned per process at 2 processes, {name} cascade ({n / 1e6:.1f}M parameters): "
            + ", ".join(f"{m} {b / 1e9:.3f} GB" for m, b in want.items()))
        want.pop("tp")  # M3's
        if name == "lite":
            measured = {m: ranks[0]["train"][m]["bytes"] for m in want}
            if measured != want:
                failures.append(f"measured state bytes {measured} differ from the plan's {want}")
    if failures:
        raise PhaseError("; ".join(failures))
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def _whole_state(state):
    """Every kind of `state` (parameters, moments, EMA) whole, float32, on
    the card (every process of its mesh takes part)."""
    from minimagen_tpu_torch.parallel import mesh as pmesh

    opt = state.opt_state
    kinds = {"params": state.local_params(), "mu": opt.mu, "nu": opt.nu, "ema": state.ema_params}
    return {k: [t.float() for t in pmesh.full_tensors(ts, state.plan, state.mesh, state.shapes)]
            for k, ts in kinds.items()}


def mesh_tp_rank(group, captions, dump_dir):
    """M3, in each of two processes sharing cuda:0 over gloo, on the mesh
    {data 1, model 2} (tensor parallelism by the default rule): the float32
    lite train step against the one-device step and the state's bytes
    against the plan's reckoning; a sharded dump written on {data 2} and
    restored on {model 2}; ``sample(mesh=)`` of the lite cascade, bf16
    colour and float32 against ``sample()``; each default-cascade stage's
    float32 guided forward, placed over the model axis, against the same
    seeded weights on one device. Returns numbers; the parent holds them.
    The launches are those of the tensor-parallel calls alone, each counted
    from 0."""
    import gc

    import torch
    from minimagen_tpu_torch.generate import default_imagen, load_lite
    from minimagen_tpu_torch.ops import kernels
    from minimagen_tpu_torch.parallel import checkpoint as pckpt
    from minimagen_tpu_torch.parallel import mesh as pmesh
    from minimagen_tpu_torch.parallel import tensor
    from minimagen_tpu_torch.quality import color_metric
    from minimagen_tpu_torch.training import (
        DATA_SEED, create_train_state, make_optimizer, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data_mesh = pmesh.make_mesh(group)  # {data 2}
    mesh = pmesh.make_mesh(group, model_parallel=2)  # {data 1, model 2}
    out = {"rank": mesh.world.rank, "shape": mesh.shape, "seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        sync()
        out["seconds"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    runs, launches = mesh_train_modes(mesh, torch.float32, MESH_F32_STEPS, order=("one", "tp"))
    one, tp = runs["one"][0], runs["tp"][0]
    out["train"] = dict(loss_rtol=float(((tp["losses"] - one["losses"]).abs()
                                         / one["losses"].abs()).max()),
                        params=_rel(tp["params"], one["params"]), ema=_rel(tp["ema"], one["ema"]),
                        bytes=tp["bytes"], reckoned=tp["reckoned"], one_bytes=one["bytes"],
                        peak=tp["peak"])
    lap("train")

    # a dump of {data 2} (ZeRO-1, after one step) restored on {model 2}
    batch = {k: v.to(DEVICE) for k, v in _train_batch(MESH_BATCH).items()}
    opt = make_optimizer(1e-4, mu_dtype=torch.bfloat16)
    imagen = _mesh_imagen(torch.float32)
    state = create_train_state(imagen, opt, ema=True, mesh=data_mesh,
                               plan=pmesh.zero1_plan(imagen.unets, data_mesh))
    step = make_train_step(imagen, opt, ema_decay=EMA_DECAY, mesh=data_mesh)
    state, _ = step(state, pmesh.shard_batch(batch, data_mesh), seed=DATA_SEED)
    pckpt.save_sharded_state(dump_dir, state)
    want = _whole_state(state)
    del imagen, state, step
    imagen = _mesh_imagen(torch.float32)
    state = create_train_state(imagen, opt, ema=True, mesh=mesh)
    pckpt.load_sharded_state(dump_dir, state)
    got = _whole_state(state)
    out["dump"] = dict(step=state.step, split=sum(a is not None for a in state.plan.model_axes),
                       equal={k: all(torch.equal(a, b) for a, b in zip(got[k], want[k]))
                              for k in want})
    del imagen, state, got, want
    torch.cuda.empty_cache()
    lap("dump")

    gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)  # noqa: E731
    for dtype, steps in ((torch.bfloat16, SAMPLE_STEPS), (torch.float32, MESH_SAMPLE_STEPS)):
        kw = dict(cond_scale=COND_SCALE, sampler="ddim", sample_steps=steps,
                  sr_start_noise_levels=0.2, cache_interval=None)
        imagen = load_lite(device=DEVICE, dtype=dtype)
        embeds, masks = imagen.encode_text(captions)
        ref = imagen.sample(text_embeds=embeds, text_masks=masks, generator=gen(), **kw)
        kernels.reset_launch_counts()
        base, final = imagen.sample(text_embeds=embeds, text_masks=masks, mesh=mesh,
                                    generator=gen(), return_all_stage_outputs=True, **kw)
        sync()
        launches[f"sample(mesh=) {dtype}"] = dict(kernels.LAUNCHES)
        split = sum(tensor.is_placed(m) for u in imagen.unets for m in u.modules()
                    if not list(m.children()))
        if dtype == torch.bfloat16:
            out["sample_bf16"] = dict(
                base=color_metric(base.float().cpu().numpy(), captions),
                trunc=color_metric(final.float().cpu().numpy(), captions),
                finite=bool(torch.isfinite(final).all()), shape=tuple(final.shape), split=split)
        else:
            out["sample_f32"] = dict(rel=_rel(final, ref), equal=bool(torch.equal(final, ref)))
        del imagen, ref, base, final
        torch.cuda.empty_cache()
        lap(f"sample {dtype}")

    # the default cascade at full width: one guided forward per stage
    big = default_imagen(device=DEVICE, seed=SEED, dtype=torch.float32)
    embeds, masks = big.encode_text(captions[:1])
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    inputs = []
    for stage, size in enumerate(big.image_sizes):
        x = torch.randn(1, size, size, 3, generator=g, device=DEVICE)
        low = torch.rand(1, size, size, 3, generator=g, device=DEVICE) if stage else None
        inputs.append(dict(x=x, low=low))

    def forward(stage):
        x, low = inputs[stage]["x"], inputs[stage]["low"]
        with torch.inference_mode():
            return big._cfg_forward(
                stage, x, torch.full((1,), 500, device=DEVICE), text_embeds=embeds,
                text_mask=masks, lowres_cond_img=low,
                lowres_noise_times=torch.full((1,), 200, device=DEVICE) if stage else None,
                cond_scale=COND_SCALE)

    whole = [forward(stage) for stage in range(big.num_unets)]
    full_bytes = sum(p.numel() * p.element_size() for p in big.unets.parameters())
    placed = tensor.place_model(big.unets, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    split = [forward(stage) for stage in range(big.num_unets)]
    sync()
    launches["default forward"] = dict(kernels.LAUNCHES)
    out["default"] = dict(rel=[_rel(a, b) for a, b in zip(split, whole)], placed=placed,
                          finite=all(bool(torch.isfinite(a).all()) for a in split),
                          param_bytes=sum(p.numel() * p.element_size()
                                          for p in big.unets.parameters()),
                          full_bytes=full_bytes)
    del big, whole, split
    torch.cuda.empty_cache()
    lap("default")
    out["launches"] = {k: sum(c[k] for c in launches.values()) for k in kernels.LAUNCHES}
    return out


def mesh_tensor_parallel(captions):
    """M3: two processes on the one card over gloo with a model axis of 2;
    each one's numbers held to float32 within MESH_TP_REL of one device
    (bf16 colour to COLOR_LIMIT), its bytes to the plan's reckoning, the
    dump restored to the bit. Gloo stages every collective through host
    memory, so no time here is tensor parallelism's speed."""
    import shutil

    import torch
    from minimagen_tpu_torch.generate import default_imagen
    from minimagen_tpu_torch.parallel import collectives

    dump_dir = os.path.join(REPO, "build", "m3_dump")
    shutil.rmtree(dump_dir, ignore_errors=True)
    try:
        ranks = collectives.spawn("chip_smoke:mesh_tp_rank", 2, (captions, dump_dir),
                                  backend="gloo", devices=["cuda:0", "cuda:0"],
                                  timeout=MESH_TIMEOUT_S, echo=log)
    finally:
        shutil.rmtree(dump_dir, ignore_errors=True)
    failures = []
    for r in ranks:
        tag = f"  rank {r['rank']} {r['shape']}:"
        t = r["train"]
        log(f"{tag} float32 train step against one device: loss {t['loss_rtol']:.2e}, params "
            f"{t['params']:.2e}, EMA {t['ema']:.2e} rel L2 (limit {MESH_TP_REL}); params + moments"
            f" + EMA {t['bytes'] / 1e9:.4f} GB at rest (reckoned {t['reckoned'] / 1e9:.4f}; one "
            f"device {t['one_bytes'] / 1e9:.4f}), peak {t['peak'] / 1e9:.3f} GB allocated in the "
            "steps")
        if not (t["loss_rtol"] <= MESH_TP_REL and t["params"] <= MESH_TP_REL
                and t["ema"] <= MESH_TP_REL):
            failures.append(f"rank {r['rank']} tensor-parallel train step")
        if t["bytes"] != t["reckoned"]:
            failures.append(f"rank {r['rank']} state bytes {t['bytes']} != reckoned {t['reckoned']}")
        d = r["dump"]
        log(f"{tag} dump of {{data 2}} restored on {{model 2}} ({d['split']} kernels split): "
            f"step {d['step']}, equal bits {d['equal']}")
        if not all(d["equal"].values()):
            failures.append(f"rank {r['rank']} dump restored across mesh shapes")
        s, f = r["sample_bf16"], r["sample_f32"]
        log(f"{tag} bf16 sample(mesh=) {s['shape']} ({s['split']} layers split): base color_dist "
            f"{s['base']:.4f}, trunc/sr0.2 {s['trunc']:.4f} (limit {COLOR_LIMIT}); float32 against "
            f"sample(): {f['rel']:.2e} rel L2 (limit {MESH_TP_REL}), equal bits {f['equal']}")
        if not (s["finite"] and s["base"] <= COLOR_LIMIT and s["trunc"] <= COLOR_LIMIT
                and f["rel"] <= MESH_TP_REL):
            failures.append(f"rank {r['rank']} tensor-parallel sample(mesh=)")
        b = r["default"]
        log(f"{tag} default cascade, float32 guided forward per stage against one device: "
            + ", ".join(f"{x:.2e}" for x in b["rel"]) + f" rel L2 (limit {MESH_TP_REL}); "
            f"{b['placed']} kernels split; parameters {b['param_bytes'] / 1e9:.3f} GB a process "
            f"({b['full_bytes'] / 1e9:.3f} whole)")
        if not (b["finite"] and max(b["rel"]) <= MESH_TP_REL):
            failures.append(f"rank {r['rank']} default cascade under model 2")
        log(f"{tag} launches {r['launches']}; seconds (gloo through the host: not tensor "
            "parallelism's speed) " + ", ".join(f"{k} {v:.1f}" for k, v in r["seconds"].items()))
        require_launched(r["launches"], f"rank {r['rank']}",
                         names=tuple(KERNEL_INFO) + tuple(BACKWARD_INFO))
    with torch.device("meta"):  # shapes only
        big = default_imagen(device="meta")
    want = reckoned_state_bytes(big, 2)
    log("  reckoned per process, default cascade (float32 parameters, bf16 first moment, EMA): "
        + ", ".join(f"{m} {b / 1e9:.3f} GB" for m, b in want.items()))
    if failures:
        raise PhaseError("; ".join(failures))
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def tools_phase(imagen, captions):
    """The tools on the card: ``stage_memory_analysis`` of both lite stages
    beside the allocator's peak; the committed lite cascade exported to
    reference ``.pth`` files and imported back (``tools/torch_import.py``),
    its samples equal bits to the original's; the trace of a guided lite
    stage pass read back through ``utils/profiling`` against the profile's
    own sum of kernel times, and the traces the profile phases wrote,
    summarized."""
    import shutil

    import torch
    from minimagen_tpu_torch.tools.torch_import import (
        convert_reference_training_dir, export_unet_state_dict)
    from minimagen_tpu_torch.utils import profiling

    embeds, masks = imagen.encode_text(captions)
    text_len = embeds.shape[1]
    for stage in range(imagen.num_unets):
        r = imagen.stage_memory_analysis(stage, batch_size=len(captions), text_len=text_len,
                                         sample_steps=MESH_SAMPLE_STEPS)
        log(f"  stage_memory_analysis lite stage {stage} ({len(captions)} captions, DDIM-"
            f"{MESH_SAMPLE_STEPS}): " + ", ".join(f"{k} {v / 2 ** 20:.1f} MiB"
                                                   for k, v in r.items())
            + f"; allocator peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
        if not r.get("temp_size_in_bytes", 0) > 0:
            raise PhaseError(f"stage_memory_analysis of stage {stage} measured no pass")

    ref_dir = os.path.join(REPO, "build", "tools_reference")
    shutil.rmtree(ref_dir, ignore_errors=True)
    try:
        write_lite_parameters(os.path.join(ref_dir, "parameters"))
        os.makedirs(os.path.join(ref_dir, "state_dicts"))
        os.makedirs(os.path.join(ref_dir, "tmp"))
        for i, unet in enumerate(imagen.unets):
            torch.save(export_unet_state_dict(unet.state_dict(), imagen.unet_configs[i]),
                       os.path.join(ref_dir, "state_dicts", f"unet_{i}_state_lite.pth"))
        back = convert_reference_training_dir(ref_dir, device=DEVICE, dtype=imagen.dtype,
                                              param_dtype=next(imagen.unets.parameters()).dtype)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(imagen.unets.parameters(),
                                                   back.unets.parameters()))
    kw = dict(text_embeds=embeds, text_masks=masks, cond_scale=COND_SCALE, sampler="ddim",
              sample_steps=MESH_SAMPLE_STEPS, sr_start_noise_levels=0.2, cache_interval=None)
    gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)  # noqa: E731
    want = imagen.sample(generator=gen(), **kw)
    got = back.sample(generator=gen(), **kw)
    log(f"  exported to reference .pth and imported back: parameters equal {same}, samples "
        f"{tuple(got.shape)} equal bits {torch.equal(got, want)}")
    if not (same and torch.equal(got, want)):
        raise PhaseError("the reference .pth round trip changed the lite cascade")
    del back

    b = len(captions)
    gen0 = torch.Generator(device=DEVICE).manual_seed(SEED)
    init = torch.randn(b, 64, 64, 3, generator=gen0, device=DEVICE)

    def run():
        imagen.sample_stage(0, embeds, masks, COND_SCALE, init_noise=init, sampler="ddim",
                            sample_steps=5, cache_interval=None)

    run()
    trace_dir = os.path.join(TRACE_DIR, "tools")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profiling.trace(trace_dir) as prof:
        run()
    listed = sum(us for _, us in profiling.kernel_times(prof)) / 1e6
    busy, copies, top, cats = profiling.summarize_trace(profiling.find_trace(trace_dir))
    seconds = profiling.traced_device_seconds(run, os.path.join(TRACE_DIR, "tools_again"))
    log(f"  lite base stage, 5 guided DDIM steps: trace kernels {busy * 1e3:.3f} ms (profile's "
        f"key_averages {listed * 1e3:.3f} ms; copies {copies * 1e3:.3f} ms), "
        f"traced_device_seconds {'not measured' if seconds is None else f'{seconds * 1e3:.3f} ms'}")
    log("    families: " + ", ".join(f"{c} {s * 1e3:.3f} ms ({100 * f:.0f}%)" for c, s, f in cats))
    if busy > 0 and abs(busy - listed) > 0.05 * listed:
        raise PhaseError(f"the trace file's kernels ({busy} s) disagree with the profile's "
                         f"({listed} s)")
    for name in sorted(os.listdir(TRACE_DIR)):
        try:
            busy, _, top, cats = profiling.summarize_trace(
                profiling.find_trace(os.path.join(TRACE_DIR, name)))
        except FileNotFoundError:
            continue
        log(f"  trace {name}: device {busy * 1e3:.2f} ms; " + ", ".join(
            f"{c} {100 * f:.0f}%" for c, _, f in cats[:6]))


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
    import shutil

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    # float32 references in full precision (no TF32 in matmuls or convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global SM_CLOCK_HZ, SM_COUNT
    card = device_line()
    clock = sm_clock_line()
    SM_COUNT = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        SM_CLOCK_HZ = float(clock.split()[0]) * 1e6
    except (AttributeError, ValueError, IndexError):
        log(f"  nvidia-smi gave no SM clock ({clock!r}): the exponential bound takes 1980 MHz")
        SM_CLOCK_HZ = 1.98e9
    log(f"card: {card}, max SM clock {clock}, {SM_COUNT} SMs")
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
    with phase("quality: sr/start0.2 and sr/start0.4 (super_resolve, DDIM-50)"):
        eval_sr(imagen)
    with phase("quality: holdout/trained and holdout/held (base and truncated cascade)"):
        eval_holdout(imagen)
    with phase("quality: trunc/sr0.4 (the cascade truncated at 0.4)"):
        eval_trunc(imagen, captions)

    with phase(f"solvers: the base stage at {SOLVER_STEPS} steps, DDIM@lambda, DPM++@lambda, "
               "UniPC@karras"):
        solver_launches = solver_phase(imagen, captions)
    lever_paths = cache_phases(imagen, captions)
    with phase("measure: guided step ms per lite stage, cache_interval None vs 2"):
        cache_rows = [row for rep in range(CACHE_TIMING_REPS)
                      for row in measure_cache_steps(imagen, captions, "lite", rep)]

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
    with phase("attention kernels on fully dropped rows vs plain versions"):
        check_dropped_rows()
    with phase("reference train step: card float32 vs cpu float32"):
        reference_train_step()
    with phase(f"learn: train_lite, {LEARN_STEPS} steps, batch {TRAIN_BATCH}"):
        run, train_launches, _ = learn()
    with phase("measure: profile training steps"):
        profile_train(run)
    del run
    with phase("harness: train CLI on the lite cascade, restart, inference CLI"):
        harness_launches = harness_phase(captions)
        for name, counts in harness_launches.items():
            require_launched(counts, name, names=tuple(KERNEL_INFO) + (
                tuple(BACKWARD_INFO) if "inference" not in name else ()))

    with phase("mesh M1: world 1 over NCCL on cuda:0, --ZERO1 off/on/fsdp and sample(mesh=) "
               "against one device"):
        mesh1_launches = mesh_world1(imagen, captions)
    with phase("mesh M2: two processes on the card over gloo (staged through the host)"):
        mesh2_launches = mesh_two_processes(captions)
    with phase("mesh M3: two processes on the card, a model axis of 2 (gloo through the host: "
               "no time here is tensor parallelism's speed)"):
        mesh3_launches = mesh_tensor_parallel(captions)
    with phase("tools: stage_memory_analysis, the reference .pth round trip, the traces "
               "through utils/profiling"):
        tools_phase(imagen, captions)

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
    with phase("tools: stage_memory_analysis of Base"):
        r = big.stage_memory_analysis(0, batch_size=DEFAULT_CAPTIONS, text_len=DEFAULT_MAX_WORDS,
                                      sample_steps=MESH_SAMPLE_STEPS)
        log(f"  Base ({DEFAULT_CAPTIONS} captions, DDIM-{MESH_SAMPLE_STEPS}): " + ", ".join(
            f"{k} {v / 2 ** 20:.1f} MiB" for k, v in r.items())
            + f"; allocator peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
        if not r.get("temp_size_in_bytes", 0) > 0:
            raise PhaseError("stage_memory_analysis of Base measured no pass")
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
        serve_launches, serve_stats = serve(big, default_captions)
    with phase(f"serve the default cascade: {DEFAULT_CAPTIONS} captions, DPM++-{SOLVER_STEPS}, "
               "cache_interval 'auto'"):
        fast_serve_launches = serve_fast(big, default_captions, serve_stats["seconds"])
    with phase("measure: guided step ms per default stage, cache_interval None vs 2"):
        cache_rows += [row for rep in range(CACHE_TIMING_REPS)
                       for row in measure_cache_steps(big, default_captions, "default", rep)]
        log_cache_fit(cache_rows, big)
        log("  cache measurement rows: " + json.dumps(cache_rows))
    with phase("measure: profile guided DDIM steps of the default cascade"):
        profile_steps(big, default_captions)
    with phase(f"train the default cascade: {DEFAULT_TRAIN_STEPS} steps, batch "
               f"{DEFAULT_TRAIN_BATCH}, both stages"):
        big_train_launches, _ = train_default(big, big_batch, big_training)
    del big

    runs = {"lite sampling": launches, "lite solvers": solver_launches, **lever_paths,
            "lite learning": train_launches, **harness_launches,
            "mesh world 1": mesh1_launches, "mesh 2 processes": mesh2_launches,
            "mesh tensor parallel": mesh3_launches,
            "default serving": serve_launches,
            "default DPM++ serving": fast_serve_launches, "default training": big_train_launches}
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
