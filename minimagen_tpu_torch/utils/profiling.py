"""Tracing and step timing (counterpart of ``minimagen_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace of the CPU and, where there is
  one, the card, written as a Chrome trace (``trace_<n>.json``, by
  :func:`save_trace`) into a directory (the JAX package writes an XPlane
  trace); :func:`find_trace`
  finds the newest, :func:`summarize_trace` reads its device kernels;
- :func:`op_category`: a kernel's family by its name: the port's attention
  kernels by kind and its GroupNorm and depth-to-space kernels (the tags of
  ``ab_times.py``, which times two checkouts with its own copy), then
  convolution/GEMM, casts, copies, reductions and elementwise kernels;
- :func:`kernel_times` / :func:`family_ms`: (kernel, device us) items of
  a profile and the device ms per call of each family among them;
- :func:`traced_device_seconds`: the device busy seconds of a call, None
  where no device kernel ran (the CPU);
- :func:`annotate`: a named range (``record_function``) in the trace;
- :class:`StepTimer`: wall-clock step times.

The card runs asynchronously, so a step's host time says nothing until the
card has finished it: :class:`StepTimer` synchronizes the card at the start
and the end of every timed step when it times a CUDA device, and
:func:`trace` synchronizes it before the trace ends.
"""
from __future__ import annotations

import glob
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..ab_times import ATTENTION_FAMILIES, GROUP_NORM_TAGS

# (family, lower-case name tags), tried in order after the port's own kernels
_CATEGORIES = (
    ("copies", ("nchwtonhwc", "nhwctonchw", "catarraybatchedcopy", "memcpy", "memset")),
    ("casts", ("direct_copy",)),  # dtype casts (and strided copies, which share the kernel)
    ("convolution/gemm", ("gemm", "conv", "cutlass", "xmma", "wgrad", "dgrad", "cudnn",
                          "matmul", "cublas")),
    ("copies", ("copy", "cat_", "transpose", "permute", "index")),
    ("reductions", ("reduce", "norm", "sum", "softmax", "mean")),
    ("elementwise", ("elementwise", "foreach", "multi_tensor", "vectorized")),
)
FAMILY_ORDER = (*ATTENTION_FAMILIES, "group_norm", "depth_to_space", "convolution/gemm",
                "casts", "copies", "reductions", "elementwise", "other")


def op_category(name: str) -> str:
    """The family of a CUDA kernel (or trace item) by its name: one of
    :data:`FAMILY_ORDER`."""
    for family, tag in ATTENTION_FAMILIES.items():
        if tag in name:
            return family
    if any(tag in name for tag in GROUP_NORM_TAGS):
        return "group_norm"
    if "depth_to_space" in name:
        return "depth_to_space"
    lower = name.lower()
    for family, tags in _CATEGORIES:
        if any(tag in lower for tag in tags):
            return family
    return "other"


@contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block (the CPU, and the card where there is one) and
    write a Chrome trace into `logdir` (made if missing); yields the
    profile."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        save_trace(prof, logdir)


def save_trace(prof, logdir: str) -> str:
    """Write a stopped profile as a Chrome trace ``trace_<n>.json`` into
    `logdir` (made if missing); returns its path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def find_trace(logdir: str) -> str:
    """The newest trace under `logdir` (the counterpart of ``find_xplane``)."""
    paths = glob.glob(os.path.join(logdir, "**", "trace_*.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace_*.json under {logdir}")
    return max(paths, key=os.path.getmtime)


def summarize_trace(path: str, top: int = 10):
    """The device work of a Chrome trace: (kernel seconds, copy and set
    seconds (the card's own memcpy/memset items, beside the kernels),
    the `top` kernels as (name, seconds, share of the kernel seconds), and
    each family of :func:`op_category` as (family, seconds, share)), the
    kernels' sum being the card's busy time."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    per_op: Dict[str, float] = defaultdict(float)
    copies = 0.0
    for e in events:
        cat = e.get("cat", "")
        if cat == "kernel":
            per_op[e["name"]] += e.get("dur", 0) / 1e6
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies += e.get("dur", 0) / 1e6
    total = sum(per_op.values())
    share = (lambda s: s / total) if total > 0 else (lambda s: 0.0)
    per_cat: Dict[str, float] = defaultdict(float)
    for name, s in per_op.items():
        per_cat[op_category(name)] += s
    top_ops = [(n, s, share(s)) for n, s in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]]
    cats = [(c, s, share(s)) for c, s in sorted(per_cat.items(), key=lambda kv: -kv[1])]
    return total, copies, top_ops, cats


def traced_device_seconds(run, logdir: Optional[str] = None) -> Optional[float]:
    """Run `run()` under :func:`trace` and return the card's busy seconds
    (the sum of its kernels' times), or None where no kernel ran on a device
    (a CPU run)."""
    with tempfile.TemporaryDirectory(prefix="mmt_trace_") as tmp:
        logdir = logdir or tmp
        with trace(logdir):
            run()
        total, _, _, _ = summarize_trace(find_trace(logdir))
    return total if total > 0 else None


def kernel_times(prof) -> List[Tuple[str, float]]:
    """(name, device us) of every kernel of a finished profile; user
    annotations (e.g. ``Optimizer.step``) are ranges over kernels, not
    kernels."""
    return [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]


def family_ms(items: Sequence[Tuple[str, float]], calls: int) -> Dict[str, float]:
    """Device ms per call of each family of :data:`FAMILY_ORDER` among
    (kernel name, device us) items of `calls` calls."""
    out = dict.fromkeys(FAMILY_ORDER, 0.0)
    for name, us in items:
        out[op_category(name)] += us / 1e3 / calls
    return out


def annotate(name: str):
    """A named range in profiler traces (``torch.profiler.record_function``)."""
    from torch.profiler import record_function  # noqa: PLC0415

    return record_function(name)


class StepTimer:
    """Wall-clock step times, synchronized with `device` when it is a CUDA
    device (``torch.cuda.synchronize`` before the clock starts and before it
    stops)."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self._t0: Optional[float] = None
        self.durations: List[float] = []

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        self._sync()
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        self._t0 = None
        return dt

    @contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def count(self) -> int:
        return len(self.durations)

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        """Mean, min and max step seconds and steps per second, without the
        first `skip_first` steps (the kernel build, first allocations)."""
        ds = self.durations[skip_first:] if len(self.durations) > skip_first else self.durations
        if not ds:
            return {"steps": 0, "mean_s": 0.0, "steps_per_sec": 0.0}
        mean = sum(ds) / len(ds)
        return {"steps": len(ds), "mean_s": mean, "steps_per_sec": 1.0 / mean if mean > 0 else 0.0,
                "min_s": min(ds), "max_s": max(ds)}
