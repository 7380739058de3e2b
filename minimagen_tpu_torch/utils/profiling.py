"""Tracing and step timing (counterpart of ``minimagen_tpu/utils/profiling.py``).

- :func:`span`: a named span of the program's host work (a sampling call,
  a stage, a step, a U-Net call, the backward pass, the optimizer),
  recorded in memory while a ``torch.profiler`` session is active and
  nothing otherwise; :func:`drain_spans` takes the records;
- :func:`trace`: a ``torch.profiler`` trace of the CPU and, where there is
  one, the card, written as a Chrome trace (``trace_<n>.json``, by
  :func:`save_trace`) into a directory (the JAX package writes an XPlane
  trace), with the spans recorded meanwhile on the trace's clock;
  :func:`find_trace` finds the newest, :func:`summarize_trace` reads its
  device kernels;
- :func:`op_category`: a kernel's family by its name: the port's attention
  kernels by kind and its GroupNorm and depth-to-space kernels (the tags of
  ``ab_times.py``, which times two checkouts with its own copy), then
  convolution/GEMM, casts, copies, reductions and elementwise kernels;
- :func:`kernel_times` / :func:`family_ms`: (kernel, device us) items of
  a profile and the device ms per call of each family among them;
- :func:`traced_device_seconds`: the device busy seconds of a call, None
  where no device kernel ran (the CPU);
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
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
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


# --------------------------------------------------------------------------- #
# spans of the program's host work                                            #
# --------------------------------------------------------------------------- #
@dataclass
class SpanRecord:
    """One recorded span: its name, start and end on ``time.perf_counter_ns``'s
    clock (`end_ns` None while it is open), the index of its parent among
    the records drained with it (None for the first span of its thread),
    the OS thread it ran on, and the index of the root span (the sampling
    call or train step) open when it started."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    thread: int
    root: Optional[int]


class _Span:
    """A span while it is recorded (the context manager :func:`span` gives
    while a profiler is active); its parent and root are spans too, turned
    into indices when drained."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "root")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _SPANS.open(self)
        return self

    def __exit__(self, *exc) -> None:
        _SPANS.close(self)


class _SpanBuffer:
    """The spans recorded since the last drain. Each thread nests its spans
    on its own stack; the autograd engine runs backward functions on threads
    of its own, so a span opened on a thread with none open belongs to the
    root span open on another thread, or is a root itself."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: List[_Span] = []
        self.local = threading.local()
        self.root: Optional[_Span] = None

    def open(self, span: _Span) -> None:
        local = self.local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
            local.thread = threading.get_native_id()
        parent = stack[-1] if stack else None
        span.parent, span.thread, span.end_ns = parent, local.thread, None
        span.root = parent.root if parent is not None else (self.root or span)
        if span.root is span:
            self.root = span
        stack.append(span)
        with self.lock:
            self.records.append(span)
        span.start_ns = time.perf_counter_ns()

    def close(self, span: _Span) -> None:
        span.end_ns = time.perf_counter_ns()
        self.local.stack.pop()
        if self.root is span:
            self.root = None

    def drain(self) -> List[SpanRecord]:
        with self.lock:
            records, self.records = self.records, []
        index = {id(r): i for i, r in enumerate(records)}
        at = lambda r: None if r is None else index.get(id(r))  # noqa: E731
        return [SpanRecord(r.name, r.start_ns, r.end_ns, at(r.parent), r.thread, at(r.root))
                for r in records]


_SPANS = _SpanBuffer()
_OFF = nullcontext()


def span(name: str):
    """A named span of the program's host work, as a context manager. It is
    recorded (name, host start and end, parent, thread, root) while a
    ``torch.profiler`` session is active on the calling thread, which the
    autograd engine's threads inherit; otherwise it is one shared null
    context and costs the check alone."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def drain_spans() -> List[SpanRecord]:
    """The spans recorded since the last drain, in the order they opened;
    the buffer is emptied. Drain when no span is open."""
    return _SPANS.drain()


_ANCHORS = ("mmt.clock.start", "mmt.clock.end")


def _clock_anchor(name: str) -> float:
    """The host clock (ns) at the middle of a ``record_function`` range `name`."""
    from torch.profiler import record_function  # noqa: PLC0415

    t0 = time.perf_counter_ns()
    with record_function(name):
        pass
    return (t0 + time.perf_counter_ns()) / 2.0


def _write_spans(path: str, spans: Sequence[SpanRecord], anchors_ns: Tuple[float, float]) -> None:
    """Add the closed `spans` that start after the first anchor to the Chrome
    trace at `path`, as complete events of category ``span`` on the trace's
    clock: the two :data:`_ANCHORS` ranges in the trace, stamped at
    `anchors_ns` on the host clock, give the map."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"]
    marks = sorted(e["ts"] + e.get("dur", 0) / 2.0 for e in events
                   if e.get("ph") == "X" and e.get("name") in _ANCHORS)
    if len(marks) != 2:
        raise RuntimeError(f"{path} holds {len(marks)} clock anchors, not 2")
    scale = (marks[1] - marks[0]) / (anchors_ns[1] - anchors_ns[0])
    pid = os.getpid()
    for i, s in enumerate(spans):
        if s.end_ns is None or s.start_ns < anchors_ns[0]:
            continue
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.thread,
                       "ts": marks[0] + (s.start_ns - anchors_ns[0]) * scale,
                       "dur": (s.end_ns - s.start_ns) * scale,
                       "args": {"index": i, "parent": s.parent, "root": s.root}})
    with open(path, "w") as f:
        json.dump(data, f)


@contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block (the CPU, and the card where there is one) and
    write a Chrome trace into `logdir` (made if missing), with the spans
    (:func:`span`) recorded meanwhile over the operations; yields the
    profile."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    first = _clock_anchor(_ANCHORS[0])
    try:
        yield prof
    finally:
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        last = _clock_anchor(_ANCHORS[1])
        prof.stop()
        _write_spans(save_trace(prof, logdir), drain_spans(), (first, last))


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
