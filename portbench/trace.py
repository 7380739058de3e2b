"""Ranges, shapes and the device trace of a traced run.

:class:`Ranges` stamps the host clock around every call of the modules it is
given (forward pre- and post-hooks, the benchmark's own; the program is not
edited) and keeps the shapes that entered each. :func:`profile` runs a
callable under ``torch.profiler`` with CUDA activity alone (the device's
operations and the runtime's launch calls; recording every host operation
as well slowed a call 1.7x on the card), exports the trace into the checkout
and reduces it (:class:`Trace`): the union of the card's busy intervals,
each range's device time, the operations that took most time and the
longest idle gaps. The host stamps are put on the trace's clock by two
anchors, at the start and at the end: the launch of ``torch.cuda._sleep``'s
spin kernel, which nothing else launches, bracketed by the host clock.

A device operation belongs to the range that was open on the host when it
was launched (its runtime or driver launch event, by correlation id). An
operation the trace gives no launch for takes the launch time of the
operation before it on its stream, which the same module launched.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "pb."


def param_bytes(module) -> int:
    """The bytes of a module's parameters, counted once per module."""
    n = getattr(module, "_portbench_param_bytes", None)
    if n is None:
        n = sum(p.numel() * p.element_size() for p in module.parameters())
        module._portbench_param_bytes = n
    return n


class Ranges:
    """Forward hooks that stamp the host clock around each call of
    `modules` and record ``shape_of(module, args, kwargs)`` per call."""

    def __init__(self):
        self.handles = []
        self.shapes: Dict[str, List] = defaultdict(list)
        self.calls: Dict[str, int] = defaultdict(int)
        self.spans_ns: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.recording = False

    def add(self, name: str, modules, shape_of: Optional[Callable] = None) -> None:
        name = PREFIX + name
        for m in modules:
            opened: List[int] = []

            def pre(module, args, kwargs, name=name, opened=opened):
                if not self.recording:
                    return
                self.calls[name] += 1
                if shape_of is not None:
                    self.shapes[name].append(shape_of(module, args, kwargs))
                opened.append(time.perf_counter_ns())

            def post(module, args, kwargs, out, name=name, opened=opened):
                if opened:
                    self.spans_ns[name].append((opened.pop(), time.perf_counter_ns()))

            self.handles.append(m.register_forward_pre_hook(pre, with_kwargs=True))
            self.handles.append(m.register_forward_hook(post, with_kwargs=True))

    @contextlib.contextmanager
    def span(self, name: str):
        """A range around a block (a whole call or step)."""
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans_ns[PREFIX + name].append((start, time.perf_counter_ns()))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


class Trace:
    """The reduced trace of one profiled window."""

    def __init__(self, events: List[dict], window_s: float, units: int,
                 spans: Dict[str, List[Tuple[float, float]]]):
        """`spans`: each range's (start, end) on the trace's clock (us)."""
        self.window_s, self.units = window_s, units
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = e["ts"]
        ops = sorted((e for e in events if e.get("cat") in GPU_CATS and e.get("dur") is not None),
                     key=lambda e: e["ts"])
        self.unlinked = 0
        last_launch: Dict = {}
        self.ops = []  # (gpu start us, dur us, launch us, name)
        for e in ops:
            stream = (e.get("pid"), e.get("tid"))
            lt = launches.get(e.get("args", {}).get("correlation"))
            if lt is None:
                self.unlinked += 1
                lt = last_launch.get(stream, e["ts"])
            last_launch[stream] = lt
            self.ops.append((e["ts"], e["dur"], lt, e["name"]))
        self.ranges = {name: sorted(v) for name, v in spans.items()}

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card (interval union)."""
        total, end = 0.0, None
        for start, dur, _, _ in self.ops:
            stop = start + dur
            if end is None or start > end:
                total += dur
                end = stop
            elif stop > end:
                total += stop - end
                end = stop
        return total * 1e-6

    def range_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside range `name`."""
        spans = self.ranges.get(PREFIX + name, [])
        starts = [s for s, _ in spans]
        total = 0.0
        for _, dur, lt, _ in self.ops:
            i = bisect.bisect_right(starts, lt) - 1
            if i >= 0 and lt <= spans[i][1]:
                total += dur
        return total * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, seconds per unit."""
        by_name: Dict[str, float] = defaultdict(float)
        for _, dur, _, name in self.ops:
            by_name[name[:160]] += dur * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, s / max(self.units, 1)] for name, s in top]

    def _open_range(self, t: float) -> str:
        """The innermost benchmark range open on the host at time `t`."""
        best, width = "outside any range", None
        for name, spans in self.ranges.items():
            starts = [s for s, _ in spans]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                w = spans[i][1] - spans[i][0]
                if width is None or w < width:
                    best, width = name, w
        return best

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps, each labelled by the range open on the host."""
        gaps, end = [], None
        for start, dur, _, _ in self.ops:
            if end is not None and start > end:
                gaps.append((start - end, end))
            end = start + dur if end is None else max(end, start + dur)
        gaps.sort(reverse=True)
        return [[self._open_range(at + gap / 2), gap * 1e-6] for gap, at in gaps[:n]]


ANCHOR_KERNEL = "spin_kernel"


def _anchor() -> Tuple[int, int]:
    """Host clock (ns) just before and after launching the anchor kernel."""
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    torch.cuda._sleep(1)
    return t0, time.perf_counter_ns()


def _anchor_launches(events: List[dict]) -> List[float]:
    """Mid-times of the anchor kernels' launch calls, on the trace's clock."""
    ids = {e["args"]["correlation"] for e in events if e.get("cat") == "kernel"
           and ANCHOR_KERNEL in e.get("name", "") and "correlation" in e.get("args", {})}
    return sorted(e["ts"] + e.get("dur", 0) / 2.0 for e in events
                  if e.get("cat") in LAUNCH_CATS and e.get("args", {}).get("correlation") in ids)


def profile(fn: Callable[[], int], ranges: Ranges, out_dir: str) -> Trace:
    """Run `fn` (which returns the number of calls or steps it made) under
    the profiler and reduce its trace, with `ranges`' stamps. A profiler
    failure raises."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        first = _anchor()
        t0 = time.perf_counter()
        ranges.recording = True
        units = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        ranges.recording = False
        last = _anchor()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    syncs = _anchor_launches(events)
    if len(syncs) != 2:
        raise RuntimeError(f"the trace holds {len(syncs)} anchor launches, not 2")
    host = [(a + b) / 2.0 for a, b in (first, last)]
    scale = (syncs[-1] - syncs[0]) / (host[1] - host[0])
    to_trace = lambda ns: syncs[0] + (ns - host[0]) * scale  # noqa: E731
    spans = {name: [(to_trace(a), to_trace(b)) for a, b in v]
             for name, v in ranges.spans_ns.items()}
    trace = Trace([e for e in events if ANCHOR_KERNEL not in e.get("name", "")],
                  window, units, spans)
    if not trace.ops:
        raise RuntimeError("the profiler recorded no device operation")
    return trace
