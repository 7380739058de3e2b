"""The program's spans on the trace's clock, and the card's idle time charged
to them.

While a profiler session is active the port records a span at each of its
layer boundaries (``minimagen_tpu_torch.utils.profiling.span``: the sampling
call, its stages and steps, each U-Net call and the dynamic threshold; the
train step, its forward and backward passes, the autograd Functions'
backwards, the optimizer and the EMA), stamped with ``time.perf_counter_ns``,
the clock ``trace.Ranges`` stamps the benchmark's ranges with. A traced
run's readings hold the unit ranges (``pb.call`` / ``pb.step``) on both
clocks, the host's ns in ``readings["ranges"].spans_ns`` and the trace's us
in ``readings["trace"].ranges``: the affine map ``trace.profile`` applied is
recovered from the first start and the last end, and put on every program
span.

Each idle instant of the card in the traced window is charged to the
innermost program span open on the host then: the open span, on any thread,
that started last. A gap that crosses span boundaries is split at them;
idle time with no program span open is ``outside`` (the harness, Python
between calls). A span's path is the path of the span innermost at its start
and its own name, so a backward on the autograd engine's thread reads
``train.step/train.backward/group_norm.backward``.

:func:`charged` drains the program's spans once per traced run (a program
that records none gives None: its metrics are left out), prints one line to
standard error and changes nothing in the readings.
"""
from __future__ import annotations

import bisect
import heapq
import json
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .trace import PREFIX

OUTSIDE = "outside"
UNITS = ("call", "step")
Path = Tuple[str, ...]


def program_spans() -> Optional[list]:
    """The spans the program recorded since the last drain, or None where the
    program records none (a tree without ``span``)."""
    try:
        from minimagen_tpu_torch.utils.profiling import drain_spans  # noqa: PLC0415
    except ImportError:
        return None
    return drain_spans()


def clock_map(host_ns: Sequence[Tuple[int, int]],
              trace_us: Sequence[Tuple[float, float]]) -> Tuple[Callable[[float], float], float]:
    """(host ns -> trace us, trace us per host ns) from one range list on
    both clocks: the affine map through the first start and the last end."""
    h0, h1 = min(a for a, _ in host_ns), max(b for _, b in host_ns)
    t0, t1 = min(a for a, _ in trace_us), max(b for _, b in trace_us)
    scale = (t1 - t0) / (h1 - h0)
    return (lambda ns: t0 + (ns - h0) * scale), scale


def idle_intervals(ops, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] in which no operation ran; `ops` sorted by
    start, each (start us, duration us, ...)."""
    idle, cur = [], lo
    for op in ops:
        start, end = op[0], op[0] + op[1]
        if start >= hi:
            break
        if start > cur:
            idle.append((cur, start))
        cur = max(cur, end)
    if cur < hi:
        idle.append((cur, hi))
    return idle


def segments(spans: Sequence[Tuple[str, float, float]], lo: float,
             hi: float) -> List[Tuple[float, float, Path]]:
    """[lo, hi] cut where the innermost open span changes: (start, end, path
    of the innermost span, () where none is open). `spans`: (name, start,
    end) on one clock."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    paths: List[Path] = [()] * len(spans)
    bounds = sorted({lo, hi, *(t for _, a, b in spans for t in (a, b) if lo < t < hi)})
    heap: List[Tuple[float, int]] = []  # (-start, index), closed ones dropped when on top
    out, k = [], 0

    def top(t):
        while heap and spans[heap[0][1]][2] <= t:
            heapq.heappop(heap)
        return heap[0][1] if heap else None

    for t, t_next in zip(bounds, bounds[1:]):
        while k < len(order) and spans[order[k]][1] <= t:
            i = order[k]
            encl = top(spans[i][1])
            paths[i] = (paths[encl] if encl is not None else ()) + (spans[i][0],)
            heapq.heappush(heap, (-spans[i][1], i))
            k += 1
        i = top(t)
        out.append((t, t_next, paths[i] if i is not None else ()))
    return out


class Charged:
    """The card's idle time in a traced window, charged to program spans."""

    def __init__(self, spans: Sequence[Tuple[str, float, float]], ops, lo: float, hi: float,
                 units: int):
        """`spans` (name, start, end) and `ops` (start, duration, launch,
        name; sorted by start) on the trace's clock (us); the window [lo,
        hi]; `units` calls or steps in it."""
        self.spans, self.ops, self.units = list(spans), ops, units
        self.window_us = hi - lo
        cuts = segments(self.spans, lo, hi)
        self.idle_us: Dict[Path, float] = {}
        self.self_us: Dict[Path, float] = {}
        self.gaps: List[Tuple[float, Path, float]] = []  # (us, the path charged most, start)
        for a, b, path in cuts:
            self.self_us[path] = self.self_us.get(path, 0.0) + b - a
        starts = [a for a, _, _ in cuts]
        for a, b in idle_intervals(ops, lo, hi):
            j, share = max(bisect.bisect_right(starts, a) - 1, 0), {}
            while j < len(cuts) and cuts[j][0] < b:
                us = min(b, cuts[j][1]) - max(a, cuts[j][0])
                if us > 0:
                    path = cuts[j][2]
                    self.idle_us[path] = self.idle_us.get(path, 0.0) + us
                    share[path] = share.get(path, 0.0) + us
                j += 1
            if share:
                self.gaps.append((b - a, max(share, key=share.get), a))

    def idle_ms(self, innermost: Sequence[str] = (), under: Sequence[str] = ()) -> float:
        """Idle ms per unit charged where the innermost span is one of
        `innermost`, or where one of `under` is open."""
        us = sum(v for p, v in self.idle_us.items()
                 if (p and p[-1] in innermost) or any(n in p for n in under))
        return us / 1e3 / self.units

    def device_s(self, names: Sequence[str]) -> float:
        """Device seconds of the operations launched inside a span of one of
        `names` (by launch, as ``trace.Trace.range_device_s`` links them)."""
        inside = sorted((a, b) for n, a, b in self.spans if n in names)
        starts = [a for a, _ in inside]
        total = 0.0
        for _, dur, launch, _ in self.ops:
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= inside[i][1]:
                total += dur
        return total * 1e-6

    def by_name(self, table: Dict[Path, float]) -> Dict[str, float]:
        """ms per unit of `table` by innermost span name (``outside`` for ())."""
        out: Dict[str, float] = {}
        for path, us in table.items():
            name = path[-1] if path else OUTSIDE
            out[name] = out.get(name, 0.0) + us / 1e3 / self.units
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


_LAST: List = [None, None]  # the trace last charged, and its result


def charged(readings) -> Optional[Charged]:
    """The traced run's idle time charged to the program's spans, worked out
    once per trace; None where the run was not traced or the program
    records no spans."""
    tr, ranges = readings.get("trace"), readings.get("ranges")
    if tr is None or ranges is None:
        return None
    if _LAST[0] is not tr:
        _LAST[:] = [tr, _charge(readings, tr, ranges)]
    return _LAST[1]


def _charge(readings, tr, ranges) -> Optional[Charged]:
    unit = next((u for u in UNITS if ranges.spans_ns.get(PREFIX + u)), None)
    recorded = program_spans()
    if unit is None or not recorded:
        print("portbench: the program recorded no spans", file=sys.stderr)
        return None
    host, on_trace = ranges.spans_ns[PREFIX + unit], tr.ranges[PREFIX + unit]
    to_trace, scale = clock_map(host, on_trace)
    lo = on_trace[0][0]
    hi = to_trace(min(a for a, _ in host) + tr.window_s * 1e9)
    spans = [(s.name, to_trace(s.start_ns), to_trace(s.end_ns)) for s in recorded
             if s.end_ns is not None]
    c = Charged(spans, tr.ops, lo, hi, tr.units)
    idle_ms = sum(c.idle_us.values()) / 1e3
    trace_idle_ms = (tr.window_s - tr.busy_s()) * 1e3
    off = abs(idle_ms - trace_idle_ms) / 1e3 / tr.window_s
    measured = readings.get("measured", {})
    plain_units = measured.get("calls") or measured.get("steps")
    plain = measured["seconds"] / plain_units if plain_units else float("nan")
    gaps = [_gap(us, path, at, tr, on_trace, unit) for us, path, at in
            sorted(c.gaps, reverse=True)[:10]]
    print(f"portbench: program spans: {len(recorded) / tr.units:.6g} per {unit} on the trace's "
          f"clock ({len(host)} {unit} ranges, {scale:.9g} us per host ns); idle ms per {unit} "
          f"by innermost span: {json.dumps(c.by_name(c.idle_us))}; host ms per {unit} by "
          f"innermost span: {json.dumps(c.by_name(c.self_us))}; idle charged {idle_ms:.6g} ms "
          f"of the trace's {trace_idle_ms:.6g} ({off:.3%} of the window); s per {unit}: "
          f"traced window {tr.window_s / tr.units:.6g} "
          f"(profiler on), plain window {plain:.6g}; longest idle gaps: {json.dumps(gaps)}",
          file=sys.stderr)
    return c


def _gap(us: float, path: Path, at: float, tr, units_us, unit: str) -> list:
    """A gap as [span path, seconds, where (the unit and ms into it), the
    operation that ended it, ms from the gap's start to that operation's
    launch on the host]."""
    k = max(bisect.bisect_right([a for a, _ in units_us], at) - 1, 0)
    where = f"{unit} {k} +{(at - units_us[k][0]) / 1e3:.4g} ms"
    i = bisect.bisect_left([op[0] for op in tr.ops], at + us)
    after = tr.ops[i] if i < len(tr.ops) else None
    return ["/".join(path) or OUTSIDE, us * 1e-6, where,
            after[3][:60] if after else None,
            round((after[2] - at) / 1e3, 4) if after else None]
