"""``portbench/spans.py`` on a hand-made trace and hand-made program spans: the
clock map recovered from the unit ranges, idle gaps split at span
boundaries, every idle microsecond charged once, the paths of a backward on
another thread, the seven readers, and a program that records no spans."""
import os
from types import SimpleNamespace

import pytest

from portbench import run, spans
from portbench.trace import Ranges, Trace

H0 = 10 ** 12  # host ns
SCALE = 0.0010002  # trace us per host ns
on_trace = lambda ns: 100.0 + (ns - H0) * SCALE  # noqa: E731

STEPS = [(H0, H0 + 50_000), (H0 + 50_000, H0 + 100_000)]
# (name, start, end) in host ns from H0; the GroupNorm backward runs on the
# autograd engine's thread, with no parent of its own
SPANS = [("train.step", 1000, 49000), ("train.forward", 2000, 20000), ("unet.0", 3000, 10000),
         ("train.backward", 21000, 40000), ("group_norm.backward", 25000, 31000),
         ("train.optimizer", 41000, 48000), ("train.step", 51000, 99000)]
# device operations (start, end, launch) in host ns from H0: idle 500-5000,
# 28000-32000 and 46000-60000
OPS = [(0, 500, -100), (5000, 28000, 4000), (32000, 42000, 31000), (42000, 46000, 41500),
       (60000, 100000, 59000)]
IDLE_NS = {"outside": 500 + 2000, "train.step": 1000 + 1000 + 9000, "train.forward": 1000,
           "unet.0": 2000, "group_norm.backward": 3000, "train.backward": 1000,
           "train.optimizer": 2000}


def _trace():
    events = []
    for k, (a, b, launch) in enumerate(OPS):
        events.append({"cat": "kernel", "name": f"k{k}", "ph": "X", "pid": 0, "tid": 7,
                       "ts": on_trace(H0 + a), "dur": (b - a) * SCALE,
                       "args": {"correlation": k}})
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ph": "X", "pid": 0,
                       "tid": 1, "ts": on_trace(H0 + launch), "dur": 1.0,
                       "args": {"correlation": k}})
    return Trace(events, window_s=1e-4, units=2,
                 spans={"pb.step": [(on_trace(a), on_trace(b)) for a, b in STEPS]})


def _readings():
    ranges = Ranges()
    ranges.spans_ns["pb.step"] = list(STEPS)
    ranges.shapes["pb.unet_params"] = [(11, (1000, 40000)), (12, (500, 20000)),
                                       (11, (1000, 40000))]
    return {"trace": _trace(), "ranges": ranges, "measured": {"seconds": 1.0, "steps": 10}}


@pytest.fixture
def recorded(monkeypatch):
    records = [SimpleNamespace(name=n, start_ns=H0 + a, end_ns=H0 + b) for n, a, b in SPANS]
    monkeypatch.setattr(spans, "program_spans", lambda: list(records))


def test_clock_map_is_recovered_from_the_unit_ranges():
    tr = _trace()
    to_trace, scale = spans.clock_map(STEPS, tr.ranges["pb.step"])
    assert scale == pytest.approx(SCALE, rel=1e-12)
    for ns in (H0, H0 + 12345, H0 + 99_999, H0 + 10 ** 7):
        assert to_trace(ns) == pytest.approx(on_trace(ns), abs=1e-6)


def test_gaps_are_split_at_span_boundaries_and_charged_once(recorded):
    r = _readings()
    c = spans.charged(r)
    got = c.by_name(c.idle_us)
    assert set(got) == set(IDLE_NS)
    for name, ns in IDLE_NS.items():
        assert got[name] == pytest.approx(ns * SCALE / 1e3 / 2, rel=1e-9), name
    tr = r["trace"]
    assert sum(c.idle_us.values()) == pytest.approx(sum(IDLE_NS.values()) * SCALE, rel=1e-9)
    # the trace's own idle (its window on the host's clock) to 1% of the window
    trace_idle_us = (tr.window_s - tr.busy_s()) * 1e6
    assert abs(sum(c.idle_us.values()) - trace_idle_us) < 0.01 * tr.window_s * 1e6
    assert sum(c.self_us.values()) == pytest.approx(c.window_us, rel=1e-12)
    # the longest gap is mostly the second step's dispatch; the next two are
    # labelled by the span charged most, the backward by its path in time
    assert [p for _, p, _ in sorted(c.gaps, reverse=True)] == [
        ("train.step",), ("train.step", "train.forward", "unet.0"),
        ("train.step", "train.backward", "group_norm.backward")]
    assert spans.charged(r) is c  # worked out once per trace


def test_readers(recorded):
    r = _readings()
    per_step = lambda *names: sum(IDLE_NS[n] for n in names) * SCALE / 1e3 / 2  # noqa: E731
    want = {"forward_idle_ms.train": per_step("train.forward", "unet.0"),
            "backward_idle_ms.train": per_step("train.backward", "group_norm.backward"),
            "optimizer_idle_ms.train": per_step("train.optimizer"),
            "sampler_idle_ms.sample": 0.0, "unet_idle_ms.stage0.sample": per_step("unet.0"),
            "unet_idle_ms.stage1.sample": 0.0,
            # 60 kB a step at 3.35 TB/s over the one operation launched inside
            "optimizer_roofline_pct.train": 100 * 60000 / 3.35e12 * 2 / (4000 * SCALE * 1e-6)}
    for name, value in want.items():
        reader = run.load_file_module(os.path.join(run.HERE, "metrics", f"{name}.py"), "m")
        assert reader.read(r) == pytest.approx(value, rel=1e-9), name


def test_a_program_without_spans_gives_no_reading(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    r = _readings()
    assert spans.charged(r) is None
    for name in ("sampler_idle_ms.sample", "optimizer_roofline_pct.train"):
        reader = run.load_file_module(os.path.join(run.HERE, "metrics", f"{name}.py"), "m")
        assert reader.read(r) is None
    assert spans.charged({"measured": {}}) is None  # an untraced run


def test_the_ports_spans_are_read():
    import torch  # noqa: PLC0415

    from minimagen_tpu_torch.utils import profiling  # noqa: PLC0415

    profiling.drain_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("outer"), profiling.span("inner"):
            pass
    got = spans.program_spans()
    assert [(s.name, s.parent) for s in got] == [("outer", None), ("inner", 0)]
    assert spans.program_spans() == []
