"""The trace reduction on a hand-made trace: busy union, attribution by
launch, the fallback for a kernel without a launch event, idle gaps."""
from portbench.trace import Trace


def _ev(cat, name, ts, dur, corr=None, tid=7):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


SPANS = {"pb.unet0": [(0, 100)], "pb.attention": [(10, 30)]}
EVENTS = [
    _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, 1, tid=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, 2, tid=1),
    _ev("kernel", "mm", 20, 10, 1),          # launched in attention
    _ev("kernel", "mmt_attn", 30, 5),       # no launch event: follows mm
    _ev("kernel", "conv", 60, 20, 2),        # launched in unet0 only
    _ev("kernel", "conv", 75, 10, None),     # overlaps: union counts it once
]


def test_busy_union_and_ranges():
    tr = Trace(EVENTS, window_s=1e-4, units=1, spans=SPANS)
    assert tr.unlinked == 2
    assert abs(tr.busy_s() - (15 + 25) * 1e-6) < 1e-12
    assert abs(tr.range_device_s("attention") - 15e-6) < 1e-12
    assert abs(tr.range_device_s("unet0") - 45e-6) < 1e-12


def test_top_ops_and_gaps():
    tr = Trace(EVENTS, window_s=1e-4, units=2, spans=SPANS)
    top = dict(tr.top_ops())
    assert abs(top["conv"] - 15e-6) < 1e-12  # per unit
    gaps = tr.idle_gaps()
    assert gaps[0][0] == "pb.unet0" and abs(gaps[0][1] - 25e-6) < 1e-12
