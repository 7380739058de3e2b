"""Which rows and which call a sampling run checks: the longest caption
and the last row among ``CHECK_ROWS`` rows drawn from the seed, and a call
kept with equal chance over the window's calls."""
from collections import Counter

import pytest

from portbench import run
from portbench.modes import sample
from portbench.tests import tiny


def _mode(cell, seed, b):
    w = tiny.tiny_workload(cell)
    w["captions_per_call"] = b
    ctx = run.make_context(cell, seed, workload=w, config=tiny.tiny_config(w["config"]),
                           device="cpu")
    return sample.Mode(ctx)


@pytest.mark.parametrize("b", [3, 8, 64])
def test_checked_rows(b):
    mode = _mode("lite.ddim50.c64", 2 ** 31 + 5, b)
    for call in range(6):
        rows = mode._rows(call).tolist()
        lengths = mode.sets[call % sample.CAPTION_SETS][2]
        assert len(rows) == min(sample.CHECK_ROWS, b) == len(set(rows))
        assert b - 1 in rows and max(lengths) in [lengths[r] for r in rows]
        assert rows == mode._rows(call).tolist()  # the same from the same seed


def test_kept_call_spread_over_the_window(monkeypatch):
    clock = iter(range(10 ** 6))
    monkeypatch.setattr(sample.time, "perf_counter", lambda: next(clock))
    kept = Counter()
    for seed in range(300):
        mode = _mode("lite.ddim50.c64", seed, 3)

        def call(i, keep, mode=mode):
            if keep:
                mode.record = {"call": i}

        mode.call = call
        assert mode.measure(9.5)["calls"] == 5  # two clock reads a call
        kept[mode.record["call"]] += 1
    assert set(kept) == set(range(5)) and min(kept.values()) > 300 / 5 / 2
