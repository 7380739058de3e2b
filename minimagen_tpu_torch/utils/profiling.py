"""Step timing (counterpart of ``minimagen_tpu/utils/profiling.py::StepTimer``;
the rest of that module, its trace and device-time readers, is not ported
yet).

The card runs asynchronously, so a step's host time says nothing until the
card has finished it: :class:`StepTimer` synchronizes the card at the start
and the end of every timed step when it times a CUDA device.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch


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
