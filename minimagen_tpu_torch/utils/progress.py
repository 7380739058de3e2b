"""Progress readout of the sampling loop (counterpart of
``minimagen_tpu/utils/progress.py``, copied: the port imports nothing of the
JAX package).

A tqdm-style bar with no dependency: an in-place carriage-return bar on a
TTY, throttled plain lines otherwise. ``Imagen.sample(progress=True)`` ticks
it once per U-Net call.
"""
from __future__ import annotations

import sys
import time
from typing import Optional


class ProgressBar:
    """tqdm-style progress readout: ``desc: 37/100 [12.3 it/s, eta 0:05]``.

    :param total: total number of iterations (None = unknown; shows count+rate).
    :param desc: label prefix.
    :param stream: output stream (default stderr, like tqdm).
    :param min_interval: minimum seconds between repaints (throttle).
    """

    def __init__(self, total: Optional[int] = None, desc: str = "",
                 stream=None, min_interval: float = 0.1):
        self.total = total
        self.desc = desc
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self.n = 0
        self._start = time.perf_counter()
        self._last_paint = 0.0
        self._isatty = bool(getattr(self.stream, "isatty", lambda: False)())
        self._closed = False

    def _format(self) -> str:
        elapsed = max(time.perf_counter() - self._start, 1e-9)
        rate = self.n / elapsed
        if self.total:
            frac = min(self.n / self.total, 1.0)
            eta = (self.total - self.n) / rate if rate > 0 else float("inf")
            eta_s = f"{int(eta // 60)}:{int(eta % 60):02d}" if eta != float("inf") else "?"
            width = 20
            filled = int(frac * width)
            bar = "#" * filled + "-" * (width - filled)
            return (f"{self.desc}: {int(frac * 100):3d}%|{bar}| "
                    f"{self.n}/{self.total} [{rate:.2f} it/s, eta {eta_s}]")
        return f"{self.desc}: {self.n} it [{rate:.2f} it/s]"

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.perf_counter()
        done = self.total is not None and self.n >= self.total
        if not done and now - self._last_paint < self.min_interval:
            return
        self._last_paint = now
        if self._isatty:
            self.stream.write("\r" + self._format())
            if done:
                self.stream.write("\n")
            self.stream.flush()
        else:
            # non-tty: print at most every 10% (or every update when total unknown
            # is throttled by min_interval only)
            if self.total:
                step = max(self.total // 10, 1)
                if self.n % step == 0 or done:
                    self.stream.write(self._format() + "\n")
                    self.stream.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._isatty and self.n and not (self.total is not None and self.n >= self.total):
            self.stream.write("\r" + self._format() + "\n")
            self.stream.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def progress_iter(iterable, total: Optional[int] = None, desc: str = ""):
    """Wrap an iterable with a ProgressBar (tqdm-call-style convenience)."""
    if total is None:
        try:
            total = len(iterable)
        except TypeError:
            total = None
    bar = ProgressBar(total=total, desc=desc)
    try:
        for item in iterable:
            yield item
            bar.update()
    finally:
        bar.close()
