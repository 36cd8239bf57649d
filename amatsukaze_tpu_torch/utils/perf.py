"""Stopwatch + rolling fps reporter (reference: Amatsukaze/PerformanceUtil.hpp:12-124).

The port's copy of amatsukaze_tpu/utils/perf.py.
"""

from __future__ import annotations

import time
from collections import deque


class Stopwatch:
    def __init__(self):
        self._acc = 0.0
        self._start = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            self._acc += time.perf_counter() - self._start
            self._start = None
        return self._acc

    def getandreset(self) -> float:
        v = self.stop()
        self._acc = 0.0
        return v

    def elapsed(self) -> float:
        acc = self._acc
        if self._start is not None:
            acc += time.perf_counter() - self._start
        return acc


class FpsPrinter:
    """Rolling fps meter; calls `report(fps)` at most once per interval."""

    def __init__(self, interval_s: float = 2.0, window: int = 16, report=None):
        self.interval = interval_s
        self.report = report or (lambda fps: None)
        self._marks = deque(maxlen=window)
        self._count = 0
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()
        self._marks.clear()
        self._marks.append((self._last, 0))
        self._count = 0

    def update(self, nframes: int = 1) -> None:
        self._count += nframes
        now = time.perf_counter()
        if self._last is None:
            self.start()
            return
        if now - self._last >= self.interval:
            t0, c0 = self._marks[0]
            if now > t0:
                self.report((self._count - c0) / (now - t0))
            self._marks.append((now, self._count))
            self._last = now

    def stop(self) -> None:
        self._last = None
