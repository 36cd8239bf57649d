"""The port's tracing: one Trace per recording, and the rolling fps reporter
(reference: Amatsukaze/PerformanceUtil.hpp:57-124).

A Trace holds the spans and counters of one recording in memory:

- a span is a named interval on the `time.perf_counter()` clock with its
  parent span, the recording's id and optional `frames` and attributes.
  The parent is the innermost span open on the same thread, the recording's
  root span on a thread with none open, or the one given (for work handed
  to a worker thread);
- a counter is a named sum (bytes, frames, seconds), added from any thread.

The recording's trace travels on its AMTContext (`ctx.trace`) and goes into
the report as `{"clock": "perf_counter", "spans": [...], "counters":
{...}}`. Spans are recorded per phase, never per batch, frame or packet,
so their number does not grow with the recording's length; what happens
per frame inside a phase is summed into an attribute of its span
(`waited`: the pass's waits on its source, as `input_wait_s`).

    with ctx.trace.span("filter.analysis", frames=n):
        ...
    ctx.trace.add("d2h.bytes", arr.nbytes)

A StageTimer sums the device time of named stages of work that the host
only enqueues (the post chain per batch and plane): CUDA event pairs on a
CUDA device, read once when the work is done, so that timing adds no
synchronisation; the host clock on the CPU, where the work is done when
the call returns.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

CLOCK = "perf_counter"
ROOT = "recording"


class Span:
    """One span; as a context manager it ends when the block does."""

    __slots__ = ("id", "name", "t0", "t1", "parent", "frames", "attrs",
                 "_trace")

    def __init__(self, trace, sid: int, name: str, t0: float, parent,
                 frames=None, attrs=None):
        self._trace = trace
        self.id = sid
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.parent = parent
        self.frames = frames
        self.attrs = attrs

    @property
    def seconds(self) -> float:
        return (time.perf_counter() if self.t1 is None else self.t1) - self.t0

    def add(self, key: str, value) -> None:
        """Add `value` to the attribute `key` (from the span's thread)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = self.attrs.get(key, 0) + value

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self._trace.end(self)


class Trace:
    """Spans and counters of one recording (see the module's docstring).
    timed_iter adds to its counters every ADD_EVERY items."""

    ADD_EVERY = 32

    def __init__(self, recording: str | None = None):
        self.recording = recording or uuid.uuid4().hex[:16]
        self.spans: list[Span] = []
        self.counters: dict[str, float] = {}
        self.root: Span | None = None
        self._next_id = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- spans ----------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Span | None:
        """The innermost span open on this thread, else the root."""
        stack = self._stack()
        return stack[-1] if stack else self.root

    def _new(self, name: str, parent, frames, attrs) -> Span:
        with self._lock:
            s = Span(self, self._next_id, name, time.perf_counter(),
                     None if parent is None else parent.id, frames,
                     attrs or None)
            self._next_id += 1
            self.spans.append(s)
        return s

    def open_root(self) -> Span:
        """Open the recording's root span (when its context is made)."""
        self.root = self._new(ROOT, None, None, None)
        return self.root

    def close_root(self) -> None:
        if self.root is not None and self.root.t1 is None:
            self.root.t1 = time.perf_counter()

    def begin(self, name: str, parent: Span | None = None, frames=None,
              **attrs) -> Span:
        """Open a span on this thread; `parent` defaults to current()."""
        stack = self._stack()
        if parent is None:
            parent = stack[-1] if stack else self.root
        s = self._new(name, parent, frames, attrs)
        stack.append(s)
        return s

    def end(self, s: Span) -> None:
        """Close a span begun on this thread (once; later calls do
        nothing)."""
        if s.t1 is None:
            s.t1 = time.perf_counter()
            stack = self._stack()
            if stack and stack[-1] is s:
                stack.pop()
            elif s in stack:
                stack.remove(s)

    def span(self, name: str, parent: Span | None = None, frames=None,
             **attrs) -> Span:
        """begin(); for a `with` block, which end()s it."""
        return self.begin(name, parent, frames, **attrs)

    def waited(self, it):
        """Iterate `it`, adding the seconds spent in its next() calls to the
        attribute `input_wait_s` of the span open on the consuming thread
        when the iteration starts (the pass that waits on its source). The
        items pass one at a time, as `it` gives them."""
        it = iter(it)
        span = self.current()
        clock = time.perf_counter
        waited = 0.0
        try:
            while True:
                t0 = clock()
                try:
                    item = next(it)
                except StopIteration:
                    return
                waited += clock() - t0
                yield item
        finally:
            if span is not None:
                span.add("input_wait_s", waited)

    # -- counters -------------------------------------------------------------
    def add(self, name: str, value) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def timed_iter(self, it, prefix: str):
        """Iterate `it`, adding each next() call's seconds to the counter
        `<prefix>.busy_s` and each item to `<prefix>.frames`, on the thread
        that iterates (the decoder's: the prefetch thread), every ADD_EVERY
        items and when the iteration ends or is closed."""
        it = iter(it)
        clock = time.perf_counter
        busy, n, every = 0.0, 0, self.ADD_EVERY
        try:
            while True:
                t0 = clock()
                try:
                    item = next(it)
                except StopIteration:
                    return
                busy += clock() - t0
                n += 1
                if n == every:
                    self._add_pair(prefix, busy, n)
                    busy, n = 0.0, 0
                yield item
        finally:
            if n:
                self._add_pair(prefix, busy, n)

    def _add_pair(self, prefix: str, busy: float, n: int) -> None:
        with self._lock:
            c = self.counters
            c[prefix + ".busy_s"] = c.get(prefix + ".busy_s", 0) + busy
            c[prefix + ".frames"] = c.get(prefix + ".frames", 0) + n

    # -- report ---------------------------------------------------------------
    def to_json(self) -> dict:
        spans = []
        for s in self.spans:
            d = dict(id=s.id, name=s.name, t0=s.t0, t1=s.t1, parent=s.parent,
                     recording=self.recording)
            if s.frames is not None:
                d["frames"] = s.frames
            if s.attrs:
                d["attrs"] = s.attrs
            spans.append(d)
        with self._lock:
            counters = dict(self.counters)
        return dict(clock=CLOCK, spans=spans, counters=counters)


class StageTimer:
    """Seconds of named stages of work on one device, summed per name.

        timer = StageTimer(device)
        with timer("deband"):
            x = deband(x)
        ...  # once every stage's output has been fetched
        seconds = timer.collect()  # {"deband": ...}

    On a CUDA device each stage records an event before and after it on
    the device's current stream and collect() reads their elapsed times
    (the events are done by then, so it does not wait); elsewhere a stage
    is its host time."""

    def __init__(self, device):
        self.cuda = getattr(device, "type", str(device)) == "cuda"
        self.device = device
        self._pending: list = []  # (name, start event, end event)
        self._seconds: dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        if self.cuda:
            import torch

            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            self._pending.append((name, start, end))
            return
        t0 = time.perf_counter()
        yield
        self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        self._seconds[name] = self._seconds.get(name, 0.0) + seconds

    def collect(self) -> dict:
        """The seconds of each stage timed since the last collect()."""
        for name, start, end in self._pending:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1e3)
        self._pending = []
        out, self._seconds = self._seconds, {}
        return out


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
