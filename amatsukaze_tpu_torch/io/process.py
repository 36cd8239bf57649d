"""Subprocess drivers + the bounded producer/consumer frame pump.

Parity: ProcessThread.hpp in the reference - SubProcess/EventBaseSubProcess/
StdRedirectedSubProcess (:186-474) and DataPumpThread (:72-184). The pump's
bounded queue is what overlaps filter GetFrame with encoder stdin writes; the
reference sizes it with `-eb` (Encoder.hpp:171). Wait-time statistics
(producer blocked vs consumer idle) are kept for the encode report
(Encoder.hpp:238-239).

The port's copy of amatsukaze_tpu/io/process.py.
"""

from __future__ import annotations

import queue
import shlex
import subprocess
import threading
import time
from collections import deque


class SubProcess:
    """Spawn with piped stdin/stdout/stderr (ref SubProcess :186-320)."""

    def __init__(self, args: str | list, capture_last_lines: int = 10,
                 on_out=None, on_err=None):
        if isinstance(args, str):
            args = shlex.split(args)
        self.proc = subprocess.Popen(
            args, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        self.last_lines: deque[str] = deque(maxlen=capture_last_lines)
        self._threads = [
            threading.Thread(target=self._drain, args=(self.proc.stdout, on_out),
                             daemon=True),
            threading.Thread(target=self._drain, args=(self.proc.stderr, on_err),
                             daemon=True),
        ]
        for t in self._threads:
            t.start()

    def _drain(self, pipe, cb) -> None:
        for raw in iter(pipe.readline, b""):
            line = raw.decode("utf-8", "replace").rstrip("\r\n")
            self.last_lines.append(line)
            if cb:
                cb(line)
        pipe.close()

    @property
    def stdin(self):
        return self.proc.stdin

    def close_stdin(self) -> None:
        if self.proc.stdin and not self.proc.stdin.closed:
            self.proc.stdin.close()

    def join(self) -> int:
        self.close_stdin()
        rc = self.proc.wait()
        for t in self._threads:
            t.join(timeout=10)
        return rc

    def kill(self) -> None:
        self.proc.kill()


class DataPumpThread:
    """Bounded queue between a producer and a consumer callable
    (ref DataPumpThread :72-184). Tracks both sides' wait times."""

    _SENTINEL = object()

    def __init__(self, consume, max_items: int = 16):
        self.consume = consume
        self.q: queue.Queue = queue.Queue(maxsize=max_items)
        self.producer_wait = 0.0  # time the producer spent blocked (queue full)
        self.consumer_wait = 0.0  # time the consumer spent idle (queue empty)
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def put(self, item) -> None:
        if self.error is not None:
            raise RuntimeError("consumer failed") from self.error
        t0 = time.perf_counter()
        self.q.put(item)
        self.producer_wait += time.perf_counter() - t0

    def join(self) -> None:
        self.q.put(self._SENTINEL)
        self._thread.join()
        if self.error is not None:
            raise RuntimeError("consumer failed") from self.error

    def _run(self) -> None:
        while True:
            t0 = time.perf_counter()
            item = self.q.get()
            self.consumer_wait += time.perf_counter() - t0
            if item is self._SENTINEL:
                return
            try:
                self.consume(item)
            except BaseException as e:  # surfaced on the producer side
                self.error = e
                # drain to unblock the producer
                while True:
                    leftover = self.q.get()
                    if leftover is self._SENTINEL:
                        return


def prefetch_iter(source_iter, depth: int = 2):
    """Run `source_iter` in a background thread with a bounded queue:
    the consumer (device filtering / encoder feed) overlaps with the
    producer (host video decode) instead of serialising.

    Parity: the reference overlaps decode with filtering via FFmpeg's
    decoder threads + AviSynth Prefetch (SURVEY 2.4); here one bounded
    prefetch thread plays that role for the in-build decoder.

    Exceptions in the producer re-raise at the consumer; closing the
    generator stops the producer promptly.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    _END = object()

    def worker():
        try:
            for item in source_iter:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.2)
                    return
                except queue.Full:
                    continue
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.2)
                    return
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True,
                         name="decode-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
