"""The measured window: whole recordings, a closed loop per slot.

The first recording of each slot starts when the window opens. When a
slot's recording ends, the slot starts another only while that
recording's duration still fits inside the window's seconds; at least
`minimum` recordings always run. The rate is the source frames of every
recording over the wall time from the window's start to the last
recording's end."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Recording:
    index: int
    frames: int
    start: float
    end: float = 0.0
    result: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def may_start(elapsed: float, last_seconds: float | None, seconds: float,
              started: int, minimum: int) -> bool:
    """Whether a slot whose last recording took `last_seconds` (None: it
    has run none) starts another `elapsed` seconds into the window."""
    if started < minimum or last_seconds is None:
        return True
    return elapsed + last_seconds <= seconds


@dataclass
class Window:
    start: float
    recordings: list

    @property
    def end(self) -> float:
        return max(r.end for r in self.recordings)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def frames(self) -> int:
        return sum(r.frames for r in self.recordings)

    @property
    def fps(self) -> float:
        return self.frames / self.seconds


def run_sequential(run_one, frames: int, seconds: float, clock,
                   minimum: int = 1) -> Window:
    """One recording after another: run_one(index) runs it to its end and
    returns its result."""
    t0 = clock()
    recs = []
    while may_start(clock() - t0, recs[-1].seconds if recs else None,
                    seconds, len(recs), minimum):
        r = Recording(len(recs), frames, clock())
        r.result = run_one(r.index)
        r.end = clock()
        recs.append(r)
    return Window(t0, recs)
