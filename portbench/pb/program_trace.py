"""The program's own trace, as each recording's report carries it under
"trace" (amatsukaze_tpu_torch/utils/perf.py): spans on the perf_counter
clock, on which the window and the device trace are read too, and named
counters. A report without one (a program that records none) gives
nothing, and a reader then returns None."""

from __future__ import annotations


def traces(run) -> list:
    """The traces of the window's recordings."""
    return [r["trace"] for r in run.reports()
            if isinstance(r.get("trace"), dict)]


def inside(run, span: dict) -> float:
    """The seconds of a span inside the window."""
    return max(0.0, min(span["t1"], run.t1) - max(span["t0"], run.t0))


def spans(run, name: str) -> list:
    """The closed spans called `name` with some of their time inside the
    window, with the trace each came from."""
    return [(s, tr) for tr in traces(run) for s in tr["spans"]
            if s["name"] == name and s["t1"] is not None
            and inside(run, s) > 0]


def frame_rate(run, name: str):
    """The frames of the spans called `name` over their seconds, counting
    each span's frames in proportion to its time inside the window."""
    frames = secs = 0.0
    for s, _ in spans(run, name):
        t = inside(run, s)
        frames += s.get("frames", 0) * t / (s["t1"] - s["t0"])
        secs += t
    return frames / secs if secs > 0 and frames > 0 else None


def counter(run, name: str) -> float:
    """A counter summed over the window's recordings."""
    return sum(tr["counters"].get(name, 0) for tr in traces(run))
