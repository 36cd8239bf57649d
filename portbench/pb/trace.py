"""The device trace of a `--trace 1` run: torch.profiler over the window,
its device intervals (kernels, copies, memsets) put on the host clock by a
marker launched when the window opens, the busy time as the union of those
intervals, and the breakdown (the device operations that took most time,
the longest idle gaps named by what the host was doing)."""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass

from .probes import clip, interval_union

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host activity that names an idle gap, innermost first
HOST_ACTIVITY = ("decode", "split", "cm_decide", "cm_pass", "mux",
                 "encode_feed", "filter", "gate", "recording")


@dataclass
class DeviceEvent:
    name: str
    cat: str
    t0: float  # host perf_counter seconds
    t1: float


class Tracer:
    """profile() around the window; events() afterwards."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.mark_host = None

    def start(self, device) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(device)
        # the first device operation of the trace: its start is this host
        # instant plus the launch latency (some microseconds)
        self.mark_host = time.perf_counter()
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)

    def events(self) -> list:
        with open(self.path) as f:
            raw = json.load(f)
        os.remove(self.path)
        return device_events(raw.get("traceEvents", []), self.mark_host)


def device_events(trace_events: list, mark_host: float) -> list:
    dev = sorted((e for e in trace_events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    if not dev:
        return []
    offset = float(dev[0]["ts"]) / 1e6 - mark_host
    return [DeviceEvent(e.get("name", ""), e["cat"],
                        float(e["ts"]) / 1e6 - offset,
                        (float(e["ts"]) + float(e.get("dur", 0))) / 1e6
                        - offset) for e in dev[1:]]


def busy_seconds(events: list, t0: float, t1: float) -> float:
    return interval_union(clip([(e.t0, e.t1) for e in events], t0, t1))


def idle_gaps(events: list, t0: float, t1: float) -> list:
    """(start, end) of the stretches of [t0, t1] with no device interval."""
    gaps, at = [], t0
    for a, b in sorted(clip([(e.t0, e.t1) for e in events], t0, t1)):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def host_activity(spans, t: float) -> str:
    """What the host was doing at t: the innermost span open then."""
    for name in HOST_ACTIVITY:
        for s in spans:
            if s.name != name or not s.t0 <= t <= s.t1:
                continue
            if name != "decode":
                return name
            if any(a <= t <= b for a, b in s.info["intervals"]):
                return name
    return "between recordings"


def breakdown(events: list, spans, t0: float, t1: float,
              top: int = 10) -> dict:
    by_name: dict[str, float] = {}
    for e in events:
        d = min(e.t1, t1) - max(e.t0, t0)
        if d > 0:
            by_name[e.name] = by_name.get(e.name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(events, t0, t1), key=lambda g: g[0] - g[1])[:top]
    return dict(device_ops=[[short_name(n), s] for n, s in ops],
                idle_gaps=[[host_activity(spans, (a + b) / 2), b - a]
                           for a, b in gaps])


def short_name(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


_TEMPLATE = re.compile(r"<([^<>]*)>")


def template_flags(name: str) -> list:
    """The boolean template arguments of a demangled kernel name, in
    order ("true"/"false" or "(bool)1"/"(bool)0")."""
    m = _TEMPLATE.search(name)
    if not m:
        return []
    out = []
    for tok in m.group(1).split(","):
        tok = tok.strip()
        if tok in ("true", "(bool)1", "1"):
            out.append(True)
        elif tok in ("false", "(bool)0", "0"):
            out.append(False)
    return out
