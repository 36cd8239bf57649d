"""Spans and counters taken from outside the program: each layer's entry
is wrapped for the length of a run (observation only), and the spans go to
an in-memory list that the per-layer readers read once the window closed.

Spans (name: what it covers):
  recording     one TranscodePipeline.run, from the CLI or a server job
  split         AMTSplitter.split (ts/, pipeline/splitter.py)
  cm_pass       cm_stage.scan_video_file as the pipeline calls it
  cm_decide     cm_stage.decide: the CM decision from what the pass found
  filter_encode TranscodePipeline._encode_one: filter analysis + encode feed
  filter        analyze_filter_stage inside it
  encode_feed   pump_output inside it (the output pass into the encoder)
  mux           the muxer runner (here: the encoder's file moved into place)
  decode        each frame taken from the decoder's iterator (the pass that
                decodes; later passes read the pipeline's frame cache)
  gate          a server job waiting at a phase gate (PhaseScheduler.wait)
Every span carries the job (the pipeline it belongs to) and, where it
has them, the source frames it covered."""

from __future__ import annotations

import threading
import time
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field
from unittest import mock


@dataclass
class Span:
    name: str
    job: int
    t0: float
    t1: float
    frames: int = 0
    info: dict = field(default_factory=dict)


class Recorder:
    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._jobs: dict[int, int] = {}  # id(pipeline or its scheduler) -> job
        # per job: its source path and what its CM pass and filter analysis
        # decided (the comparison reads these, never the spans)
        self.decisions: dict[int, dict] = {}

    def add(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def job(self) -> int:
        return getattr(self._local, "job", -1)

    @contextmanager
    def span(self, name: str, job: int | None = None, frames: int = 0):
        t0 = self.clock()
        try:
            yield
        finally:
            self.add(Span(name, self.job() if job is None else job, t0,
                          self.clock(), frames))

    def _timed_iter(self, it, job: int):
        it = iter(it)
        intervals = []
        try:
            while True:
                t0 = self.clock()
                try:
                    item = next(it)
                except StopIteration:
                    return
                intervals.append((t0, self.clock()))
                yield item
        finally:
            if intervals:
                self.add(Span("decode", job, intervals[0][0],
                              intervals[-1][1], len(intervals),
                              dict(busy=sum(b - a for a, b in intervals),
                                   intervals=intervals)))

    @contextmanager
    def patched(self):
        """Wrap the layers' entries for the duration of the block."""
        from amatsukaze_tpu_torch.parallel import scheduler
        from amatsukaze_tpu_torch.pipeline import (cm_stage, decoders,
                                                   splitter, transcode)

        rec = self
        pipe_cls = transcode.TranscodePipeline
        run0, encode0 = pipe_cls.run, pipe_cls._encode_one
        analyze_file0 = pipe_cls._analyze_video_file
        split0 = splitter.AMTSplitter.split
        scan0, decide0 = cm_stage.scan_video_file, cm_stage.decide
        mux0 = transcode._default_muxer_runner
        analyze0, pump0 = transcode.analyze_filter_stage, transcode.pump_output
        factory0 = decoders.auto_decoder_factory
        wait0 = scheduler.PhaseScheduler.wait

        def run(pipe):
            job = id(pipe)
            with rec._lock:
                rec._jobs[id(pipe.phase)] = job
                rec.decisions[job] = dict(src=pipe.settings.conf.src_file_path,
                                          cm=None, filter=None)
            rec._local.job = job
            try:
                with rec.span("recording", job):
                    return run0(pipe)
            finally:
                rec._local.job = -1

        def split(self_):
            with rec.span("split"):
                return split0(self_)

        def scan(ctx, open_frames, num_frames, *a, **kw):
            with rec.span("cm_pass", frames=num_frames):
                return scan0(ctx, open_frames, num_frames, *a, **kw)

        def decide(*a, **kw):
            with rec.span("cm_decide"):
                return decide0(*a, **kw)

        def mux(*a, **kw):
            with rec.span("mux"):
                return mux0(*a, **kw)

        def encode_one(pipe, reform, key, *a, **kw):
            n = len(reform.get_filter_source_frames(key.video))
            with rec.span("filter_encode", frames=n):
                return encode0(pipe, reform, key, *a, **kw)

        def analyze(*a, **kw):
            with rec.span("filter"):
                st = analyze0(*a, **kw)
            spec, fmt = st.spec, st.spec.out_format
            n = spec.num_out_frames
            # constant rate output carries no timecodes: its frames start
            # at multiples of the frame duration
            tc = (list(spec.time_codes[:n]) if spec.time_codes else
                  [k * 1000.0 * fmt.frame_rate_denom / fmt.frame_rate_num
                   for k in range(n)])
            rec.decisions[rec.job()]["filter"] = dict(num_out=n,
                                                      timecodes=tc)
            return st

        def analyze_file(pipe, reform, v):
            cma = analyze_file0(pipe, reform, v)
            r = cma.result
            rec.decisions[id(pipe)]["cm"] = dict(
                trims=[int(x) for x in r.trims],
                cm_zones=[[int(z.start_frame), int(z.end_frame)]
                          for z in r.cmzones],
                logo_path=r.logopath)
            return cma

        def pump(*a, **kw):
            with rec.span("encode_feed"):
                return pump0(*a, **kw)

        def factory(pipe, v):
            return rec._timed_iter(factory0(pipe, v), id(pipe))

        def wait(sched, phase):
            t0 = rec.clock()
            out = wait0(sched, phase)
            rec.add(Span("gate", rec._jobs.get(id(sched), -1), t0,
                         rec.clock(), info=dict(phase=phase)))
            return out

        with ExitStack() as stack:
            for obj, attr, fn in (
                    (pipe_cls, "run", run),
                    (pipe_cls, "_encode_one", encode_one),
                    (pipe_cls, "_analyze_video_file", analyze_file),
                    (splitter.AMTSplitter, "split", split),
                    (cm_stage, "scan_video_file", scan),
                    (cm_stage, "decide", decide),
                    (transcode, "_default_muxer_runner", mux),
                    (transcode, "analyze_filter_stage", analyze),
                    (transcode, "pump_output", pump),
                    (decoders, "auto_decoder_factory", factory),
                    (scheduler.PhaseScheduler, "wait", wait)):
                stack.enter_context(mock.patch.object(obj, attr, fn))
            yield self


def interval_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]
