"""The per-output-file filter stage: logo erase -> analysis -> output
synthesis, fed by the CM analysis pass or by a logo pass of its own.

Counterpart of the filter part of amatsukaze_tpu/pipeline/transcode.py:
`_encode_one` (:839-956: the erase entries, LogoEraser, FilterGraph
analyze with the frame spill, the post chain, its QP maps and the resize,
output_spec, the filter dump, the v2 timecode file, the CM zones through
make_out_zones), the 10-bit rule of the encode feed (:1166-1192) and
`_pump_filtered` (per-plane batches through the filter graph, padded to
the batch as there). The filtered frames go to a caller-supplied sink
instead of an encoder pump.

    cm = run_cm_analysis(ctx, open_frames, num_frames, fmt, logos)
    result = run_filter_stage(ctx, open_frames, num_frames, fmt, logos,
                              "kfm_vfr", sink, cm=cm)

run_filter_stage is two steps, which an encoder driver calls apart because
its y4m header, timecode file and encoder arguments need the output spec
before the first frame, and a two-pass encode reads the frames twice:

    st = analyze_filter_stage(ctx, open_frames, ...)  # graph, spec, zones
    frames, bits = output_frames(st)  # once per encoder pass
    pump_output(st, frames, sink)

`open_frames()` returns a fresh iterator of (Y, U, V) uint8 planes of the
file's frames (with `video_frames`, of the whole video stream, of which
the stage keeps the selected frames after the erase). The passes over it:

- logo pass, only without `cm`: the luma stream of pipeline/cm_stage.py with
  the scene metrics off, only the logos' windows crossing to the device
  (with `cm`, the CM pass has scored the logos on its frames already);
- analysis (KFM modes): one decode and one erase; the erased frames are
  retained in host RAM (FrameSpill, the whole selection or nothing);
- output: reads the retained frames when the spill holds them all, and
  otherwise decodes and erases again, as the JAX pipeline does.

So with the spill a KFM output file costs one decode and one erase.

The steps are spans of ctx.trace: `filter.logo_match` (the logo pass and
the eraser), `filter.analysis` (the graph's analysis, the spec and its
files) and `filter.output` (each pump_output). A pass that reads the
decoder's prefetch queue sums its waits on it into its span's attribute
`input_wait_s`; the output pass sums its calls of the sink (the hand-over
to the encoder's pipe) into `sink_s`.

10-bit sources (uint16 planes): mode "none" without a logo to erase keeps
the 10 bits (the Main10 case: a post chain and the resize run from and to
10 bits and the sink gets uint16 planes; with neither, the planes pass
through). Every other graph filters the rounded 8-bit downconvert
((x + 2) >> 2).
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..models.filter_graph import (FilterGraph, FilterOutput,
                                   build_post_chain, make_out_zones,
                                   normalize_u8)
from ..models.logo import LogoFrameMatcher
from ..models.logo_erase import LogoEraser
from ..models.vfr import EncoderZone
from ..parallel.mesh import Mesh
from ..utils.batching import pad_tail
from .cm_stage import FADE_STEPS, FADE_STEPS_NO_DELOGO, luma_pass

HEAD_RAMP = 8  # frames of the first chunk of the output pass
CM_ZONES_MODES = ("both", "non_cm", "cm")  # the reference's CMType


@dataclass
class FilterStageResult:
    matcher: LogoFrameMatcher | None
    best_logo: int
    fade: np.ndarray | None
    graph: FilterGraph
    spec: FilterOutput
    num_out_frames: int  # frames handed to the sink
    # encoder zones of the CM zones in output frames (cm_zones_mode "both")
    zones: list = field(default_factory=list)
    spill_frames: int = 0  # frames the output pass read from the spill
    shards: int = 1  # shards of the filter graph's mesh (filter_devices)


class FrameSpill:
    """The analysis pass's output frames (post-erase, in order) retained in
    host RAM so that the output pass consumes them directly, skipping the
    second decode and erase (transcode.py:1302-1359 `_FrameSpill`; the
    reference pays the same double pass through AMTSource's frame cache).
    The unit is the whole selection: one overflow of the cap drops
    everything, since a prefix does not spare a second full pass. Only
    8-bit planes are kept."""

    def __init__(self, cap_bytes: int):
        self.cap = cap_bytes
        self.frames: list = []
        self.nbytes = 0
        self.complete = True

    def offer(self, planes) -> None:
        if not self.complete:
            return
        if any(p.dtype != np.uint8 for p in planes):
            self._drop()
            return
        # a view pins its whole base: the eraser yields per-frame views of
        # [batch, H, W] arrays, so keeping one would hold the batch and
        # defeat the cap's accounting. Copy those; keep planes whose base
        # is about their own size.
        out = []
        sz = 0
        for p in planes:
            if getattr(p.base, "nbytes", p.nbytes) > 2 * p.nbytes:
                p = np.ascontiguousarray(p)
            out.append(p)
            sz += p.nbytes
        if self.nbytes + sz > self.cap:
            self._drop()
            return
        self.frames.append(tuple(out))
        self.nbytes += sz

    def _drop(self) -> None:
        self.frames = []
        self.nbytes = 0
        self.complete = False

    def usable(self) -> bool:
        return self.complete and bool(self.frames)


def analysis_cache_cap(cap_bytes: int | None = None) -> int:
    """Spill cap (transcode.py:1362-1371 `_analysis_cache_cap`): the given
    bytes, else 1/8 of host RAM within [256 MB, 4 GB]."""
    if cap_bytes is not None:
        return cap_bytes
    try:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (OSError, ValueError, AttributeError):
        return 256 << 20
    return int(min(max(total // 8, 256 << 20), 4 << 30))


@dataclass
class FilterAnalysis:
    """What the analysis step leaves for the output passes: the graph and
    its output spec, the eraser, the frame spill (None when the output pass
    decodes again) and the encoder zones. `output_frames` and `pump_output`
    may run over it more than once (a two-pass encode)."""
    matcher: LogoFrameMatcher | None
    best_logo: int
    fade: np.ndarray | None
    graph: FilterGraph
    spec: FilterOutput
    eraser: LogoEraser
    spill: FrameSpill | None
    zones: list
    open_frames: object
    wanted: set | None  # source indices of the output file's frames
    batch: int
    shards: int
    num_frames: int  # the output file's source frames
    output_span: object = None  # pump_output's `filter.output` span


def run_filter_stage(ctx, open_frames, num_frames: int, fmt, logos: list,
                     mode: str, sink, **kw) -> FilterStageResult:
    """Run the filter core over one output file and call `sink((y, u, v))`
    with every output frame (uint8 planes; uint16 on the 10-bit path), in
    order: analyze_filter_stage (whose keywords `kw` are), then one output
    pass."""
    st = analyze_filter_stage(ctx, open_frames, num_frames, fmt, logos,
                              mode, **kw)
    frames, _ = output_frames(st)
    n_out = pump_output(st, frames, sink)
    return FilterStageResult(st.matcher, st.best_logo, st.fade, st.graph,
                             st.spec, n_out, st.zones,
                             len(st.spill.frames) if st.spill else 0,
                             st.shards)


def analyze_filter_stage(ctx, open_frames, num_frames: int, fmt, logos: list,
                         mode: str, batch: int = 32, device=None,
                         no_delogo: bool = False, kfm_ucf: bool = True,
                         cm=None, erase_logos=(),
                         cm_zones_mode: str = "both",
                         analysis_cache_bytes: int | None = None,
                         timecode_path: str | None = None,
                         dump_path: str | None = None, post_filter: str = "",
                         qp_source=None, resize=None, open_section=None,
                         autovfr_parallel: int = 2,
                         autovfr_prefix: str | None = None,
                         filter_devices=1,
                         video_frames=None) -> FilterAnalysis:
    """The stage up to its output spec: the logo pass without `cm`, the
    eraser, the graph's analysis with the frame spill, the spec, the
    timecode and dump files and the encoder zones. Its output passes are
    output_frames + pump_output.

    cm: the file's CMStageResult (pipeline/cm_stage.run_cm_analysis). Its
    best logo is erased with its fade curve (none when it ran under
    no_delogo), and its CM zones become `result.zones`. Without it, the
    stage scores `logos` (candidate LogoData, may be empty) itself, and the
    best one is erased with the matcher's fade curve; with `no_delogo` the
    matcher sweeps only the two end fades and nothing is erased (the
    selected logo and its fade curve are still returned).
    erase_logos: LogoData erased at fade 1 on every frame.
    cm_zones_mode: the output file's CM type ("both", "non_cm", "cm"); only
    "both" carries the CM zones to the encoder.
    analysis_cache_bytes: the spill's cap (default analysis_cache_cap()).
    timecode_path / dump_path: write the v2 timecode file (VFR output
    only) / the filter graph's debug_dump JSON there.
    `kfm_ucf` is FilterGraph.kfm_ucf.
    post_filter: the post chain's tokens, comma-separated ("deblock", "nr",
    "deband", "edge"; models.filter_graph.build_post_chain; unknown tokens
    raise ValueError). qp_source: a ts.qp_extract.QpMapSource of the
    file's frames for "deblock" (without one, deblock is skipped). resize:
    the output (width, height), a Lanczos3 resize after the chain.

    Mode "autovfr" analyses the source in `autovfr_parallel` sections on
    host threads (FilterGraph.analyze_autovfr; 2 is the JAX package's
    default, settings.py autovfr_parallel): open_section(start, end)
    returns an iterator of the source luma planes of frames [start, end),
    not erased, as the JAX pipeline's section opener decodes them; without
    it the stage reads open_frames() and skips forward to `start`.
    autovfr_prefix: write the sections' logs and the .def file there. The
    frame spill is not filled in this mode: the output pass decodes and
    erases again.

    filter_devices: shard the filter graph over that many devices
    (FilterGraph.set_mesh; an int or a parallel.mesh.Mesh), as
    transcode.py:849-852 does with `--devices N`; one runs unsharded.
    `result.shards` says how many shards ran.

    video_frames: the source indices of the output file's frames, when the
    file is not the whole of what open_frames() yields (a CM split, a
    format change): the fades index the source, so the stage erases every
    frame it decodes and keeps the selected ones only after the erase, as
    the JAX pipeline does (transcode.py:909-929, :1153, :1240); the CM
    zones map through it. `num_frames` is then len(video_frames)."""
    if cm_zones_mode not in CM_ZONES_MODES:
        raise ValueError(f"cm_zones_mode must be one of {CM_ZONES_MODES}")
    post_chain = build_post_chain(post_filter)
    wanted = None if video_frames is None else set(video_frames)
    trace = ctx.trace
    with trace.span("filter.logo_match"):
        entries = []
        if cm is not None:
            matcher, best, fade = cm.matcher, cm.best_logo, cm.fade
            if fade is not None:
                entries.append((matcher.logos[best], fade))
        else:
            matcher, best, fade = None, -1, None
            if logos:
                matcher = LogoFrameMatcher(ctx, logos, device=device)
                matcher.begin_scan(fmt.width, fmt.height, fmt.frame_rate,
                                   FADE_STEPS_NO_DELOGO if no_delogo
                                   else FADE_STEPS)
                # the fades index the source: score every frame up to the
                # last one selected
                luma_pass((planes[0] for planes in open_frames()),
                          num_frames if wanted is None
                          else max(wanted, default=-1) + 1,
                          batch, device, matcher, scene_metrics=False,
                          trace=trace)
                matcher.end_scan()
                if matcher.num_frames:
                    best = matcher.select_logo()
                    fade = matcher.fade_curve()
                    if not no_delogo:
                        entries.append((logos[best], fade))
        entries.extend((lg, None) for lg in erase_logos)
        eraser = LogoEraser(ctx, entries, fmt.width, fmt.height, device=device)

    with trace.span("filter.analysis", frames=num_frames):
        fg = FilterGraph(ctx, mode=mode, batch=batch, device=device,
                         post_chain=post_chain, qp_source=qp_source)
        if resize is not None:
            fg.resize = tuple(resize)
        fg.kfm_ucf = kfm_ucf
        shards = (filter_devices.size if isinstance(filter_devices, Mesh)
                  else int(filter_devices))
        if shards > 1:
            fg.set_mesh(filter_devices)
        spill = None
        if fg.mode == FilterGraph.MODE_AUTOVFR:
            fg.analyze_autovfr(open_section
                               or _forward_opener(open_frames, wanted),
                               num_frames, parallel=max(1, autovfr_parallel),
                               log_prefix=autovfr_prefix)
        elif fg.mode in FilterGraph.KFM_FAMILY:
            spill = FrameSpill(analysis_cache_cap(analysis_cache_bytes))

            def tee_y():
                for planes in _select(_erased(trace.waited(open_frames()),
                                              eraser, batch), wanted):
                    spill.offer(planes)
                    yield planes[0]

            fg.analyze(tee_y(), num_frames)
            if not spill.usable():
                spill = None
        spec = fg.output_spec(num_frames, fmt)
        if dump_path is not None:
            with open(dump_path, "w") as f:
                json.dump(fg.debug_dump(num_frames), f, indent=1)
        if timecode_path is not None and spec.time_codes:
            with open(timecode_path, "w") as f:
                f.write("# timecode format v2\n")
                # one start time per output frame (the plan also carries the
                # trailing end time)
                f.writelines(f"{tc:.6f}\n"
                             for tc in spec.time_codes[:spec.num_out_frames])
        zones = []
        if cm is not None and cm_zones_mode == "both":
            zones = [EncoderZone(z.start_frame, z.end_frame)
                     for z in cm.result.cmzones]
        if fg.mode != FilterGraph.MODE_NONE:
            zones = make_out_zones(zones, list(range(num_frames))
                                   if video_frames is None else video_frames,
                                   spec.num_out_frames, spec.time_codes,
                                   fmt.frame_rate_num, fmt.frame_rate_denom)
    return FilterAnalysis(matcher, best, fade, fg, spec, eraser, spill,
                          zones, open_frames, wanted, batch, max(1, shards),
                          num_frames)


def output_frames(st: FilterAnalysis):
    """The output pass's source frames and the bits of the frames the sink
    will get (8, or 10 for uint16 planes): the spill when it holds the
    selection; else the frames decoded again, erased, then selected.

    The 10-bit rule (transcode.py:1166-1192): uint16 planes stay 10-bit
    only in mode "none" without a logo to erase (the Main10 case: a post
    chain and the resize run from and to 10 bits; with neither, the planes
    pass through); every other graph filters the rounded 8-bit downconvert
    ((x + 2) >> 2)."""
    fg, eraser = st.graph, st.eraser
    if st.spill is not None:
        return iter(st.spill.frames), 8
    src = iter(st.open_frames())
    first = next(src, None)
    src = fg.ctx.trace.waited(
        itertools.chain(() if first is None else (first,), src))
    if (first is not None and first[0].dtype == np.uint16 and not eraser
            and fg.mode == FilterGraph.MODE_NONE):
        if fg.post_chain is not None or fg.resize is not None:
            fg.src_bits = 10
        return _select(src, st.wanted), 10
    return _select(_erased(src, eraser, st.batch), st.wanted), 8


def pump_output(st: FilterAnalysis, frames, sink) -> int:
    """One output pass of output_frames' frames through the graph into the
    sink, as the span `filter.output` (kept as st.output_span), whose
    attribute `sink_s` sums the sink's calls; returns the number of frames
    handed to the sink."""
    fg = st.graph
    clock = time.perf_counter
    with fg.ctx.trace.span("filter.output", frames=st.num_frames) as out:
        st.output_span = out

        def timed_sink(planes):
            t0 = clock()
            sink(planes)
            out.add("sink_s", clock() - t0)

        if (fg.mode == FilterGraph.MODE_NONE and fg.post_chain is None
                and fg.resize is None):
            n_out = 0
            for planes in frames:  # nothing to filter: straight to the sink
                timed_sink(planes)
                n_out += 1
            return n_out
        return pump_filtered(fg, frames, timed_sink, st.batch)


def _erased(src, eraser: LogoEraser, batch: int):
    """The frames erased (8-bit), or brought to uint8 without an eraser."""
    if eraser:
        return eraser.erase_iter(src, batch)
    return (tuple(normalize_u8(p) for p in planes) for planes in src)


def _select(src, wanted: set | None):
    """The frames whose source index is in `wanted` (all with None)."""
    if wanted is None:
        return src
    return (planes for i, planes in enumerate(src) if i in wanted)


def _forward_opener(open_frames, wanted: set | None = None):
    """A section opener over open_frames(): decode from the start, keep the
    selected frames and skip to the section (the JAX section opener's own
    fallback, transcode.py:779-788)."""

    def opener(start: int, end: int):
        start = max(0, start)
        for i, planes in enumerate(_select(open_frames(), wanted)):
            if i >= end:
                break
            if i >= start:
                yield planes[0]

    return opener


def pump_filtered(fg: FilterGraph, frames_iter, sink, batch: int) -> int:
    """Batch the frames through the filter graph, per plane (Y/U/V run the
    same ops at their own resolutions), and feed the sink. Batch k is
    fetched from the device only after batch k+1's work is enqueued.
    Returns the number of frames handed to the sink.

    Batches as the JAX package's `_pump_filtered` does, since the post
    chain sees whole batches: every chunk is padded to `batch` frames with
    repeats of its last one (only the real frames' outputs are emitted);
    the first chunk is a head ramp of 8 frames whose next frame is the
    frame after it (the padding stands between them); `start_index` runs
    on for the QP maps; the last chunk is the KFM modes' `final` one. A
    chunk may give any number of output frames, none included (svp emits
    5/2 frames per film frame, and its last call may hold only the frozen
    tail). Once the last batch is fetched, the graph's post counters go to
    the trace (FilterGraph.record_post_counters)."""
    buf: list = []
    prev_planes = None  # last source frame of the previous batch
    start = 0
    pending = None
    emitted = 0
    trace = fg.ctx.trace

    def emit(outs):
        nonlocal emitted
        mats = [o.materialize(trace) for o in outs]
        for k in range(len(mats[0])):
            sink(tuple(m[k] for m in mats))
        emitted += len(mats[0])

    def flush(chunk, next_planes):
        nonlocal prev_planes, start, pending
        if not chunk:
            return
        outs = []
        for p in range(3):
            arr, n_real = pad_tail([f[p] for f in chunk], batch)
            prev = None if prev_planes is None else prev_planes[p]
            if fg.mode in FilterGraph.KFM_FAMILY:
                outs.append(fg.run_kfm_batch(arr, prev, start, plane=p,
                                             final=next_planes is None,
                                             n_real=n_real))
                continue
            # one output per real frame, two for the double-rate modes
            outs.append(fg.run_pass3(
                arr, prev, None if next_planes is None else next_planes[p],
                start_index=start, plane=p, n_real=n_real))
        prev_planes = chunk[-1]
        start += len(chunk)
        if pending is not None:
            emit(pending)
        pending = outs

    # head ramp: a small first chunk, so that the consumer starts after
    # HEAD_RAMP frames instead of a full batch
    ramp = min(HEAD_RAMP, batch)
    for planes in frames_iter:
        buf.append(planes)
        if start == 0 and pending is None and ramp < batch \
                and len(buf) > ramp:
            flush(buf[:ramp], buf[ramp])
            buf = buf[ramp:]
        elif len(buf) > batch:  # keep one lookahead frame (yadif halo)
            flush(buf[:batch], buf[batch])
            buf = buf[batch:]
    flush(buf, None)
    if pending is not None:
        emit(pending)
    fg.record_post_counters()
    return emitted
