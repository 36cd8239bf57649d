"""The per-output-file filter stage: logo match -> erase -> analysis ->
output synthesis.

Counterpart of the filter part of amatsukaze_tpu/pipeline/transcode.py:
the logo matching of the CM analysis pass (LogoFrameMatcher.scan_frames,
select_logo, fade_curve), then `_encode_one` (LogoEraser, FilterGraph
analyze, output_spec) and `_pump_filtered` (per-plane batches through the
filter graph). The filtered frames go to a caller-supplied sink instead of
an encoder pump.

    result = run_filter_stage(ctx, open_frames, num_frames, fmt, logos,
                              "kfm_vfr", sink)

`open_frames()` returns a fresh iterator of (Y, U, V) uint8 planes of the
file's frames; it is opened three times (logo match, analysis, output), as
the JAX pipeline decodes the source once per pass.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..models.filter_graph import FilterGraph, FilterOutput, normalize_u8
from ..models.logo import LogoFrameMatcher
from ..models.logo_erase import LogoEraser


@dataclass
class FilterStageResult:
    matcher: LogoFrameMatcher | None
    best_logo: int
    fade: np.ndarray | None
    graph: FilterGraph
    spec: FilterOutput
    num_out_frames: int  # frames handed to the sink
    # wall seconds of each pass over the clip; each ends in a device fetch
    seconds: dict = field(default_factory=dict)


# the reference's AMTAnalyzeLogo fade sweep, from which the erase fades come;
# without an erase the two end points are enough to pick the logo
FADE_STEPS = 11
FADE_STEPS_NO_DELOGO = 2
HEAD_RAMP = 8  # frames of the first chunk of the output pass


def run_filter_stage(ctx, open_frames, num_frames: int, fmt, logos: list,
                     mode: str, sink, batch: int = 32, device=None,
                     no_delogo: bool = False,
                     kfm_ucf: bool = True) -> FilterStageResult:
    """Run the filter core over one output file and call `sink((y, u, v))`
    with every output frame (uint8 planes), in order.

    logos: candidate LogoData of the service (may be empty); the
    best-matching one is erased with the matcher's fade curve. With
    `no_delogo` the matcher sweeps only the two end fades and nothing is
    erased; the selected logo and its fade curve are still returned.
    `kfm_ucf` is FilterGraph.kfm_ucf."""
    seconds = {}
    t0 = time.perf_counter()
    matcher = None
    best = -1
    fade = None
    entries = []
    if logos:
        matcher = LogoFrameMatcher(ctx, logos, device=device)
        matcher.scan_frames((planes[0] for planes in open_frames()),
                            fmt.width, fmt.height, fmt.frame_rate,
                            batch=batch,
                            fade_steps=(FADE_STEPS_NO_DELOGO if no_delogo
                                        else FADE_STEPS))
        if matcher.num_frames:
            best = matcher.select_logo()
            fade = matcher.fade_curve()
            if not no_delogo:
                entries.append((logos[best], fade))
    eraser = LogoEraser(ctx, entries, fmt.width, fmt.height, device=device)
    seconds["logo_match"] = time.perf_counter() - t0

    def filtered_frames():
        src = open_frames()
        if eraser:
            return eraser.erase_iter(src, batch)
        return (tuple(normalize_u8(p) for p in planes) for planes in src)

    t0 = time.perf_counter()
    fg = FilterGraph(ctx, mode=mode, batch=batch, device=device)
    fg.kfm_ucf = kfm_ucf
    if fg.mode in FilterGraph.KFM_FAMILY:
        fg.analyze((planes[0] for planes in filtered_frames()), num_frames)
    spec = fg.output_spec(num_frames, fmt)
    seconds["analysis"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_out = pump_filtered(fg, filtered_frames(), sink, batch)
    seconds["output"] = time.perf_counter() - t0
    return FilterStageResult(matcher, best, fade, fg, spec, n_out, seconds)


def pump_filtered(fg: FilterGraph, frames_iter, sink, batch: int) -> int:
    """Batch the frames through the filter graph, per plane (Y/U/V run the
    same ops at their own resolutions), and feed the sink. Batch k is
    fetched from the device only after batch k+1's work is enqueued.
    Returns the number of frames handed to the sink."""
    buf: list = []
    prev_planes = None  # last source frame of the previous batch
    start = 0
    pending = None
    emitted = 0

    def emit(outs):
        nonlocal emitted
        mats = [o.materialize() for o in outs]
        for k in range(len(mats[0])):
            sink(tuple(m[k] for m in mats))
        emitted += len(mats[0])

    def flush(chunk, next_planes):
        nonlocal prev_planes, start, pending
        if not chunk:
            return
        outs = []
        for p in range(3):
            arr = np.stack([f[p] for f in chunk])
            prev = None if prev_planes is None else prev_planes[p]
            if fg.mode in FilterGraph.KFM_FAMILY:
                outs.append(fg.run_kfm_batch(arr, prev, start))
            else:
                outs.append(fg.run_pass3(
                    arr, prev, None if next_planes is None else next_planes[p]))
        prev_planes = chunk[-1]
        start += len(chunk)
        if pending is not None:
            emit(pending)
        pending = outs

    # head ramp: a small first chunk, so that the consumer starts after
    # HEAD_RAMP frames instead of a full batch. The reference pads that
    # chunk to the batch size with copies of its last frame before the halo
    # frame goes on, so that frame's next frame is itself; passing no next
    # frame gives the same output.
    ramp = min(HEAD_RAMP, batch)
    for planes in frames_iter:
        buf.append(planes)
        if start == 0 and pending is None and ramp < batch \
                and len(buf) > ramp:
            flush(buf[:ramp], None)
            buf = buf[ramp:]
        elif len(buf) > batch:  # keep one lookahead frame (yadif halo)
            flush(buf[:batch], buf[batch])
            buf = buf[batch:]
    flush(buf, None)
    if pending is not None:
        emit(pending)
    return emitted
