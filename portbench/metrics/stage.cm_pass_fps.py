"""stage.cm_pass_fps: source frames over the span of
pipeline/cm_stage.scan_video_file as TranscodePipeline._analyze_video_file
calls it (the CM pass's one streaming pass: decode, upload, scene metrics,
K3 logo scoring). None where no CM pass ran (no logo file given)."""


def read(run):
    spans = run.spans_of("cm_pass")
    secs = sum(s.t1 - s.t0 for s in spans)
    return sum(s.frames for s in spans) / secs if secs > 0 else None
