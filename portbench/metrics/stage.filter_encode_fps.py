"""stage.filter_encode_fps: source frames over the span of
TranscodePipeline._encode_one (the filter analysis and the output pass
into the encoder's feed)."""


def read(run):
    spans = run.spans_of("filter_encode")
    secs = sum(s.t1 - s.t0 for s in spans)
    return sum(s.frames for s in spans) / secs if secs > 0 else None
