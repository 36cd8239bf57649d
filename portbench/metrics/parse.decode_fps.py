"""parse.decode_fps: frames the decoder's iterator gave over the time spent
inside it (its next() calls, on the prefetch thread), in whichever pass
decoded each recording (later passes read the frame cache)."""


def read(run):
    spans = run.spans_of("decode")
    busy = sum(s.info["busy"] for s in spans)
    frames = sum(s.frames for s in spans)
    return frames / busy if busy > 0 else None
