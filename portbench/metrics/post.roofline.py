"""post.roofline: the least time for the post chain's and the resize's
work on every source frame of the window's recordings
(pb/roofline_post.chain_seconds, from the cell's shapes and frame counts)
over the device time the program's counters post.*_s give them, in
percent. None where the program records none of them."""

from pb import roofline_post
from pb.program_trace import counter, traces

COUNTERS = tuple(f"post.{s}_s" for s in roofline_post.STAGES)


def read(run):
    if not any(c in tr["counters"] for tr in traces(run) for c in COUNTERS):
        return None
    secs = sum(counter(run, c) for c in COUNTERS)
    if secs <= 0:
        return None
    g = run.geometry
    tokens, size = roofline_post.chain_of(run.cell.config)
    least = roofline_post.chain_seconds(run.source_frames, g["height"],
                                        g["width"], tokens, size)
    return 100.0 * least / secs
