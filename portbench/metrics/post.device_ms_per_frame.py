"""post.device_ms_per_frame: the device time of the post chain and the
resize (the program's counters post.deblock_s, post.nr_s, post.deband_s,
post.edge_s and post.resize_s: CUDA events around each stage of each
batch and plane, summed over the window's recordings) over the window's
source frames, in ms. None where the program records none of them."""

from pb.program_trace import counter, traces
from pb.roofline_post import STAGES

COUNTERS = tuple(f"post.{s}_s" for s in STAGES)


def read(run):
    if not any(c in tr["counters"] for tr in traces(run) for c in COUNTERS):
        return None
    secs = sum(counter(run, c) for c in COUNTERS)
    return 1e3 * secs / run.source_frames
