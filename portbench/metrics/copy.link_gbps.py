"""copy.link_gbps: the bytes the program copied between host and card (its
counters h2d.pageable_bytes, h2d.pinned_bytes and d2h.bytes, summed over
the window's recordings) over the device trace's time in HtoD and DtoH
copies inside the window, in GB/s. Without a device trace, None."""

from pb.program_trace import counter

COUNTERS = ("h2d.pageable_bytes", "h2d.pinned_bytes", "d2h.bytes")


def read(run):
    if not run.events:
        return None
    secs = sum(max(0.0, min(e.t1, run.t1) - max(e.t0, run.t0))
               for e in run.events if e.cat == "gpu_memcpy"
               and ("HtoD" in e.name or "DtoH" in e.name))
    nbytes = sum(counter(run, c) for c in COUNTERS)
    return nbytes / secs / 1e9 if secs > 0 and nbytes > 0 else None
