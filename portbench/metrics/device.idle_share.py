"""device.idle_share: 1 - (the union of the device's kernel, copy and
memset intervals / the traced window), from torch.profiler."""

from pb.trace import busy_seconds


def read(run):
    if not run.events:
        return None
    busy = busy_seconds(run.events, run.t0, run.t1)
    return 100.0 * (1.0 - busy / (run.t1 - run.t0))
