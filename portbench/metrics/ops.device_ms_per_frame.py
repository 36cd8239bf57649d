"""ops.device_ms_per_frame: device time of every kernel other than K1-K3
(ops/: scene metrics, erase, weave/bob/gather, the post chain, resize,
and PyTorch's own elementwise kernels) over the window's source frames,
from torch.profiler."""

KERNELS = ("yadif_fieldmatch_kernel", "logo_eval_kernel")


def read(run):
    if not run.events:
        return None
    secs = sum(min(e.t1, run.t1) - max(e.t0, run.t0) for e in run.events
               if e.cat == "kernel" and not any(k in e.name for k in KERNELS)
               and e.t1 > run.t0 and e.t0 < run.t1)
    return 1e3 * secs / run.source_frames
