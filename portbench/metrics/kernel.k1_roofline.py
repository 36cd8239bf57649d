"""kernel.k1_roofline: the least time for yadif of every plane of every
source frame of the window's recordings (pb/roofline.yadif_frames) over
the device time of the kernels that carry it: ops/csrc/yadif_fieldmatch.cu's
yadif_fieldmatch_kernel with FRAMES true and COSTS false (what the yadif
mode launches, one call a plane and chunk)."""

from pb import roofline

KERNELS = ("yadif_fieldmatch_kernel<FRAMES=true, COSTS=false, ...>",)


def read(run):
    secs = roofline.kernel_seconds(
        run, lambda n: roofline.yadif_mode(n) == (True, False))
    if secs is None:
        return None
    g = run.geometry
    least = roofline.yadif_frames(run.source_frames, g["height"], g["width"])
    return 100.0 * least / secs
