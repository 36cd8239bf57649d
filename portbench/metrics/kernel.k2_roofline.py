"""kernel.k2_roofline: the least time for the field-match costs of every
frame of the window's recordings (pb/roofline.field_match_costs) over the
device time of the kernels that carry it: ops/csrc/yadif_fieldmatch.cu's
yadif_fieldmatch_kernel with FRAMES false and COSTS true."""

from pb import roofline

KERNELS = ("yadif_fieldmatch_kernel<FRAMES=false, COSTS=true, ...>",)


def read(run):
    secs = roofline.kernel_seconds(
        run, lambda n: roofline.yadif_mode(n) == (False, True))
    if secs is None:
        return None
    g = run.geometry
    least = roofline.field_match_costs(run.source_frames, g["height"],
                                       g["width"])
    return 100.0 * least / secs
