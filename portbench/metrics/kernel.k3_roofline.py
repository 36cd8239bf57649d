"""kernel.k3_roofline: the least time for scoring every frame of the
window's recordings against each logo file at the CM pass's 11 fades
(pb/roofline.logo_scores), bound by operations, over the device time of
the kernels that carry it: ops/csrc/logo_eval.cu's logo_eval_kernel."""

from pb import roofline

KERNELS = ("logo_eval_kernel",)


def read(run):
    if not run.truth["logos_given"]:
        return None
    secs = roofline.kernel_seconds(run, lambda n: "logo_eval_kernel" in n)
    if secs is None:
        return None
    _, _, lw, lh = run.geometry["logo_box"]
    least = roofline.logo_scores(run.source_frames, len(run.rec["logos"]),
                                 lh, lw)
    return 100.0 * least / secs
