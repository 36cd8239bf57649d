"""The least time the card could take for the work a cell asks of a
kernel: the larger of its operations over the peak rate and its bytes
over the peak memory bandwidth, every input byte read once and every
output byte written once. Peaks: NVIDIA's published H100 SXM figures (at
its 700 W limit), float32 outside the tensor cores, since the kernels
compute in float32 and integers. The byte and operation counts are
copies of chip_smoke.py's (`bound_ms`, `check_kernels`,
`check_logo_eval`), counted from the cell's shapes and frame counts, not
from launches."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # a fused multiply-add counts as two operations

LOGO_MASK_RATIO = 0.1  # masked share of the logo window (models/logo.py)
LOGO_FADES = 11  # fades the CM pass scores (pipeline/cm_stage.py)


def least_seconds(n_bytes: float, n_ops: float, fma: bool = True) -> float:
    """fma=False: every operation rounds on its own, so half the peak."""
    return max(n_bytes / HBM_BYTES_PER_S,
               n_ops / (FP32_OPS_PER_S if fma else FP32_OPS_PER_S / 2))


def yadif_frames(n_frames: int, h: int, w: int) -> float:
    """K1, frames mode: yadif of every plane of n_frames 4:2:0 frames:
    each sample read once and written once, 40 operations a sample."""
    px = n_frames * h * w * 3 // 2
    return least_seconds(2 * px, 40 * px / 2)


def field_match_costs(n_frames: int, h: int, w: int) -> float:
    """K2, costs mode: the luma of n_frames read once, three float32 costs
    a frame written, 30 operations a sample."""
    px = n_frames * h * w
    return least_seconds(px + 12 * n_frames, 30 * px / 2)


def logo_scores(n_frames: int, n_logos: int, lh: int, lw: int,
                fades: int = LOGO_FADES) -> float:
    """K3: every frame's lh x lw window scored against each logo at each
    fade: 3 operations a tap pixel for the background and 3 a tap pixel and
    fade for the blend, 106 a masked pixel and fade for the score, none
    contracted into an FMA. The tap pixels are counted as the masked ones
    alone (a lower bound of the work: the share can only read low). Bytes:
    the windows read once (uint8), the scores written once, each logo's A,
    B and compacted tables read once."""
    hw = lh * lw
    n_mask = int(hw * LOGO_MASK_RATIO)
    per = 3 * n_mask + fades * (3 * n_mask + 106 * n_mask)
    n_ops = n_frames * n_logos * per
    n_bytes = (n_frames * hw + 4 * n_frames * n_logos * fades
               + n_logos * 4 * (2 * hw + 91 * n_mask))
    return least_seconds(n_bytes, n_ops, fma=False)


def kernel_seconds(run, match) -> float | None:
    """Device seconds of the kernels whose name `match` accepts, within the
    traced window; None where none ran."""
    if not run.events:
        return None
    secs = [min(e.t1, run.t1) - max(e.t0, run.t0) for e in run.events
            if e.cat == "kernel" and match(e.name)
            and e.t1 > run.t0 and e.t0 < run.t1]
    return sum(secs) if secs else None


def yadif_mode(name: str):
    """(FRAMES, COSTS) of a yadif_fieldmatch_kernel<FRAMES, COSTS, ERASE,
    VEC, TOP> name, else None."""
    from .trace import template_flags

    if "yadif_fieldmatch_kernel" not in name:
        return None
    flags = template_flags(name)
    return tuple(flags[:2]) if len(flags) >= 2 else None
