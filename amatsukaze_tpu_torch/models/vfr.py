"""VFR timing: timecodes from durations, base-timing-fps inference.

Counterpart of amatsukaze_tpu/models/vfr.py, cut to what the filter core
uses (parity: Amatsukaze/FilteredSource.hpp:163-212). The bitrate-zone
machinery waits with the encoder layers. EncoderZone is cm_analyze's, as
in the JAX package.
"""

from __future__ import annotations

from .cm_analyze import EncoderZone  # noqa: F401  (models.vfr.EncoderZone)


def infer_vfr_timing_fps(timecodes: list[float], default: int = 60) -> int:
    """Pick the base fps in {60, 120, 240} minimising quantisation error
    (ref readTimecode :192-212)."""
    if not timecodes:
        return default
    best_fps = default
    min_diff = timecodes[-1]
    epsilon = len(timecodes) * 10e-10
    for fps in (60, 120, 240):
        mult = fps / 1001.0
        inv = 1.0 / mult
        diff = sum(abs(inv * round(ts * mult) - ts) for ts in timecodes)
        if diff < min_diff - epsilon:
            best_fps = fps
            min_diff = diff
    return best_fps


def make_timecodes_from_durations(durations: list[int], fps_num: int,
                                  fps_denom: int) -> list[float]:
    """Output-frame start times in ms for a duration list over a base clock."""
    tick = 1000.0 * fps_denom / fps_num
    out = [0.0]
    for d in durations:
        out.append(out[-1] + d * tick)
    return out
