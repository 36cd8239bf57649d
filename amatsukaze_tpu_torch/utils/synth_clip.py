"""Synthetic broadcast-like clips, from numpy alone.

A panning film source, 3:2 hard-telecined, then true interlaced video (every
field its own instant), Y/U/V at 4:2:0, a rendered logo painted on from
`logo_from` on and mild noise from ``np.random.default_rng(seed)``. The
picture is computed in float64 and the noise from integer draws only, so
that the same seed gives the same bytes on every machine (a float32 sine
differs in its last bit between numpy builds, which would flip rounded
pixels), and results recorded from one package on one machine can be held
against another package on another (testdata/golden_stage.json, written by
tests/test_torch_golden.py).
"""

from __future__ import annotations

import numpy as np

from ..models.lgd import LogoData, LogoHeader
from ..types import VideoFormat

LOGO_COLORS = (200.0, 90.0, 170.0)  # Y, U, V of the painted logo
NOISE_SCALE = 0.6 / (4 * (256 ** 2 - 1) / 12) ** 0.5

# The clips whose results are recorded: name -> make_clip arguments, the
# logo geometry and the stage's batch size. "broadcast" crosses the batch
# edge and the analysis carry twice at the full 1440x1080 geometry.
GOLDEN_CLIPS = {
    "small": dict(n_film=30, n_video=15, h=96, w=128, lh=16, lw=24, lx=96,
                  ly=8, seed=3, batch=8),
    "broadcast": dict(n_film=30, n_video=15, h=1080, w=1440, lh=96, lw=256,
                      lx=1120, ly=40, seed=1, batch=16),
}


def logo_alpha(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot((yy - h / 2) / (h / 2), (xx - w / 2) / (w / 2))
    return (np.clip(1.2 - r, 0, 1) * 0.35).astype(np.float32)


def _ab(alpha: np.ndarray, color: float):
    return ((1.0 / (1.0 - alpha)).astype(np.float32),
            (-alpha * color / (1.0 - alpha) / 255.0).astype(np.float32))


def make_logos(h, w, lh, lw, lx, ly) -> list[LogoData]:
    """The logo painted on the clip and a decoy that never matches."""
    logo = LogoData.create(LogoHeader(lw, lh, 1, 1, w, h, lx, ly, "synth", 1))
    logo.a_y, logo.b_y = _ab(logo_alpha(lh, lw), LOGO_COLORS[0])
    logo.a_u, logo.b_u = _ab(logo_alpha(lh // 2, lw // 2), LOGO_COLORS[1])
    logo.a_v, logo.b_v = _ab(logo_alpha(lh // 2, lw // 2), LOGO_COLORS[2])
    decoy = LogoData.create(LogoHeader(lw, lh, 1, 1, w, h, lx, ly, "decoy", 2))
    stripes = np.zeros((lh, lw), np.float32)
    stripes[4:-4, 4:-4] = 0.3 * ((np.arange(lw - 8) // 6) % 2)
    decoy.a_y, decoy.b_y = _ab(stripes, 60.0)
    return [logo, decoy]


def video_format(h: int, w: int) -> VideoFormat:
    return VideoFormat(width=w, height=h, frame_rate_num=30000,
                       frame_rate_denom=1001)


def make_clip(n_film, n_video, h, w, lh, lw, lx, ly, seed, logo_from=20,
              dirty_frames=()):
    """List of (Y, U, V) uint8 planes: `n_film` coded frames of a panning
    film source, 3:2 hard-telecined, then `n_video` frames of interlaced
    video. Frames in `dirty_frames` get a bottom field from far away in
    time (a broadcast edit that breaks the pulldown: their weave combs
    whatever the pairing)."""
    rng = np.random.default_rng(seed)
    # rows, cols, period, amplitude, base, chroma subsampling
    geoms = [(h, w, 7.0, 80.0, 120.0, 1),
             (h // 2, w // 2, 5.0, 30.0, 128.0, 2),
             (h // 2, w // 2, 6.0, 30.0, 128.0, 2)]

    def film(t, gh, gw, period, amp, base, sub):
        yy = np.arange(gh, dtype=np.float64)[:, None]
        xx = np.arange(gw, dtype=np.float64)[None, :]
        pan = 6.0 / sub * t
        return (base + amp * np.sin((xx + pan) / period) * np.cos(yy / 9.0)
                + 0.25 * amp * np.sin((xx * 0.37 + yy * 0.61) / period))

    # (top time, bottom time) per coded frame
    times = []
    i = 0
    while len(times) < n_film:
        a, b, c, d = i, i + 1, i + 2, i + 3
        times += [(a, a), (a, b), (b, c), (c, c), (d, d)]
        i += 4
    times = times[:n_film]
    times += [(i + 2.5 * k, i + 2.5 * k + 1.25) for k in range(n_video)]
    alphas = [logo_alpha(lh // g[5], lw // g[5]) for g in geoms]
    frames = []
    for k, (tt, tb) in enumerate(times):
        if k in dirty_frames:
            tb = tt + 40.5
        planes = []
        for p, g in enumerate(geoms):
            f = film(tt, *g)
            if tb != tt:
                f[1::2] = film(tb, *g)[1::2]
            if k >= logo_from:
                al = alphas[p]
                y0, x0 = ly // g[5], lx // g[5]
                win = f[y0:y0 + al.shape[0], x0:x0 + al.shape[1]]
                win *= 1 - al
                win += al * LOGO_COLORS[p]
            # sum of four uniform bytes: near-normal, sd 0.6
            draws = rng.integers(0, 256, (4,) + f.shape, dtype=np.uint8)
            f += (draws.sum(axis=0, dtype=np.int32) - 510) * NOISE_SCALE
            planes.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
        frames.append(tuple(planes))
    return frames


def golden_clip(name: str):
    """(frames, format, logos, batch) of one recorded clip."""
    spec = dict(GOLDEN_CLIPS[name])
    batch = spec.pop("batch")
    geom = {k: spec[k] for k in ("h", "w", "lh", "lw", "lx", "ly")}
    return (make_clip(**spec), video_format(spec["h"], spec["w"]),
            make_logos(**geom), batch)
