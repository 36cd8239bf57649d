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

The broadcast layout of the CM analysis (make_broadcast_clip,
make_broadcast_pcm) is made the same way: program, CM, program, with scene
cuts, the logo on in the program parts and near-silence on the CM cuts, so
that the decisions have a known truth (BROADCAST_TRUTH); its results are
recorded in testdata/golden_cm.json (tests/test_torch_cm_stage.py).
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


# ---------------------------------------------------------------------------
# the broadcast layout of the CM analysis: program, CM, program
# ---------------------------------------------------------------------------

BROADCAST_FRAMES = 1340
CM_START, CM_END = 450, 900  # one 15.015 s CM unit
PROGRAM_CUT = 210  # a cut inside the first program part, with no silence
SILENCE_SECONDS = 0.5  # of near-silence centred on each CM cut
PCM_RATE = 48000  # stereo, interleaved int16
NOISE_SLACK = 64
# per scene: first frame, film (3:2 telecined) or interlaced video, logo
# painted, and (base, amplitude, period, row period) of Y, U and V. The
# scenes' luma ranges barely overlap, so each cut moves the mean absolute
# difference far over 30 and the histogram correlation far under 0.85,
# while a scene pans by one or two pixels a field, far under both. The
# logo (blended toward 200) stands out on the program scenes, and the CM
# is darker still, so that nothing in it looks like the logo, at both
# sizes.
BROADCAST_SCENES = (
    (0, True, True, ((60.0, 25.0, 9.0, 11.0), (110.0, 12.0, 6.0, 7.0),
                     (140.0, 12.0, 7.0, 5.0))),
    (PROGRAM_CUT, True, True, ((110.0, 25.0, 12.0, 8.0),
                               (140.0, 14.0, 5.0, 9.0),
                               (100.0, 14.0, 8.0, 6.0))),
    (CM_START, False, False, ((25.0, 12.0, 7.0, 13.0),
                              (90.0, 16.0, 9.0, 5.0),
                              (170.0, 16.0, 5.0, 8.0))),
    (CM_END, True, True, ((75.0, 25.0, 10.0, 9.0), (125.0, 10.0, 7.0, 6.0),
                          (120.0, 10.0, 6.0, 7.0))),
)
# the recorded (96x128) and the card's (1440x1080) sizes of the layout
BROADCAST_CLIPS = {
    "small": dict(h=96, w=128, lh=16, lw=24, lx=96, ly=8, seed=5),
    "broadcast": dict(h=1080, w=1440, lh=96, lw=256, lx=1120, ly=40,
                      seed=1),
}
BROADCAST_TRUTH = dict(trims=[0, CM_START, CM_END, BROADCAST_FRAMES],
                       cm_zones=[(CM_START, CM_END)],
                       scene_changes=[PROGRAM_CUT, CM_START, CM_END])


def _scene_fields(first: int, end: int, film: bool) -> list:
    """(top offset, bottom offset) in pixels of pan, per coded frame of a
    scene: 3:2 telecined film moves two pixels a film frame, interlaced
    video one pixel a field."""
    n = end - first
    if not film:
        return [(2 * k, 2 * k + 1) for k in range(n)]
    out = []
    f = 0
    while len(out) < n:
        a, b, c, d = (2 * (f + i) for i in range(4))
        out += [(a, a), (a, b), (b, c), (c, c), (d, d)]
        f += 4
    return out[:n]


def _texture(h: int, w: int, base, amp, period, row_period) -> np.ndarray:
    """A still picture wider than the frame, panned through by offset,
    rounded to int16 (float64 arithmetic only)."""
    yy = np.arange(h, dtype=np.float64)[:, None]
    xx = np.arange(w, dtype=np.float64)[None, :]
    t = (base + amp * np.sin(xx / period) * np.cos(yy / row_period)
         + 0.25 * amp * np.sin((xx * 0.37 + yy * 0.61) / period))
    return np.rint(t).astype(np.int16)


def make_broadcast_clip(h, w, lh, lw, lx, ly, seed,
                        scenes=BROADCAST_SCENES,
                        num_frames=BROADCAST_FRAMES):
    """Yield (Y, U, V) uint8 planes of the seeded broadcast layout, one
    frame at a time (a 1440x1080 clip never sits whole in host RAM), at
    30000/1001 fps: program [0, 450) with the logo painted (a cut at 210),
    CM [450, 900) without it, program [900, 1340) with it (BROADCAST_SCENES).
    Every call yields the same bytes. Other `scenes` (entries as in
    BROADCAST_SCENES) and `num_frames` lay out a clip of other cuts."""
    rng = np.random.default_rng((seed, 0))
    subs = (1, 2, 2)
    alphas = [logo_alpha(lh // s, lw // s).astype(np.float64) for s in subs]
    # noise in {-1, 0, 1}: a pool per plane drawn once, each frame's noise
    # a window of it at a seeded offset (drawing 2 M values a frame would
    # take most of the generator's time)
    pools = [rng.integers(-1, 2, (h // s + NOISE_SLACK, w // s + NOISE_SLACK),
                          dtype=np.int16) for s in subs]
    bounds = [s[0] for s in scenes] + [num_frames]
    for (first, film, logo, params), end in zip(scenes, bounds[1:]):
        fields = _scene_fields(first, end, film)
        reach = fields[-1][1] + 1
        textures = [_texture(h // s, w // s + reach // s + 1, *p)
                    for s, p in zip(subs, params)]
        for top, bottom in fields:
            planes = []
            for p, (sub, tex) in enumerate(zip(subs, textures)):
                gw = w // sub
                f = tex[:, top // sub : top // sub + gw].copy()
                if bottom != top:
                    f[1::2] = tex[1::2, bottom // sub : bottom // sub + gw]
                if logo:
                    y0, x0 = ly // sub, lx // sub
                    al = alphas[p]
                    win = f[y0 : y0 + al.shape[0], x0 : x0 + al.shape[1]]
                    win[:] = np.rint(win * (1.0 - al) + al * LOGO_COLORS[p])
                dy, dx = rng.integers(0, NOISE_SLACK, 2)
                f += pools[p][dy : dy + f.shape[0], dx : dx + f.shape[1]]
                planes.append(np.clip(f, 0, 255).astype(np.uint8))
            yield tuple(planes)


def make_broadcast_pcm(seed) -> np.ndarray:
    """Interleaved stereo int16 PCM at 48 kHz for the broadcast layout:
    uniform noise at 0.3 of full scale, with SILENCE_SECONDS of
    near-silence (0.001 of full scale) centred on each CM cut."""
    rng = np.random.default_rng((seed, 1))
    n = round(BROADCAST_FRAMES * 1001 / 30000 * PCM_RATE)
    loud, quiet = round(0.3 * 32767), round(0.001 * 32767)
    pcm = rng.integers(-loud, loud + 1, (n, 2), dtype=np.int16)
    for cut in (CM_START, CM_END):
        mid = cut * 1001 / 30000 * PCM_RATE
        a = round(mid - SILENCE_SECONDS / 2 * PCM_RATE)
        b = round(mid + SILENCE_SECONDS / 2 * PCM_RATE)
        pcm[a:b] = rng.integers(-quiet, quiet + 1, (b - a, 2), dtype=np.int16)
    return pcm.reshape(-1)


def broadcast_clip(name: str):
    """(open_frames, num_frames, format, logos, pcm) of one size of the
    broadcast layout; open_frames() starts a fresh lazy pass."""
    spec = BROADCAST_CLIPS[name]
    geom = {k: spec[k] for k in ("h", "w", "lh", "lw", "lx", "ly")}

    def open_frames():
        return make_broadcast_clip(**spec)

    return (open_frames, BROADCAST_FRAMES, video_format(spec["h"], spec["w"]),
            make_logos(**geom), make_broadcast_pcm(spec["seed"]))


# ---------------------------------------------------------------------------
# inputs of the post chain: QP maps and 10-bit frames
# ---------------------------------------------------------------------------

def qp_maps(n: int, seed: int, mb_h: int = 68, mb_w: int = 90) -> list:
    """`n` per-frame macroblock QP maps [mb_h, mb_w] (uint8 values 2-31,
    the MPEG-2 quantiser scales a broadcast encoder uses), seeded. The
    defaults cover a 1440x1080 frame (1088 / 16 rows, 1440 / 16 columns)."""
    rng = np.random.default_rng((seed, 2))
    return [rng.integers(2, 32, (mb_h, mb_w), dtype=np.uint8)
            for _ in range(n)]


def to_10bit(frames: list, seed: int) -> list:
    """The 8-bit (Y, U, V) frames as 10-bit samples (uint16): each value
    times 4 plus two seeded low bits, so that the 8-bit downconvert
    ((x + 2) >> 2) gives back about the same picture."""
    rng = np.random.default_rng((seed, 3))
    return [tuple((p.astype(np.uint16) << 2)
                  | rng.integers(0, 4, p.shape, dtype=np.uint16)
                  for p in planes) for planes in frames]


# ---------------------------------------------------------------------------
# a clip for logo generation (models.logo.LogoAnalyzer)
# ---------------------------------------------------------------------------

# name -> frame size, the logo's box, the scan region around it (x, y, w,
# h: a user's choice, so its width is not a multiple of anything but 2,
# which 4:2:0 needs) and the frame count. "broadcast" holds a 96x256 logo
# at the place of the recorded clips' and gives the analyzer more than
# 1000 frames to keep.
LOGO_SCAN_CLIPS = {
    "small": dict(h=96, w=128, lh=16, lw=24, lx=88, ly=16,
                  region=(80, 8, 40, 32), n=300, seed=7),
    "broadcast": dict(h=1080, w=1440, lh=96, lw=256, lx=1120, ly=40,
                      region=(1104, 24, 290, 128), n=1280, seed=8),
}
LOGO_SCAN_ON = 0.8  # share of frames with the logo on


def scan_logo_alpha(h: int, w: int) -> np.ndarray:
    """The scan clip's logo opacity: it fades to nothing well inside its
    box, so that the scan region's border stays flat (as
    tests/test_models_logo.py builds its logo)."""
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot((yy - h / 2) / (h / 2), (xx - w / 2) / (w / 2))
    return (np.clip(1.0 - 1.45 * r, 0, 1) * 0.35).astype(np.float32)


def logo_scan_clip(name: str):
    """(open_frames, num_frames, format, region (x, y, w, h), truth) of one
    size of the logo scan clip; open_frames() starts a fresh lazy pass of
    (Y, U, V) uint8 planes. Every frame is a flat background of its own
    level (luma 30-140, chroma 122-130), with mild noise (sd 0.6 in luma,
    0-2 in chroma) over the scan region, and in about LOGO_SCAN_ON of the
    frames the logo (blended toward 200) over it. truth: the logo's A, B
    and opacity over the region (A = 1, B = 0 off the logo)."""
    spec = LOGO_SCAN_CLIPS[name]
    h, w, lh, lw = spec["h"], spec["w"], spec["lh"], spec["lw"]
    rx, ry, rw, rh = spec["region"]
    oy, ox = spec["ly"] - ry, spec["lx"] - rx
    alpha = np.zeros((rh, rw), np.float32)
    alpha[oy:oy + lh, ox:ox + lw] = scan_logo_alpha(lh, lw)
    a_true, b_true = _ab(alpha, LOGO_COLORS[0])

    def open_frames():
        rng = np.random.default_rng(spec["seed"])
        for _ in range(spec["n"]):
            bg = int(rng.integers(30, 141))
            on = rng.random() < LOGO_SCAN_ON
            y = np.full((h, w), bg, np.uint8)
            win = np.full((rh, rw), float(bg))
            if on:
                win = (1 - alpha) * win + alpha * LOGO_COLORS[0]
            draws = rng.integers(0, 256, (4, rh, rw), dtype=np.uint8)
            win += (draws.sum(axis=0, dtype=np.int32) - 510) * NOISE_SCALE
            y[ry:ry + rh, rx:rx + rw] = np.clip(np.rint(win), 0, 255)
            chroma = []
            for _plane in range(2):
                base = 122 + int(rng.integers(0, 9))
                c = np.full((h // 2, w // 2), base, np.uint8)
                c[ry // 2:(ry + rh) // 2, rx // 2:(rx + rw) // 2] += \
                    rng.integers(0, 3, (rh // 2, rw // 2), dtype=np.uint8)
                chroma.append(c)
            yield y, chroma[0], chroma[1]

    truth = dict(a_y=a_true, b_y=b_true, alpha=alpha)
    return open_frames, spec["n"], video_format(h, w), spec["region"], truth
