"""Logo GUI support: render .lgd files and extract picker frames.

A copy of amatsukaze_tpu/models/logo_render.py (numpy and the .lgd format
only). Parity: LogoGUISupport.hpp (GUIMediaFile :17-120, GUILogoFile :122-158 +
C exports :160-275) — the GUI's logo wizard needs (a) frames from the
source file to pick the logo region on, and (b) a rendered preview of a
saved .lgd on a flat background.
"""

from __future__ import annotations

import numpy as np

from .lgd import LogoData, load_lgd, save_lgd


def compose_logo_plane(a: np.ndarray, b: np.ndarray, bg: float,
                       maxv: float = 255.0) -> np.ndarray:
    """Observed pixel values of the logo over a flat background.

    The A/B planes define erase as clean = A*observed + B*maxv, so the
    rendered (observed) logo over `bg` is (bg - B*maxv) / A."""
    a = np.where(np.abs(a) < 1e-6, 1.0, a)
    return np.clip((bg - b * maxv) / a, 0.0, maxv)


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 limited-range YUV420 -> RGB888 (ref uses sws_scale)."""
    h, w = y.shape
    u_full = np.repeat(np.repeat(u, h // u.shape[0], 0), w // u.shape[1], 1)
    v_full = np.repeat(np.repeat(v, h // v.shape[0], 0), w // v.shape[1], 1)
    yf = (y.astype(np.float64) - 16.0) * (255.0 / 219.0)
    uf = (u_full.astype(np.float64) - 128.0) * (255.0 / 224.0)
    vf = (v_full.astype(np.float64) - 128.0) * (255.0 / 224.0)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class GUILogoFile:
    """Open a .lgd, expose geometry/name, render a preview on a flat grey
    background (ref GUILogoFile :122-158)."""

    def __init__(self, path: str):
        self.path = path
        self.logo: LogoData = load_lgd(path)

    @property
    def width(self) -> int:
        return self.logo.header.w

    @property
    def height(self) -> int:
        return self.logo.header.h

    @property
    def name(self) -> str:
        return self.logo.header.name

    def set_name(self, name: str) -> None:
        self.logo.header.name = name

    def save(self, path: str | None = None) -> None:
        save_lgd(path or self.path, self.logo)

    def render(self, bg: int = 128) -> np.ndarray:
        """RGB preview of the logo composited over a flat grey frame."""
        y = compose_logo_plane(self.logo.a_y, self.logo.b_y, bg)
        u = compose_logo_plane(self.logo.a_u, self.logo.b_u, 128.0)
        v = compose_logo_plane(self.logo.a_v, self.logo.b_v, 128.0)
        return yuv_to_rgb(y, u, v)


class MediaFrameExtractor:
    """Frame picker for the logo wizard: decode the frame at a position
    ratio and hand back RGB (ref GUIMediaFile's seek + decode :17-120).

    decoder: callable(path) -> (VideoFormat, iterator of (Y, U, V), audio)
    — the generic-mode decoder signature. Without seek support the frame
    is reached by skipping, which is fine for the wizard's sparse picks."""

    def __init__(self, path: str, decoder):
        self.path = path
        self.decoder = decoder

    def get_frame(self, ratio: float, approx_total: int = 1800) -> np.ndarray:
        target = max(0, int(approx_total * min(max(ratio, 0.0), 1.0)))
        fmt, frames, _ = self.decoder(self.path)
        last = None
        for i, planes in enumerate(frames):
            last = planes
            if i >= target:
                break
        if last is None:
            raise ValueError("no frames decoded")
        return yuv_to_rgb(*[np.asarray(p) for p in last])
