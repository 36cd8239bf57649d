"""Amatsukaze's Delogo arithmetic (LogoScan.hpp:1248-1261), in NumPy and
plain PyTorch, for the reference of any configuration that erases a logo:
every source frame, on Y, U and V, dst = floor(fade (A src + B 255) +
(1 - fade) src + 0.5) clamped to [0, 255], with the fade 1 on frames that
carry the logo and 0 elsewhere, box-averaged over +-4 frames (CalcFade2)."""

from __future__ import annotations

import numpy as np
import torch

FADE_WINDOW = 4


def fade_curve(truth: dict) -> np.ndarray:
    """Per source frame erase fade of the painted logo."""
    on = np.zeros(truth["frames"])
    for s in truth["scenes"]:
        if s["logo"]:
            on[s["first"]:s["end"]] = 1.0
    k = np.ones(2 * FADE_WINDOW + 1) / (2 * FADE_WINDOW + 1)
    fade = np.convolve(np.pad(on, FADE_WINDOW, mode="edge"), k, mode="valid")
    return np.clip(fade.astype(np.float32), 0.0, 1.0)


def logo_planes(lgd_planes, geometry: dict) -> list:
    """Full-frame (A, B) float32 planes per colour (identity off the
    logo) from the painted logo's window planes."""
    lx, ly, lw, lh = geometry["logo_box"]
    h, w = geometry["height"], geometry["width"]
    out = []
    for p, s in enumerate((1, 2, 2)):
        a = np.ones((h // s, w // s), np.float32)
        b = np.zeros((h // s, w // s), np.float32)
        a[ly // s:ly // s + lh // s, lx // s:lx // s + lw // s] = \
            lgd_planes[2 * p]
        b[ly // s:ly // s + lh // s, lx // s:lx // s + lw // s] = \
            lgd_planes[2 * p + 1]
        out.append((a, b))
    return out


def erase(planes, ab: list, fade: float, dtype=torch.float32,
          device="cpu") -> tuple:
    """Delogo one frame's (Y, U, V) uint8 planes at `fade`."""
    out = []
    for x, (a, b) in zip(planes, ab):
        src = torch.from_numpy(np.asarray(x)).to(device, dtype)
        at = torch.from_numpy(a).to(device, dtype)
        bt = torch.from_numpy(b).to(device, dtype)
        f = torch.tensor(fade, dtype=dtype, device=device)
        bg = at * src + bt * torch.tensor(255.0, dtype=dtype, device=device)
        tmp = f * bg + (torch.tensor(1.0, dtype=dtype, device=device)
                        - f) * src
        out.append(torch.floor(tmp + 0.5).clamp(0.0, 255.0)
                   .to(torch.uint8).cpu().numpy())
    return tuple(out)
