"""Numpy oracle for the logo compute core (the port's copy of
amatsukaze_tpu/ops/logo_ref.py; it builds the per-pixel kernels and scales
that ops.logo ships to the card).

Direct reimplementation of the reference arithmetic, used as the
decision-parity baseline for the JAX/Pallas kernels:

- CalcCorrelation5x5 (ref LogoScan.hpp:24-41)
- LogoDataParam::CreateLogoMask / CorrelationScore / EvaluateLogo
  (ref LogoScan.hpp:112-318)
- Delogo (ref LogoScan.hpp:1248-1261)
- DeintLogo / DeintY (ref LogoScan.hpp:734-781)
- LogoColor::Add/GetAB + approxim_line (ref LogoScan.hpp:336-396)
"""

from __future__ import annotations

import numpy as np

KSIZE = 5
KLEN = KSIZE * KSIZE
CSHIFT = 3
CLEN = 256 >> CSHIFT  # 32 single-colour backgrounds
CORR_LOWER_LIMIT = 0.2


def calc_correlation_5x5(k: np.ndarray, y: np.ndarray, x: int, yy: int):
    """k: (25,) float32 kernel; y: (H, W) image. Returns (sum, avg)."""
    win = y[yy - 2 : yy + 3, x - 2 : x + 3].astype(np.float32)
    avg = np.float32(win.sum(dtype=np.float32) / 25)
    s = np.float32((k.reshape(5, 5) * (win - avg)).sum(dtype=np.float32))
    return s, avg


def deint_y(src: np.ndarray) -> np.ndarray:
    """(a + 2b + c + 2) / 4 vertical merge, edge rows copied (ref :763-781)."""
    src = src.astype(np.int64)
    h, w = src.shape
    dst = np.empty((h, w), np.float32)
    dst[0] = src[0]
    dst[h - 1] = src[h - 1]
    if h > 2:
        dst[1 : h - 1] = (src[0 : h - 2] + 2 * src[1 : h - 1] + src[2:h] + 2) / 4.0
    return dst


def deint_logo(a: np.ndarray) -> np.ndarray:
    """(a + 2b + c) / 4 vertical merge for logo A/B planes (ref :734-761)."""
    h, w = a.shape
    dst = a.copy().astype(np.float32)
    if h > 2:
        dst[1 : h - 1] = (a[0 : h - 2] + 2 * a[1 : h - 1] + a[2:h]) / 4.0
    return dst


def delogo(src: np.ndarray, a: np.ndarray, b: np.ndarray, maxv: float, fade: float,
           dtype=np.uint8) -> np.ndarray:
    """dst = clamp(fade*(a*src+b*maxv) + (1-fade)*src + 0.5) (ref :1248-1261)."""
    srcf = src.astype(np.float32)
    bg = a * srcf + b * np.float32(maxv)
    tmp = np.float32(fade) * bg + np.float32(1 - fade) * srcf
    return np.clip(tmp + 0.5, 0.0, maxv).astype(dtype)


def add_logo(y: np.ndarray, a: np.ndarray, b: np.ndarray, maxv: float) -> np.ndarray:
    """Paint the logo onto a background: Y = (Y - b*maxv) / a where a>0
    (ref AddLogo :306-318)."""
    out = y.astype(np.float32).copy()
    sel = a > 0
    out[sel] = (out[sel] - b[sel] * maxv) / a[sel]
    return out


class LogoEvalRef:
    """CreateLogoMask + EvaluateLogo oracle (ref LogoScan.hpp:112-318)."""

    def __init__(self, a_y: np.ndarray, b_y: np.ndarray, maskratio: float = 0.1):
        self.a_y = a_y.astype(np.float32)
        self.b_y = b_y.astype(np.float32)
        self.h, self.w = a_y.shape
        self._create_mask(maskratio)

    def _make_kernel(self, img, x, y):
        win = img[y - 2 : y + 3, x - 2 : x + 3].astype(np.float32).reshape(-1)
        return win - np.float32(win.sum(dtype=np.float32) / KLEN)

    def _create_mask(self, maskratio: float) -> None:
        from numpy.lib.stride_tricks import sliding_window_view

        h, w = self.h, self.w
        ysize = h * w
        # each single-colour background with the logo on it
        slices = np.empty((CLEN, h, w), np.float32)
        for c in range(CLEN):
            slices[c] = add_logo(
                np.full((h, w), float(c << CSHIFT), np.float32),
                self.a_y, self.b_y, 255.0,
            )

        # per-pixel 5x5 variance on the middle background (vectorised; each
        # 25-element reduction matches the loop version bit-for-bit)
        mid = slices[CLEN >> 1]
        win = sliding_window_view(mid, (5, 5)).reshape(h - 4, w - 4, KLEN)
        avg = win.sum(axis=-1, dtype=np.float32) / np.float32(KLEN)
        kz = win - avg[..., None]
        variance = np.zeros((h, w), np.float32)
        variance[2 : h - 2, 2 : w - 2] = (kz * kz).sum(axis=-1, dtype=np.float32)
        variance = variance.reshape(-1)

        # top maskratio pixels by variance (std::sort on (variance, index)
        # pairs descending: ties broken by larger index first)
        order = np.lexsort((-np.arange(ysize), -variance))
        self.maskpixels = min(ysize, int(ysize * maskratio))
        self.mask = np.zeros(ysize, np.uint8)
        self.mask[order[: self.maskpixels]] = 1

        # per-masked-pixel kernels (from the colour-0 slice) + scales
        mask2d = self.mask.reshape(h, w)[2 : h - 2, 2 : w - 2].astype(bool)
        win0 = sliding_window_view(slices[0], (5, 5)).reshape(h - 4, w - 4, KLEN)
        avg0 = win0.sum(axis=-1, dtype=np.float32) / np.float32(KLEN)
        kernels_all = win0 - avg0[..., None]
        self.kernels = np.ascontiguousarray(kernels_all[mask2d])

        # correlations vs every background: [mp, CLEN]
        winc = sliding_window_view(slices, (5, 5), axis=(1, 2)).reshape(
            CLEN, h - 4, w - 4, KLEN
        )
        avgc = winc.sum(axis=-1, dtype=np.float32) / np.float32(25)
        wmask = winc[:, mask2d]  # [CLEN, mp_interior, KLEN]
        amask = avgc[:, mask2d]  # [CLEN, mp_interior]
        # note: a degenerate (flat) logo can put masked pixels on the border
        # only -> zero interior pixels; arrays are sized by the interior count
        # (the reference's count variable), while maskpixels keeps the nominal
        # target used for the avgCorr normalisation (ref :201)
        mp_interior = int(mask2d.sum())
        corr = np.einsum(
            "mk,cmk->mc", self.kernels, wmask - amask[..., None],
            dtype=np.float32, optimize=True,
        ) if mp_interior else np.zeros((0, CLEN), np.float32)
        self.scales = np.zeros((mp_interior, CLEN, 2), np.float32)
        self.scales[:, :, 0] = np.abs(corr)
        # sequential float32 accumulation in the C++ (pixel, background) order
        avg_corr = np.float32(0)
        for v in self.scales[:, :, 0].ravel():
            avg_corr += v
        avg_corr /= np.float32(self.maskpixels * CLEN)
        limit = avg_corr * CORR_LOWER_LIMIT
        corr = self.scales[:, :, 0].copy()
        with np.errstate(divide="ignore"):
            self.scales[:, :, 0] = np.where(corr > 0, 1.0 / corr, 0.0)
        self.scales[:, :, 1] = np.minimum(1.0, corr / limit)

        # black background (colour 16) baseline
        self.black_score = self.correlation_score(slices[16 >> CSHIFT], 255.0)

    def correlation_score(self, work: np.ndarray, maxv: float) -> float:
        h, w = self.h, self.w
        count = 0
        result = np.float32(0)
        for y in range(2, h - 2):
            for x in range(2, w - 2):
                if self.mask[x + y * w]:
                    k = self.kernels[count]
                    s, avg = calc_correlation_5x5(k, work, x, y)
                    bucket = max(0, min(255, int(avg))) >> CSHIFT
                    scale, scale2 = self.scales[count, bucket]
                    normalized = max(-1.0, min(1.0, float(s * scale)))
                    result += np.float32(normalized * scale2)
                    count += 1
        return float(result)

    def evaluate(self, src: np.ndarray, maxv: float, fade: float) -> float:
        srcf = src.astype(np.float32)
        bg = self.a_y * srcf + self.b_y * np.float32(maxv)
        work = np.float32(fade) * bg + np.float32(1 - fade) * srcf
        return self.correlation_score(work, maxv) / self.black_score


def approxim_line(n, sum_x, sum_y, sum_x2, sum_xy):
    temp = n * sum_x2 - sum_x * sum_x
    a = (n * sum_xy - sum_x * sum_y) / temp if temp != 0 else np.nan
    b = (sum_x2 * sum_y - sum_x * sum_xy) / temp if temp != 0 else np.nan
    return a, b


def logo_get_ab(sum_f, sum_b, sum_f2, sum_b2, sum_fb, n):
    """Per-pixel regression both ways, averaged (ref GetAB :380-395).
    Returns (A, B, valid)."""
    a1, b1 = approxim_line(n, sum_f, sum_b, sum_f2, sum_fb)
    a2, b2 = approxim_line(n, sum_b, sum_f, sum_b2, sum_fb)
    a = (a1 + (1 / a2)) / 2 if a2 != 0 else np.nan
    b = (b1 + (-b2 / a2)) / 2 if a2 != 0 else np.nan
    valid = not (np.isnan(a) or np.isnan(b) or np.isinf(a) or np.isinf(b) or a == 0)
    return np.float32(a), np.float32(b), valid


def med_average(values) -> int:
    """Average of the middle half after sorting (ref med_average :408-422)."""
    s = sorted(values)
    n = len(s)
    sel = s[n // 4 : n - n // 4]
    nn = len(sel)
    t = float(sum(sel))
    return int((t + nn // 2) / nn)
