"""Logo file format (.lgd): delogo-compatible base block + float A/B planes.

Bit-exact parity with the reference writer/reader (Amatsukaze/AMTLogo.hpp:19-282
over the delogo structures in include/logo.h): a `<logo data file ver0.1>`
header, one LOGO_HEADER + LOGO_PIXEL[h*w] block in YC48 (so the files open in
delogo-based tools), then the extended AMT header + raw float32 A/B planes
for Y/U/V which this framework actually uses. The port's copy of
amatsukaze_tpu/models/lgd.py: the same file format, bit for bit.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

LOGO_FILE_HEADER_STR = b"<logo data file ver0.1>\0\0\0\0\0"
LOGO_MAX_DP = 1000
AMT_MAGIC = 0x12345
AMT_VERSION = 1

# delogo base structures (include/logo.h)
_FILE_HEADER = struct.Struct("<28s4s")
_LOGO_HEADER = struct.Struct("<32s8h")  # name, x, y, h, w, fi, fo, st, ed
_PIXEL_DTYPE = np.dtype(
    [("dp_y", "<i2"), ("y", "<i2"), ("dp_cb", "<i2"), ("cb", "<i2"),
     ("dp_cr", "<i2"), ("cr", "<i2")]
)
# AMT extended header (AMTLogo.hpp:19-47); MSVC pads 1 byte after name[255]
_AMT_HEADER = struct.Struct("<10i255sxi60i")


@dataclass
class LogoHeader:
    w: int = 0
    h: int = 0
    log_uv_x: int = 1
    log_uv_y: int = 1
    imgw: int = 0
    imgh: int = 0
    imgx: int = 0
    imgy: int = 0
    name: str = "No Name"
    service_id: int = -1


@dataclass
class LogoData:
    """Float A/B planes; the regression model is bg = A*observed + B*maxv."""

    header: LogoHeader
    a_y: np.ndarray = None
    b_y: np.ndarray = None
    a_u: np.ndarray = None
    b_u: np.ndarray = None
    a_v: np.ndarray = None
    b_v: np.ndarray = None

    @classmethod
    def create(cls, header: LogoHeader) -> "LogoData":
        w, h = header.w, header.h
        wuv, huv = w >> header.log_uv_x, h >> header.log_uv_y
        return cls(
            header=header,
            a_y=np.ones((h, w), np.float32), b_y=np.zeros((h, w), np.float32),
            a_u=np.ones((huv, wuv), np.float32), b_u=np.zeros((huv, wuv), np.float32),
            a_v=np.ones((huv, wuv), np.float32), b_v=np.zeros((huv, wuv), np.float32),
        )


# -- YC48 conversion helpers (ref AMTLogo.hpp:49-77), vectorised ---------------

def _to_yc48_y(y):
    return (((y * 255).astype(np.int64) * 1197) >> 6) - 299


def _to_yc48_c(u):
    return (((u * 255).astype(np.int64) - 128) * 4681 + 164) >> 8


def _to_yv12_y(x):
    return (((np.int64(x) * 219 + 383) >> 12) + 16) / 255.0


def _to_yv12_c(x):
    return ((((np.int64(x) + 2048) * 7 + 66) >> 7) + 16) / 255.0


def _yc48_ab(a, b, is_chroma):
    """Map the (A, B) line through the YV12<->YC48 transforms (ref :63-77)."""
    to_yv12 = _to_yv12_c if is_chroma else _to_yv12_y
    to_yc48 = _to_yc48_c if is_chroma else _to_yc48_y
    x0 = np.float32(to_yv12(0))
    x1 = np.float32(to_yv12(2048))
    with np.errstate(divide="ignore", invalid="ignore"):
        y0 = (x0 - b) / a
        y1 = (x1 - b) / a
    y0 = to_yc48(y0).astype(np.float32)
    y1 = to_yc48(y1).astype(np.float32)
    return (y1 - y0) / 2048.0, y0


def _pack_lgp_channel(a, b, out_val, out_dp):
    """ToOutLGP one channel (ref AMTLogo.hpp:96-167), vectorised."""
    with np.errstate(divide="ignore", invalid="ignore"):
        temp_v = b / (1 - a) + 0.5
        temp_dp = (1 - a) * LOGO_MAX_DP + 0.5
    val = np.where(np.abs(temp_v) < 0x7FFF, temp_v, 0).astype(np.int16)
    dp = temp_dp.astype(np.int64).astype(np.int16)
    bad = (
        (a == 1)
        | (np.abs(temp_v) >= 0x7FFF)
        | (np.abs(temp_dp) > 0x3FFF)
        | (dp == 0)
    )
    out_val[...] = np.where(bad, 0, val)
    out_dp[...] = np.where(bad, 0, dp)


def save_lgd(path: str, logo: LogoData) -> None:
    h = logo.header
    w, hh = h.w, h.h
    wuv = w >> h.log_uv_x

    # base block pixels: upsample UV to Y resolution per pixel (ref Save :239-255)
    yy, xx = np.mgrid[0:hh, 0:w]
    uvy, uvx = yy >> h.log_uv_y, xx >> h.log_uv_x
    a_u = logo.a_u[uvy, uvx]
    b_u = logo.b_u[uvy, uvx]
    a_v = logo.a_v[uvy, uvx]
    b_v = logo.b_v[uvy, uvx]

    pix = np.zeros((hh, w), _PIXEL_DTYPE)
    ay, by = _yc48_ab(logo.a_y, logo.b_y, False)
    _pack_lgp_channel(ay, by, pix["y"], pix["dp_y"])
    au, bu = _yc48_ab(a_u, b_u, True)
    _pack_lgp_channel(au, bu, pix["cb"], pix["dp_cb"])
    av, bv = _yc48_ab(a_v, b_v, True)
    _pack_lgp_channel(av, bv, pix["cr"], pix["dp_cr"])

    with open(path, "wb") as f:
        f.write(_FILE_HEADER.pack(LOGO_FILE_HEADER_STR, (1).to_bytes(4, "big")))
        f.write(
            _LOGO_HEADER.pack(
                h.name.encode("utf-8", "replace")[:31], h.imgx, h.imgy, hh, w,
                0, 0, 0, 0,
            )
        )
        f.write(pix.tobytes())
        f.write(
            _AMT_HEADER.pack(
                AMT_MAGIC, AMT_VERSION, w, hh, h.log_uv_x, h.log_uv_y,
                h.imgw, h.imgh, h.imgx, h.imgy,
                h.name.encode("utf-8", "replace")[:254], h.service_id,
                *([0] * 60),
            )
        )
        for plane in (logo.a_y, logo.b_y, logo.a_u, logo.b_u, logo.a_v, logo.b_v):
            f.write(plane.astype("<f4").tobytes())


def load_lgd(path: str) -> LogoData:
    with open(path, "rb") as f:
        f.read(_FILE_HEADER.size)
        base = _LOGO_HEADER.unpack(f.read(_LOGO_HEADER.size))
        base_h, base_w = base[3], base[4]
        f.seek(base_w * base_h * _PIXEL_DTYPE.itemsize, 1)
        vals = _AMT_HEADER.unpack(f.read(_AMT_HEADER.size))
        (magic, version, w, hh, luvx, luvy, imgw, imgh, imgx, imgy) = vals[:10]
        if magic != AMT_MAGIC:
            raise ValueError(f"bad .lgd magic: {magic:#x}")
        name = vals[10].split(b"\0")[0].decode("utf-8", "replace")
        service_id = vals[11]
        header = LogoHeader(w, hh, luvx, luvy, imgw, imgh, imgx, imgy, name, service_id)
        wuv, huv = w >> luvx, hh >> luvy

        def plane(ph, pw):
            return np.frombuffer(f.read(ph * pw * 4), "<f4").reshape(ph, pw).copy()

        return LogoData(
            header=header,
            a_y=plane(hh, w), b_y=plane(hh, w),
            a_u=plane(huv, wuv), b_u=plane(huv, wuv),
            a_v=plane(huv, wuv), b_v=plane(huv, wuv),
        )
