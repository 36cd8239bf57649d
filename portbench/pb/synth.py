"""The recording writer: a frozen copy of the port's synthetic broadcast
generators (utils/synth_clip.py's broadcast layout and utils/synth_ts.py's
MPEG-2 intra + ADTS AAC-LC transport stream), kept here so that the
traffic does not change when the program does.

A recording is a list of scenes. Each scene is 3:2 telecined film or
interlaced video panning through a seeded texture, with or without the
logo painted on, and with a pool of {-1, 0, 1} noise whose window moves
each frame. Every frame can be made on its own (`Recording.frame(k)`), so
that the reference can rebuild any frame without holding the recording.

The MPEG-2 pictures are intra only, one slice per macroblock row at a
seeded quantiser scale; `reconstruct(frame, row_qs)` gives what a correct
decoder must return for them (the inverse DCT of the decoder, two integer
stages evaluated as exact float64 products).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from . import synth_tables as T

VIDEO_PID = 0x0111
AUDIO_PID = 0x0112
PMT_PID = 0x01F0
SERVICE_ID = 0x5C38
TSID = 0x7FE0
FIRST_PTS = 90_000
FRAME_TICKS = 3003  # 90 kHz ticks of one 30000/1001 frame
AUDIO_RATE = 48000
AUDIO_FRAME = 1024  # samples per AAC frame
GOP = 15  # frames per sequence header (and PAT/PMT)
QS_CHOICES = np.array([8, 10, 12])  # fine enough that KFM sees the 3:2 cadence
LOGO_COLORS = (200.0, 90.0, 170.0)  # Y, U, V of the painted logo
NOISE_SLACK = 64


# ---------------------------------------------------------------------------
# bits, CRC, timestamps
# ---------------------------------------------------------------------------

class BitWriter:
    """MSB-first bit writer."""

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nacc = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nacc += nbits
        while self._nacc >= 8:
            self._nacc -= 8
            self._buf.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def byte_align(self) -> None:
        if self._nacc:
            self.write(0, 8 - self._nacc)

    def getvalue(self) -> bytes:
        if self._nacc:
            raise ValueError("unaligned writer")
        return bytes(self._buf)


def _crc_table() -> list:
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if (c & 0x80000000) else (c << 1)
            c &= 0xFFFFFFFF
        table.append(c)
    return table


_CRC = _crc_table()


def crc32_mpeg2(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC[((crc >> 24) ^ b) & 0xFF]
    return crc


def write_timestamp(ts: int, prefix: int) -> bytes:
    raw = ((prefix << 36) | (((ts >> 30) & 0x7) << 33) | (1 << 32)
           | (((ts >> 15) & 0x7FFF) << 17) | (1 << 16)
           | ((ts & 0x7FFF) << 1) | 1)
    return raw.to_bytes(5, "big")


# ---------------------------------------------------------------------------
# MPEG-2 intra pictures
# ---------------------------------------------------------------------------

def _code(bits: str) -> tuple[int, int]:
    return int(bits, 2), len(bits)


def _dc_table(entries) -> np.ndarray:
    out = np.zeros((12, 2), np.int64)
    for bits, size in entries:
        out[size] = _code(bits)
    return out


_DC_LUMA = _dc_table(T.DC_LUMA)
_DC_CHROMA = _dc_table(T.DC_CHROMA)
_AC_CODE = np.zeros((64, 41), np.int64)
_AC_LEN = np.zeros((64, 41), np.int64)
for _bits, _run, _level in T.AC_CODES:
    _AC_CODE[_run, _level], _AC_LEN[_run, _level] = _code(_bits)
_EOB = _code(T.EOB_CODE)
_MB_INTRA = _code(T.MB_INTRA_CODE)
_ADDR_1 = _code(T.ADDR_INC_1_CODE)
_ZIGZAG = np.asarray(T.ZIGZAG_SCAN, np.int64)
_W_INTRA = np.asarray(T.DEFAULT_INTRA_MATRIX, np.int64)


def _dct_basis() -> np.ndarray:
    b = np.empty((8, 8))
    for u in range(8):
        cu = (1.0 / math.sqrt(2.0)) if u == 0 else 1.0
        for m in range(8):
            b[u, m] = (cu / 2.0) * math.cos((2 * m + 1) * u * math.pi / 16.0)
    return b


_B = _dct_basis()
_A = np.asarray(T.IDCT_A, np.float64)
_FDCT = np.kron(_B, _B).T[:, _ZIGZAG]
_IDCT_1 = np.kron(np.eye(8), _A)[_ZIGZAG]
_IDCT_2 = np.kron(_A, np.eye(8))
_W_ZIGZAG = _W_INTRA[_ZIGZAG].astype(np.float64)


def _product(x: np.ndarray, m: np.ndarray) -> np.ndarray:
    """x @ m for [N, 64] float64 rows, as a stack of [16, 64] products
    (small enough that BLAS keeps each on the calling thread)."""
    n = len(x)
    pad = -n % 16
    if pad:
        x = np.concatenate([x, np.zeros((pad, 64))])
    return (x.reshape(-1, 16, 64) @ m).reshape(-1, 64)[:n]


def idct_blocks(coeffs: np.ndarray) -> np.ndarray:
    """The decoder's integer inverse DCT, T = (F A + 2^10) >> 11 and
    X = (A^T T + 2^16) >> 17, as exact float64 products."""
    t = _product(coeffs.astype(np.float64), _IDCT_1)
    t = np.floor((t + 1024.0) / 2048.0)
    x = _product(t, _IDCT_2)
    return np.floor((x + 65536.0) / 131072.0).astype(np.int64)


def _blocks(y, u, v) -> np.ndarray:
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    luma = (y.reshape(mbh, 2, 8, mbw, 2, 8).transpose(0, 3, 1, 4, 2, 5)
            .reshape(mbh, mbw, 4, 8, 8))
    cb = u.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)[:, :, None]
    cr = v.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)[:, :, None]
    return np.concatenate([luma, cb, cr], axis=2)


def _planes(blocks: np.ndarray) -> tuple:
    mbh, mbw = blocks.shape[:2]
    y = (blocks[:, :, :4].reshape(mbh, mbw, 2, 2, 8, 8)
         .transpose(0, 2, 4, 1, 3, 5).reshape(mbh * 16, mbw * 16))
    u = blocks[:, :, 4].transpose(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
    v = blocks[:, :, 5].transpose(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
    return y, u, v


def _pack(codes: np.ndarray, lens: np.ndarray) -> bytes:
    keep = lens > 0
    codes, lens = codes[keep].astype(np.uint64), lens[keep]
    starts = np.cumsum(lens) - lens
    tok = np.repeat(np.arange(len(lens)), lens)
    shift = (lens[tok] - 1 - (np.arange(int(lens.sum())) - starts[tok]))
    bits = (codes[tok] >> shift.astype(np.uint64)) & np.uint64(1)
    return np.packbits(bits.astype(np.uint8)).tobytes()


def sequence_header(width: int, height: int) -> bytes:
    """16:9, 30000/1001, 4:2:0, interlaced, MP@HL, default matrices."""
    w = BitWriter()
    w.write(0x000001B3, 32)
    w.write(width & 0xFFF, 12)
    w.write(height & 0xFFF, 12)
    w.write(3, 4)
    w.write(4, 4)
    w.write(50000, 18)
    w.write(1, 1)
    w.write(112, 10)
    w.write(0, 3)
    w.byte_align()
    w.write(0x000001B5, 32)
    w.write(1, 4)
    w.write(0x48, 8)
    w.write(0, 1)
    w.write(1, 2)
    w.write((width >> 12) & 3, 2)
    w.write((height >> 12) & 3, 2)
    w.write(0, 12)
    w.write(1, 1)
    w.write(0, 8)
    w.write(0, 1)
    w.write(0, 7)
    w.byte_align()
    return w.getvalue()


def picture_header(temporal_reference: int) -> bytes:
    """I frame picture, top field first, frame DCT, linear quantiser."""
    w = BitWriter()
    w.write(0x00000100, 32)
    w.write(temporal_reference & 0x3FF, 10)
    w.write(1, 3)
    w.write(0xFFFF, 16)
    w.write(0, 1)
    w.byte_align()
    w.write(0x000001B5, 32)
    w.write(8, 4)
    w.write(0xFFFF, 16)
    w.write(0, 2)
    w.write(3, 2)
    w.write(1, 1)
    w.write(1, 1)
    w.write(0, 5)
    w.write(1, 1)
    w.write(0, 1)
    w.write(0, 1)
    w.byte_align()
    return w.getvalue()


def _coefficients(planes, row_qs: np.ndarray):
    """(quantised levels [N, 64], dequantised coefficients [N, 64], DC
    levels [N], mb_h, mb_w) of one frame's blocks in coding order."""
    y, u, v = (np.asarray(p) for p in planes)
    h, w = y.shape
    mbh, mbw = (h + 15) // 16, (w + 15) // 16
    pad = [np.pad(p, ((0, r - p.shape[0]), (0, c - p.shape[1])), mode="edge")
           for p, r, c in ((y, mbh * 16, mbw * 16), (u, mbh * 8, mbw * 8),
                           (v, mbh * 8, mbw * 8))]
    qs = np.asarray(row_qs, np.int64)
    if qs.shape != (mbh,) or np.any(qs % 2) or np.any(qs < 2):
        raise ValueError(f"row quantiser scales {qs}")
    x = _blocks(*pad).reshape(-1, 64).astype(np.float64)
    lv = _product(x, _FDCT)
    dc = np.clip(np.rint(lv[:, 0] / 8.0), 0, 255)
    bq = np.repeat(qs, mbw * 6).astype(np.float64)[:, None]
    lv *= 16.0 / (_W_ZIGZAG * bq)
    np.rint(lv, out=lv)
    np.clip(lv, -2047, 2047, out=lv)
    lv[:, 0] = 0
    coef = lv * (_W_ZIGZAG * bq / 16.0)
    np.trunc(coef, out=coef)
    coef[:, 0] = dc * 8
    np.clip(coef, -2048, 2047, out=coef)
    even = np.fmod(coef.sum(axis=1), 2) == 0
    last = coef[even, 63]
    coef[even, 63] = np.where(np.fmod(last, 2) == 0, last + 1, last - 1)
    return lv, coef, dc.astype(np.int64), mbh, mbw


def reconstruct(planes, row_qs: np.ndarray) -> tuple:
    """What a correct MPEG-2 decoder returns for the intra picture that
    encode_intra_picture writes from these planes and scales."""
    h, w = np.asarray(planes[0]).shape
    _, coef, _, mbh, mbw = _coefficients(planes, row_qs)
    rec = np.clip(idct_blocks(coef), 0, 255).astype(np.uint8)
    ry, ru, rv = _planes(rec.reshape(mbh, mbw, 6, 8, 8))
    return ry[:h, :w], ru[:h // 2, :w // 2], rv[:h // 2, :w // 2]


def encode_intra_picture(planes, row_qs: np.ndarray,
                         temporal_reference: int = 0,
                         with_sequence: bool = True) -> bytes:
    """One frame as an MPEG-2 I frame picture, one slice per macroblock
    row at quantiser scale row_qs[row]."""
    h, w = np.asarray(planes[0]).shape
    lv, _, dc, mbh, mbw = _coefficients(planes, row_qs)
    qs = np.asarray(row_qs, np.int64)
    nb = mbh * mbw * 6
    row = np.repeat(np.arange(mbh), mbw * 6)
    col = np.tile(np.repeat(np.arange(mbw), 6), mbh)
    blk = np.tile(np.arange(6), mbh * mbw)
    dcs = dc.reshape(mbh, mbw, 6)
    diff = np.empty_like(dcs)
    luma = dcs[:, :, :4].reshape(mbh, -1)
    diff[:, :, :4] = np.diff(luma, axis=1, prepend=128).reshape(mbh, mbw, 4)
    for c in (4, 5):
        diff[:, :, c] = np.diff(dcs[:, :, c], axis=1, prepend=128)
    diff = diff.reshape(-1)
    size = np.frexp(np.abs(diff).astype(np.float64))[1].astype(np.int64)
    dc_tab = np.where((blk < 4)[:, None], _DC_LUMA[size], _DC_CHROMA[size])
    dc_bits = np.where(diff > 0, diff, diff + (1 << size) - 1)
    ac = lv[:, 1:]
    ab, ak = np.nonzero(ac)
    level = ac[ab, ak].astype(np.int64)
    pos = ak + 1
    n_ac = np.bincount(ab, minlength=nb)
    first_nz = np.cumsum(n_ac) - n_ac
    rank = np.arange(len(ab)) - first_nz[ab]
    prev = np.where(rank == 0, 0, np.roll(pos, 1))
    run = pos - prev - 1
    mag = np.abs(level)
    tl = np.where(mag <= 40, _AC_LEN[run, np.minimum(mag, 40)], 0)
    esc = tl == 0
    ac_code = np.where(esc, (1 << 18) | (run << 12) | (level & 0xFFF),
                       (_AC_CODE[run, np.minimum(mag, 40)] << 1)
                       | (level < 0))
    ac_len = np.where(esc, 24, tl + 1)
    count = 6 + n_ac
    start = np.cumsum(count) - count
    codes = np.zeros(int(count.sum()), np.int64)
    lens = np.zeros_like(codes)
    head = (col == 0) & (blk == 0)
    codes[start] = np.where(head, 0x100 + row + 1, 0)
    lens[start] = np.where(head, 32, 0)
    mb_hdr = (_ADDR_1[0] << _MB_INTRA[1]) | _MB_INTRA[0]
    mb_len = _ADDR_1[1] + _MB_INTRA[1]
    codes[start + 1] = np.where(
        head, ((qs[row] // 2) << (1 + mb_len)) | mb_hdr,
        np.where(blk == 0, mb_hdr, 0))
    lens[start + 1] = np.where(head, 6 + mb_len,
                               np.where(blk == 0, mb_len, 0))
    codes[start + 2], lens[start + 2] = dc_tab[:, 0], dc_tab[:, 1]
    codes[start + 3], lens[start + 3] = dc_bits, size
    at = start[ab] + 4 + rank
    codes[at], lens[at] = ac_code, ac_len
    codes[start + 4 + n_ac], lens[start + 4 + n_ac] = _EOB
    tok_row = np.repeat(row, count)
    row_bits = np.bincount(tok_row, weights=lens, minlength=mbh)
    end = (col == mbw - 1) & (blk == 5)
    lens[start[end] + 5 + n_ac[end]] = (-row_bits.astype(np.int64)) % 8
    hdr = (sequence_header(w, h) if with_sequence else b"") + \
        picture_header(temporal_reference)
    return hdr + _pack(codes, lens)


# ---------------------------------------------------------------------------
# ADTS AAC-LC stereo
# ---------------------------------------------------------------------------

_HCB11 = {vals: (n, code) for n, code, vals in T.AAC_HCB_11}
LOUD_BANDS = 30
LOUD_LEVEL = 6
LOUD_GAIN = 160


def _adts(payload: bytes) -> bytes:
    h = BitWriter()
    for value, bits in ((0xFFF, 12), (1, 1), (0, 2), (1, 1), (1, 2), (3, 4),
                        (0, 1), (2, 3), (0, 4), (7 + len(payload), 13),
                        (0x7FF, 11), (0, 2)):
        h.write(value, bits)
    return h.getvalue() + payload


def aac_frame(rng: np.random.Generator | None) -> bytes:
    """One ADTS frame, a CPE with a common long window: silent with rng
    None, else seeded noise in the lowest LOUD_BANDS bands."""
    w = BitWriter()
    w.write(1, 3)
    w.write(0, 4)
    w.write(1, 1)
    n_sfb = 0 if rng is None else LOUD_BANDS
    w.write(0, 1)
    w.write(0, 2)
    w.write(0, 1)
    w.write(n_sfb, 6)
    w.write(0, 1)
    w.write(0, 2)
    for _ in range(2):
        w.write(LOUD_GAIN, 8)
        if n_sfb:
            w.write(11, 4)
            rem = n_sfb
            while rem >= 31:
                w.write(31, 5)
                rem -= 31
            w.write(rem, 5)
            for _ in range(n_sfb):
                w.write(T.AAC_SF_ZERO[1], T.AAC_SF_ZERO[0])
        w.write(0, 3)
        if n_sfb:
            vals = rng.integers(-LOUD_LEVEL, LOUD_LEVEL + 1,
                                T.AAC_SWB_LONG_48K[n_sfb]).tolist()
            for a, b in zip(vals[::2], vals[1::2]):
                n, code = _HCB11[(abs(a), abs(b))]
                w.write(code, n)
                for s in (a, b):
                    if s:
                        w.write(1 if s < 0 else 0, 1)
    w.write(7, 3)
    w.byte_align()
    return _adts(w.getvalue())


# ---------------------------------------------------------------------------
# PSI, PES and TS packets
# ---------------------------------------------------------------------------

def _section(table_id: int, id_ext: int, payload: bytes) -> bytes:
    body = id_ext.to_bytes(2, "big") + bytes([0xC1, 0, 0]) + payload
    n = len(body) + 4
    sec = bytes([table_id, 0xB0 | (n >> 8), n & 0xFF]) + body
    return sec + crc32_mpeg2(sec).to_bytes(4, "big")


def _pat() -> bytes:
    return _section(0x00, TSID, SERVICE_ID.to_bytes(2, "big")
                    + (0xE000 | PMT_PID).to_bytes(2, "big"))


def _pmt() -> bytes:
    payload = (0xE000 | VIDEO_PID).to_bytes(2, "big") + b"\xF0\x00"
    for stype, pid in ((0x02, VIDEO_PID), (0x0F, AUDIO_PID)):
        payload += bytes([stype]) + (0xE000 | pid).to_bytes(2, "big") \
            + b"\xF0\x00"
    return _section(0x02, SERVICE_ID, payload)


def _pes(stream_id: int, payload: bytes, pts: int, dts: int | None,
         bounded: bool) -> bytes:
    if dts is None:
        hdr = bytes([0x80, 0x80, 5]) + write_timestamp(pts, 0x2)
    else:
        hdr = bytes([0x80, 0xC0, 10]) + write_timestamp(pts, 0x3) \
            + write_timestamp(dts, 0x1)
    body = hdr + payload
    n = len(body) if bounded else 0
    return b"\x00\x00\x01" + bytes([stream_id]) + n.to_bytes(2, "big") + body


def _pcr_field(pcr: int) -> bytes:
    base, ext = divmod(pcr, 300)
    base &= (1 << 33) - 1
    return ((base << 15) | (0x3F << 9) | ext).to_bytes(6, "big")


class _Packetizer:
    def __init__(self, out):
        self.cc: dict[int, int] = {}
        self.out = out

    def _packet(self, pid: int, chunk: bytes, pusi: bool,
                pcr: int | None = None) -> None:
        cc = self.cc.get(pid, 0)
        self.cc[pid] = (cc + 1) & 0xF
        hdr = bytes([0x47, (0x40 if pusi else 0) | (pid >> 8), pid & 0xFF])
        if pcr is None and len(chunk) == 184:
            self.out.write(hdr + bytes([0x10 | cc]) + chunk)
            return
        af = bytes([0x10]) + _pcr_field(pcr) if pcr is not None else b""
        if pcr is None and len(chunk) == 183:
            af_field = b"\x00"
        else:
            af = af or b"\x00"
            af += b"\xFF" * (183 - len(chunk) - len(af))
            af_field = bytes([len(af)]) + af
        self.out.write(hdr + bytes([0x30 | cc]) + af_field + chunk)

    def section(self, pid: int, sec: bytes) -> None:
        data = b"\x00" + sec
        for i in range(0, len(data), 184):
            chunk = data[i:i + 184]
            self._packet(pid, chunk + b"\xFF" * (184 - len(chunk)), i == 0)

    def pes(self, pid: int, pes: bytes, pcr: int | None = None) -> None:
        first = 176 if pcr is not None else 184
        self._packet(pid, pes[:first], True, pcr)
        for i in range(first, len(pes), 184):
            self._packet(pid, pes[i:i + 184], False)

    def pcr_only(self, pid: int, pcr: int) -> None:
        cc = self.cc.get(pid, 0)
        af = bytes([0x10]) + _pcr_field(pcr)
        af += b"\xFF" * (183 - len(af))
        self.out.write(bytes([0x47, pid >> 8, pid & 0xFF, 0x20 | cc, 183])
                       + af)


# ---------------------------------------------------------------------------
# the recording's pictures
# ---------------------------------------------------------------------------

def logo_alpha(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot((yy - h / 2) / (h / 2), (xx - w / 2) / (w / 2))
    return (np.clip(1.2 - r, 0, 1) * 0.35).astype(np.float32)


def _texture(h: int, w: int, base, amp, period, row_period) -> np.ndarray:
    yy = np.arange(h, dtype=np.float64)[:, None]
    xx = np.arange(w, dtype=np.float64)[None, :]
    t = (base + amp * np.sin(xx / period) * np.cos(yy / row_period)
         + 0.25 * amp * np.sin((xx * 0.37 + yy * 0.61) / period))
    return np.rint(t).astype(np.int16)


@dataclass
class Scene:
    """Frames [first, end) of one shot: 3:2 telecined film or interlaced
    video, with or without the logo, and (base, amplitude, period, row
    period) of its Y, U and V textures."""
    first: int
    end: int
    film: bool
    logo: bool
    look: list

    def fields(self) -> list:
        """(top, bottom) pan offsets in pixels per coded frame: film moves
        two pixels a film frame, video one pixel a field."""
        n = self.end - self.first
        if not self.film:
            return [(2 * k, 2 * k + 1) for k in range(n)]
        out, f = [], 0
        while len(out) < n:
            a, b, c, d = (2 * (f + i) for i in range(4))
            out += [(a, a), (a, b), (b, c), (c, c), (d, d)]
            f += 4
        return out[:n]


@dataclass
class Recording:
    """A recording's geometry, scenes and seeded draws; frame(k) makes
    frame k alone, reconstruct(k) what the decoder returns for it."""
    h: int
    w: int
    logo_box: tuple  # (x, y, w, h) of the painted logo
    scenes: list
    seed: int
    row_qs: np.ndarray = field(init=False)
    offsets: np.ndarray = field(init=False)

    def __post_init__(self):
        n = self.scenes[-1].end
        rng = np.random.default_rng((self.seed, 10))
        self._pools = [rng.integers(-1, 2, (self.h // s + NOISE_SLACK,
                                            self.w // s + NOISE_SLACK),
                                    dtype=np.int16) for s in (1, 2, 2)]
        self.offsets = rng.integers(0, NOISE_SLACK, (n, 3, 2))
        self.row_qs = np.random.default_rng((self.seed, 11)).choice(
            QS_CHOICES, (n, (self.h + 15) // 16))
        lx, ly, lw, lh = self.logo_box
        self._alphas = [logo_alpha(lh // s, lw // s).astype(np.float64)
                        for s in (1, 2, 2)]
        self._textures = {}
        self._lock = threading.Lock()

    @property
    def num_frames(self) -> int:
        return self.scenes[-1].end

    def scene_of(self, k: int) -> tuple:
        for i, sc in enumerate(self.scenes):
            if sc.first <= k < sc.end:
                return i, sc
        raise IndexError(k)

    def _scene_textures(self, i: int, sc: Scene) -> list:
        with self._lock:  # frame() runs on the writer's threads
            if i not in self._textures:
                reach = sc.fields()[-1][1] + 1
                self._textures[i] = [
                    _texture(self.h // s, self.w // s + reach // s + 1, *p)
                    for s, p in zip((1, 2, 2), sc.look)]
            return self._textures[i]

    def field_times(self, k: int) -> tuple:
        """(scene index, top pan, bottom pan) of frame k: two frames show
        the same picture in a field where these agree."""
        i, sc = self.scene_of(k)
        top, bottom = sc.fields()[k - sc.first]
        return i, top, bottom

    def frame(self, k: int) -> tuple:
        """(Y, U, V) uint8 planes of source frame k."""
        i, sc = self.scene_of(k)
        top, bottom = sc.fields()[k - sc.first]
        lx, ly, _, _ = self.logo_box
        planes = []
        for p, (sub, tex) in enumerate(zip((1, 2, 2),
                                           self._scene_textures(i, sc))):
            gw = self.w // sub
            f = tex[:, top // sub:top // sub + gw].copy()
            if bottom != top:
                f[1::2] = tex[1::2, bottom // sub:bottom // sub + gw]
            if sc.logo:
                y0, x0 = ly // sub, lx // sub
                al = self._alphas[p]
                win = f[y0:y0 + al.shape[0], x0:x0 + al.shape[1]]
                win[:] = np.rint(win * (1.0 - al) + al * LOGO_COLORS[p])
            dy, dx = self.offsets[k, p]
            f += self._pools[p][dy:dy + f.shape[0], dx:dx + f.shape[1]]
            planes.append(np.clip(f, 0, 255).astype(np.uint8))
        return tuple(planes)

    def reconstruct(self, k: int) -> tuple:
        return reconstruct(self.frame(k), self.row_qs[k])


def make_logos(h, w, logo_box) -> list:
    """(A, B) planes per colour of the painted logo and of a decoy that
    never matches: [(a_y, b_y, a_u, b_u, a_v, b_v), ...]. A logo pixel
    painted as p = (1 - alpha) x + alpha c is erased as A p + B 255."""
    lx, ly, lw, lh = logo_box

    def ab(alpha, color):
        return ((1.0 / (1.0 - alpha)).astype(np.float32),
                (-alpha * color / (1.0 - alpha) / 255.0).astype(np.float32))

    logo = []
    for p, s in enumerate((1, 2, 2)):
        logo += ab(logo_alpha(lh // s, lw // s), LOGO_COLORS[p])
    stripes = np.zeros((lh, lw), np.float32)
    stripes[4:-4, 4:-4] = 0.3 * ((np.arange(lw - 8) // 6) % 2)
    ones = np.ones((lh // 2, lw // 2), np.float32)
    zeros = np.zeros((lh // 2, lw // 2), np.float32)
    decoy = list(ab(stripes, 60.0)) + [ones, zeros, ones, zeros]
    return [logo, decoy]


def write_ts(path: str, rec: Recording, silent_audio, seed: int) -> dict:
    """Write the recording as a single-program TS (intra MPEG-2 video, ADTS
    AAC-LC stereo 48 kHz), with the audio silent where silent_audio(t0,
    t1) (seconds) is true. Pictures are coded on one thread per core, at
    most 8. Returns the size in bytes and the seconds it took."""
    t0 = time.perf_counter()
    n = rec.num_frames
    workers = min(8, os.cpu_count() or 1)
    rng_a = np.random.default_rng((seed, 12))
    pat, pmt = _pat(), _pmt()
    pcr0 = FIRST_PTS * 300 - int(0.4 * 27_000_000)
    audio_next = 0
    with open(path, "wb") as fh, ThreadPoolExecutor(workers) as pool:
        tz = _Packetizer(fh)
        pending = deque()

        def submit(f):
            pending.append(pool.submit(
                lambda k: encode_intra_picture(
                    rec.frame(k), rec.row_qs[k], temporal_reference=k % GOP,
                    with_sequence=k % GOP == 0), f))

        for f in range(min(n, 2 * workers)):
            submit(f)
        for f in range(n):
            es = pending.popleft().result()
            if f + 2 * workers < n:
                submit(f + 2 * workers)
            if f % GOP == 0:
                tz.section(0x0000, pat)
                tz.section(PMT_PID, pmt)
            pts = FIRST_PTS + f * FRAME_TICKS
            tz.pes(VIDEO_PID, _pes(0xE0, es, pts, pts - FRAME_TICKS, False),
                   pcr=pcr0 + f * FRAME_TICKS * 300)
            while audio_next * AUDIO_FRAME * 90_000 // AUDIO_RATE \
                    <= f * FRAME_TICKS:
                ta = audio_next * AUDIO_FRAME / AUDIO_RATE
                silent = silent_audio(ta, ta + AUDIO_FRAME / AUDIO_RATE)
                af = aac_frame(None if silent else rng_a)
                apts = (FIRST_PTS
                        + audio_next * AUDIO_FRAME * 90_000 // AUDIO_RATE)
                tz.pes(AUDIO_PID, _pes(0xC0, af, apts, None, True))
                audio_next += 1
        end = FIRST_PTS + n * FRAME_TICKS
        tz.pes(VIDEO_PID, _pes(0xE0, b"\x00\x00\x01\xB7", end, None, False),
               pcr=pcr0 + n * FRAME_TICKS * 300)
        tz.pcr_only(VIDEO_PID, pcr0 + (n + 1) * FRAME_TICKS * 300)
        tz.section(0x0000, pat)
        size = fh.tell()
    return dict(bytes=size, seconds=time.perf_counter() - t0)
