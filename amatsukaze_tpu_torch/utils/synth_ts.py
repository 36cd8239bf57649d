"""A broadcast transport stream from numpy alone: test data for the TS front
end (split, decode, audio), as synth_clip.py is for the filter stages.

`write_ts` lays down a single-program TS: PAT, PMT and PCR as the repo's
test stream generator lays them down (tests/ts_gen.py:build_simple_ts), one
MPEG-2 video stream of intra pictures (interlaced, top field first, the
sequence padded to a multiple of 16 rows by edge replication) and one ADTS
AAC-LC stereo 48 kHz stream. `ts_clip` fills it with a short seeded
synth_clip broadcast layout (program with the logo, 3:2 film; CM of
interlaced video without it; program again) whose audio is silent around
the two cuts, so that the CM pass has silence to find.

The writer keeps what a correct decoder must return: every picture's
reconstruction, made with the inverse DCT of video/mpeg2_ref.idct8x8 (its
two integer stages, evaluated as float64 matrix products, which are exact
at these magnitudes), and every macroblock's quantiser scale. The DCT, the
quantisation and the reconstruction of a picture run on all of its blocks
at once, and so does the VLC: the code and length of every token land in
arrays, and one pass packs them into bytes.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..audio import aac_tables as AT
from ..ts import mpeg2_tables as M
from ..ts.pes import write_timestamp
from ..utils.bits import BitWriter
from ..utils.crc import crc32_mpeg2
from ..video.mpeg2_ref import DEFAULT_INTRA_MATRIX, IDCT_A, ZIGZAG_SCAN
from . import synth_clip

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
QS_CHOICES = np.array([16, 20, 24, 28])  # coarse: intra pictures code fast

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


_DC_LUMA = _dc_table(M.B12_DC_LUMA)
_DC_CHROMA = _dc_table(M.B13_DC_CHROMA)
# table B.14 by (run, |level|): code and length, 0 where it has no entry
_AC_CODE = np.zeros((64, 41), np.int64)
_AC_LEN = np.zeros((64, 41), np.int64)
for _bits, _run, _level in M.B14_DCT:
    if _run != M.EOB_RUN:
        _AC_CODE[_run, _level], _AC_LEN[_run, _level] = _code(_bits)
_EOB = _code(next(b for b, r, _ in M.B14_DCT if r == M.EOB_RUN))
_MB_INTRA = _code(next(b for b, t in M.B2_MB_TYPE_I if t == M.MB_INTRA))
_ADDR_1 = _code(next(e[0] for e in M.B1_ADDR_INC if e[1] == 1))
_ZIGZAG = np.asarray(ZIGZAG_SCAN, np.int64)
_W_INTRA = np.asarray(DEFAULT_INTRA_MATRIX, np.int64)


def _dct_basis() -> np.ndarray:
    b = np.empty((8, 8))
    for u in range(8):
        cu = (1.0 / math.sqrt(2.0)) if u == 0 else 1.0
        for m in range(8):
            b[u, m] = (cu / 2.0) * math.cos((2 * m + 1) * u * math.pi / 16.0)
    return b


_B = _dct_basis()
_A = IDCT_A.astype(np.float64)


# Each 8x8 transform as one product of [N, 64] rows with a 64x64 matrix
# (row-major vec(X M) = vec(X) kron(I, M), vec(M^T X) = vec(X) kron(M, I)),
# whose columns (forward) or rows (inverse) are permuted so that the
# coefficients are in zigzag scan order.
_FDCT = np.kron(_B, _B).T[:, _ZIGZAG]  # vec(B X B^T) = vec(X) kron(B, B)^T
_IDCT_1 = np.kron(np.eye(8), _A)[_ZIGZAG]
_IDCT_2 = np.kron(_A, np.eye(8))
_W_ZIGZAG = _W_INTRA[_ZIGZAG].astype(np.float64)


def _product(x: np.ndarray, m: np.ndarray) -> np.ndarray:
    """x @ m for [N, 64] float64 rows, as a stack of [16, 64] products: each
    is too small for the BLAS library to spread over threads, which on a
    busy host (or beside the writer's own threads) costs more than it
    gives. The result is the same."""
    n = len(x)
    pad = -n % 16
    if pad:
        x = np.concatenate([x, np.zeros((pad, 64))])
    return (x.reshape(-1, 16, 64) @ m).reshape(-1, 64)[:n]


def fdct_blocks(x: np.ndarray) -> np.ndarray:
    """B X B^T of [N, 64] row-major blocks (float64), in zigzag order."""
    return _product(x, _FDCT)


def idct_blocks(coeffs: np.ndarray) -> np.ndarray:
    """video/mpeg2_ref.idct8x8 over [N, 64] coefficients in zigzag order
    (integers, any dtype) to [N, 64] row-major int64 samples: its two
    stages T = (F A + 2^10) >> 11 and X = (A^T T + 2^16) >> 17, as float64
    products. |F| <= 2048 and |A| < 2^14 keep every sum under 2^35, so
    each product is exact and the floor of the scaled sum is the shift."""
    t = _product(coeffs.astype(np.float64), _IDCT_1)
    t = np.floor((t + 1024.0) / 2048.0)
    x = _product(t, _IDCT_2)
    return np.floor((x + 65536.0) / 131072.0).astype(np.int64)


def _blocks(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """[mb_h, mb_w, 6, 8, 8] blocks of MB-aligned 4:2:0 planes in coding
    order (four luma blocks of a macroblock row-major, then Cb, Cr)."""
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
    """MSB-first concatenation of codes[i] in lens[i] bits (a multiple of
    8 in all)."""
    keep = lens > 0
    codes, lens = codes[keep].astype(np.uint64), lens[keep]
    starts = np.cumsum(lens) - lens
    tok = np.repeat(np.arange(len(lens)), lens)
    shift = (lens[tok] - 1 - (np.arange(int(lens.sum())) - starts[tok]))
    bits = (codes[tok] >> shift.astype(np.uint64)) & np.uint64(1)
    return np.packbits(bits.astype(np.uint8)).tobytes()


def sequence_header(width: int, height: int) -> bytes:
    """Sequence header and extension: 16:9, 30000/1001, 4:2:0, interlaced
    (progressive_sequence 0), the default quantiser matrices."""
    w = BitWriter()
    w.write(0x000001B3, 32)
    w.write(width & 0xFFF, 12)
    w.write(height & 0xFFF, 12)
    w.write(3, 4)  # 16:9
    w.write(4, 4)  # 30000/1001
    w.write(50000, 18)
    w.write(1, 1)
    w.write(112, 10)
    w.write(0, 3)  # constrained, no intra matrix, no non-intra matrix
    w.byte_align()
    w.write(0x000001B5, 32)
    w.write(1, 4)
    w.write(0x48, 8)  # main profile, high level
    w.write(0, 1)  # progressive_sequence
    w.write(1, 2)  # 4:2:0
    w.write((width >> 12) & 3, 2)
    w.write((height >> 12) & 3, 2)
    w.write(0, 12)
    w.write(1, 1)
    w.write(0, 8)
    w.write(0, 1)
    w.write(0, 7)  # frame rate extensions
    w.byte_align()
    return w.getvalue()


def picture_header(temporal_reference: int) -> bytes:
    """An I frame picture, top field first, frame DCT only, linear
    quantiser scale, table B.14, zigzag scan, 8-bit DC."""
    w = BitWriter()
    w.write(0x00000100, 32)
    w.write(temporal_reference & 0x3FF, 10)
    w.write(1, 3)  # I
    w.write(0xFFFF, 16)
    w.write(0, 1)
    w.byte_align()
    w.write(0x000001B5, 32)
    w.write(8, 4)
    w.write(0xFFFF, 16)  # f_codes unused
    w.write(0, 2)  # intra_dc_precision
    w.write(3, 2)  # frame picture
    w.write(1, 1)  # top_field_first
    w.write(1, 1)  # frame_pred_frame_dct
    w.write(0, 5)  # concealment, q_scale_type, intra_vlc, alt scan, rff
    w.write(1, 1)  # chroma_420_type
    w.write(0, 1)  # progressive_frame
    w.write(0, 1)  # composite_display
    w.byte_align()
    return w.getvalue()


def encode_intra_picture(planes, row_qs: np.ndarray,
                         temporal_reference: int = 0,
                         with_sequence: bool = True) -> tuple:
    """Code one frame (Y, U, V uint8, 4:2:0) as an MPEG-2 I frame picture
    with one slice per macroblock row at quantiser scale row_qs[row] (even,
    2-62). Returns (coded bytes, reconstruction planes cropped to the
    frame, [mb_h, mb_w] uint8 quantiser scales)."""
    y, u, v = (np.asarray(p) for p in planes)
    h, w = y.shape
    mbh, mbw = (h + 15) // 16, (w + 15) // 16
    pad = [np.pad(p, ((0, r - p.shape[0]), (0, c - p.shape[1])), mode="edge")
           for p, r, c in ((y, mbh * 16, mbw * 16), (u, mbh * 8, mbw * 8),
                           (v, mbh * 8, mbw * 8))]
    qs = np.asarray(row_qs, np.int64)
    assert qs.shape == (mbh,) and np.all(qs % 2 == 0) and np.all(qs >= 2)
    x = _blocks(*pad).reshape(-1, 64).astype(np.float64)
    f = fdct_blocks(x)
    # quantisation (an encoder's choice), then the decoder's dequantisation
    # (7.4.2-7.4.4): DC * 8, AC trunc(2 level W qs / 32), saturation,
    # mismatch control on the last coefficient. lv * W qs / 16 is an
    # integer below 2^31, so the float64 arithmetic is exact.
    dc = np.clip(np.rint(f[:, 0] / 8.0), 0, 255)
    bq = np.repeat(qs, mbw * 6).astype(np.float64)[:, None]
    lv = f
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
    rec = np.clip(idct_blocks(coef), 0, 255).astype(np.uint8)
    ry, ru, rv = _planes(rec.reshape(mbh, mbw, 6, 8, 8))
    recon = (ry[:h, :w], ru[:h // 2, :w // 2], rv[:h // 2, :w // 2])
    dc = dc.astype(np.int64)

    # tokens: per block [slice start code, slice/macroblock header, DC
    # size, DC bits, AC..., EOB, row padding]
    nb = mbh * mbw * 6
    row = np.repeat(np.arange(mbh), mbw * 6)
    col = np.tile(np.repeat(np.arange(mbw), 6), mbh)
    blk = np.tile(np.arange(6), mbh * mbw)
    # DC differences, the predictors reset to 128 at each slice
    dcs = dc.reshape(mbh, mbw, 6)
    diff = np.empty_like(dcs)
    luma = dcs[:, :, :4].reshape(mbh, -1)
    ld = np.diff(luma, axis=1, prepend=128)
    diff[:, :, :4] = ld.reshape(mbh, mbw, 4)
    for c in (4, 5):
        diff[:, :, c] = np.diff(dcs[:, :, c], axis=1, prepend=128)
    diff = diff.reshape(-1)
    size = np.frexp(np.abs(diff).astype(np.float64))[1].astype(np.int64)
    dc_tab = np.where((blk < 4)[:, None], _DC_LUMA[size], _DC_CHROMA[size])
    dc_bits = np.where(diff > 0, diff, diff + (1 << size) - 1)
    # AC runs and levels
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
    in_tab = mag <= 40
    tl = np.where(in_tab, _AC_LEN[run, np.minimum(mag, 40)], 0)
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
    # quantiser_scale_code (5), extra_bit_slice 0, then the MB header
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
    # zero bits to the next byte at the end of each slice
    tok_row = np.repeat(row, count)
    row_bits = np.bincount(tok_row, weights=lens, minlength=mbh)
    last = start[(col == mbw - 1) & (blk == 5)] + 5 + \
        n_ac[(col == mbw - 1) & (blk == 5)]
    lens[last] = (-row_bits.astype(np.int64)) % 8
    body = _pack(codes, lens)
    hdr = (sequence_header(w, h) if with_sequence else b"") + \
        picture_header(temporal_reference)
    qmap = np.repeat(qs.astype(np.uint8)[:, None], mbw, axis=1)
    return hdr + body, recon, qmap


# ---------------------------------------------------------------------------
# ADTS AAC-LC stereo
# ---------------------------------------------------------------------------

_HCB11 = {vals: (n, code) for n, code, vals in AT.HCB_11}
_SF_ZERO = next((n, code) for n, code, vals in AT.HCB_SF if vals[0] == 60)
_SWB_LONG_48K = AT.SWB_OFFSETS[(1024, AUDIO_RATE)]
LOUD_BANDS = 30  # scale-factor bands carrying the noise of a loud frame
LOUD_LEVEL = 6  # largest quantised spectral magnitude of a loud frame
LOUD_GAIN = 160  # global gain (scale factor) of a loud frame: RMS about 0.08


def _adts(payload: bytes) -> bytes:
    h = BitWriter()
    h.write(0xFFF, 12)
    h.write(1, 1)  # MPEG-2
    h.write(0, 2)
    h.write(1, 1)  # no CRC
    h.write(1, 2)  # AAC LC
    h.write(3, 4)  # 48 kHz
    h.write(0, 1)
    h.write(2, 3)  # stereo
    h.write(0, 4)
    h.write(7 + len(payload), 13)
    h.write(0x7FF, 11)
    h.write(0, 2)
    return h.getvalue() + payload


def aac_frame(rng: np.random.Generator | None) -> bytes:
    """One ADTS frame: a CPE with a common long window. rng None gives a
    silent frame (no band coded), else seeded noise in the lowest
    LOUD_BANDS bands of both channels (codebook 11, scale factor
    LOUD_GAIN)."""
    w = BitWriter()
    w.write(1, 3)  # ID_CPE
    w.write(0, 4)
    w.write(1, 1)  # common_window
    n_sfb = 0 if rng is None else LOUD_BANDS
    w.write(0, 1)  # ics_reserved_bit
    w.write(0, 2)  # ONLY_LONG_SEQUENCE
    w.write(0, 1)  # window shape
    w.write(n_sfb, 6)
    w.write(0, 1)  # no predictor
    w.write(0, 2)  # ms_mask_present
    for _ in range(2):
        w.write(LOUD_GAIN, 8)
        if n_sfb:
            w.write(11, 4)  # one section of codebook 11
            rem = n_sfb
            while rem >= 31:
                w.write(31, 5)
                rem -= 31
            w.write(rem, 5)
            for _ in range(n_sfb):
                w.write(_SF_ZERO[1], _SF_ZERO[0])
        w.write(0, 3)  # no pulse, TNS or gain control
        if n_sfb:
            vals = rng.integers(-LOUD_LEVEL, LOUD_LEVEL + 1,
                                _SWB_LONG_48K[n_sfb]).tolist()
            for a, b in zip(vals[::2], vals[1::2]):
                n, code = _HCB11[(abs(a), abs(b))]
                w.write(code, n)
                for s in (a, b):
                    if s:
                        w.write(1 if s < 0 else 0, 1)
    w.write(7, 3)  # ID_END
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
    def __init__(self):
        self.cc: dict[int, int] = {}
        self.out = bytearray()

    def _packet(self, pid: int, chunk: bytes, pusi: bool,
                pcr: int | None = None) -> None:
        cc = self.cc.get(pid, 0)
        self.cc[pid] = (cc + 1) & 0xF
        hdr = bytes([0x47, (0x40 if pusi else 0) | (pid >> 8), pid & 0xFF])
        if pcr is None and len(chunk) == 184:
            self.out += hdr + bytes([0x10 | cc]) + chunk
            return
        af = bytes([0x10]) + _pcr_field(pcr) if pcr is not None else b""
        if pcr is None and len(chunk) == 183:
            af_field = b"\x00"
        else:
            af = af or b"\x00"
            af += b"\xFF" * (183 - len(chunk) - len(af))
            af_field = bytes([len(af)]) + af
        self.out += hdr + bytes([0x30 | cc]) + af_field + chunk

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
        self.out += bytes([0x47, pid >> 8, pid & 0xFF, 0x20 | cc,
                           183]) + af


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------


@dataclass
class SynthTs:
    """What write_ts laid down: the reconstruction of every frame (display
    order, what a decoder must return), each frame's [mb_h, mb_w]
    quantiser scales, the ADTS frames, and the writer's seconds."""

    path: str
    num_frames: int
    recon: list = field(default_factory=list)
    qp_maps: list = field(default_factory=list)
    audio_frames: list = field(default_factory=list)
    pts: list = field(default_factory=list)
    size: int = 0
    seconds: float = 0.0


def _pictures(frames, num_frames: int, rng, workers: int):
    """(coded bytes, reconstruction, quantiser scales) of each frame, in
    order; the pictures are coded on `workers` threads (numpy releases the
    GIL in its array work), at most 2 * workers ahead of the consumer."""
    it = iter(frames)
    with ThreadPoolExecutor(workers) as pool:
        pending = deque()
        for f in range(num_frames):
            planes = next(it)
            row_qs = rng.choice(QS_CHOICES, (planes[0].shape[0] + 15) // 16)
            pending.append(pool.submit(
                encode_intra_picture, planes, row_qs,
                temporal_reference=f % GOP, with_sequence=f % GOP == 0))
            if len(pending) >= 2 * workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def write_ts(path: str, frames, num_frames: int, silent_audio,
             seed: int) -> SynthTs:
    """Write `num_frames` (Y, U, V) frames of `frames` (an iterable) as
    intra pictures (one slice per macroblock row, its quantiser scale
    drawn from QS_CHOICES; a sequence header every GOP frames) with AAC
    frames that are silent where silent_audio(t0, t1) (seconds) is true,
    to `path`. The pictures are coded on one thread per core, at most 8."""
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    # one generator for the quantisers, one for the audio: the pictures
    # are drawn ahead of the muxing, by as many as the threads take
    rng_q = np.random.default_rng((seed, 4))
    rng_a = np.random.default_rng((seed, 5))
    tz = _Packetizer()
    pat, pmt = _pat(), _pmt()
    # the PCR leads the PTS by 0.4 s, as the test generator's does
    pcr0 = FIRST_PTS * 300 - int(0.4 * 27_000_000)
    out = SynthTs(path, num_frames)
    audio_next = 0
    pictures = _pictures(frames, num_frames, rng_q, workers)
    for f, (es, rec, qmap) in enumerate(pictures):
        if f % GOP == 0:
            tz.section(0x0000, pat)
            tz.section(PMT_PID, pmt)
        out.recon.append(rec)
        out.qp_maps.append(qmap)
        pts = FIRST_PTS + f * FRAME_TICKS
        out.pts.append(pts)
        tz.pes(VIDEO_PID, _pes(0xE0, es, pts, pts - FRAME_TICKS, False),
               pcr=pcr0 + f * FRAME_TICKS * 300)
        # audio keeps pace with the video's time
        while audio_next * AUDIO_FRAME * 90_000 // AUDIO_RATE \
                <= f * FRAME_TICKS:
            ta = audio_next * AUDIO_FRAME / AUDIO_RATE
            silent = silent_audio(ta, ta + AUDIO_FRAME / AUDIO_RATE)
            af = aac_frame(None if silent else rng_a)
            out.audio_frames.append(af)
            apts = FIRST_PTS + audio_next * AUDIO_FRAME * 90_000 // AUDIO_RATE
            tz.pes(AUDIO_PID, _pes(0xC0, af, apts, None, True))
            audio_next += 1
    # sequence_end_code in a PES of its own: its start completes the last
    # picture's PES (video PES are unbounded), which a demuxer would hold
    # back at the end of the stream otherwise
    end = FIRST_PTS + num_frames * FRAME_TICKS
    tz.pes(VIDEO_PID, _pes(0xE0, b"\x00\x00\x01\xB7", end, None, False),
           pcr=pcr0 + num_frames * FRAME_TICKS * 300)
    tz.pcr_only(VIDEO_PID, pcr0 + (num_frames + 1) * FRAME_TICKS * 300)
    tz.section(0x0000, pat)
    with open(path, "wb") as fh:
        fh.write(tz.out)
    out.size = len(tz.out)
    out.seconds = time.perf_counter() - t0
    return out


# The short broadcast layout of the TS front end: program (3:2 film, the
# logo on), CM (interlaced video, no logo), program, with SILENCE_SECONDS of
# silent audio centred on each cut. Scenes keep synth_clip's textures.
TS_FRAMES = 96
TS_CUTS = (40, 72)
TS_SCENES = (
    (0,) + synth_clip.BROADCAST_SCENES[0][1:],
    (TS_CUTS[0],) + synth_clip.BROADCAST_SCENES[2][1:],
    (TS_CUTS[1],) + synth_clip.BROADCAST_SCENES[3][1:],
)
SILENCE_SECONDS = 0.5
TS_CLIPS = {
    "small": dict(h=96, w=128, lh=16, lw=24, lx=96, ly=8, seed=5),
    "broadcast": dict(h=1080, w=1440, lh=96, lw=256, lx=1120, ly=40,
                      seed=1),
}


def silent_around_cuts(t0: float, t1: float) -> bool:
    """True for an audio frame [t0, t1) s that overlaps SILENCE_SECONDS
    centred on a cut of TS_SCENES."""
    for cut in TS_CUTS:
        mid = cut * 1001 / 30000
        if t0 < mid + SILENCE_SECONDS / 2 and t1 > mid - SILENCE_SECONDS / 2:
            return True
    return False


def ts_clip(name: str, path: str):
    """Write the short broadcast layout at one size (synth_clip's
    BROADCAST_CLIPS geometry) to `path`. Returns (SynthTs, format, logos)."""
    spec = TS_CLIPS[name]
    geom = {k: spec[k] for k in ("h", "w", "lh", "lw", "lx", "ly")}
    frames = synth_clip.make_broadcast_clip(**spec, scenes=TS_SCENES,
                                            num_frames=TS_FRAMES)
    ts = write_ts(path, frames, TS_FRAMES, silent_around_cuts, spec["seed"])
    return (ts, synth_clip.video_format(spec["h"], spec["w"]),
            synth_clip.make_logos(**geom))
