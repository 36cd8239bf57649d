"""Pure-Python MPEG-2 video decoder (ISO/IEC 13818-2, 4:2:0 and 4:2:2).

This is the *oracle*: every arithmetic step is defined here in exactly
reproducible integer terms, and the native C++ engine
(native/mpeg2dec.cpp) mirrors it bit-for-bit — the differential fuzz
suite (tests/test_mpeg2_decode.py) holds the two equal on randomized
conformant streams.

The reference project decodes via FFmpeg (reference
Amatsukaze/AMTSource.hpp:97-152, ReaderWriterFFmpeg.hpp:256-483) so there
is no reference decoder code to mirror; everything here is implemented
from the 13818-2 spec semantics:

- slice/macroblock/block syntax 6.2.4-6.2.6 (shared VLC tables with the
  QP extractor, ts/mpeg2_tables.py)
- dequantisation 7.4.2 (integer "/" = truncate toward zero), saturation
  7.4.3, mismatch control 7.4.4
- motion vector decode/prediction 7.6.3 incl. field vectors in frame
  pictures (PMV stored doubled), dual prime derivation 7.6.3.6
- prediction modes 7.6.2: frame, field-in-frame, field, 16x8, dual prime,
  half-sample bilinear interpolation 7.7, bidirectional averaging
- skipped macroblocks 7.6.6 per picture type/structure
- field/frame DCT sample interleave 6.1.3, both scan orders 7.3

Defined (implementation-chosen) arithmetic the spec leaves open:
- the IDCT: a fixed-point separable 8x8 transform (14-bit coefficients,
  stage shifts 11/17, floor rounding with +half bias) — see idct8x8().
  Error vs. the ideal float IDCT is sub-LSB per block; both engines use
  the identical integer matrix so they agree exactly.
- out-of-bounds motion vectors (non-conformant streams) clamp the source
  block into the picture instead of crashing.

Decoder policy: P/B pictures arriving before the first I picture are
dropped (mid-GOP stream starts); field pairs are assembled into frames
and emitted in display order (B immediately, references delayed one).

The port's copy of amatsukaze_tpu/video/mpeg2_ref.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..ts import mpeg2_tables as T
from ..utils.bits import BitReader, EOFError_

# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

# Scan orders: scan[n] = raster index of the n-th transmitted coefficient.
ZIGZAG_SCAN = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)
ALTERNATE_SCAN = (
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63,
)

# Default quantiser matrices (13818-2 6.3.11), raster order.
DEFAULT_INTRA_MATRIX = (
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
)
DEFAULT_NON_INTRA_MATRIX = (16,) * 64

NONLINEAR_QSCALE = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22,
    24, 28, 32, 36, 40, 44, 48, 52, 56, 64, 72, 80, 88, 96, 104, 112,
)


def _idct_matrix() -> np.ndarray:
    """A[u][m] = round(2^14 * c(u)/2 * cos((2m+1) u pi / 16))."""
    a = np.empty((8, 8), np.int64)
    for u in range(8):
        cu = (1.0 / math.sqrt(2.0)) if u == 0 else 1.0
        for m in range(8):
            a[u, m] = round(16384.0 * (cu / 2.0)
                            * math.cos((2 * m + 1) * u * math.pi / 16.0))
    return a


IDCT_A = _idct_matrix()


def idct8x8(coeffs: np.ndarray) -> np.ndarray:
    """Fixed-point 8x8 inverse DCT, int in -> int out.

    x = B^T F B with B[u][m] = c(u)/2 cos((2m+1)u pi/16), evaluated as
    two integer stages over A = round(2^14 B):
      stage1: T = (F @ A + 2^10) >> 11      (~ 8 * F B)
      stage2: x = (A^T @ T + 2^16) >> 17    (~ B^T F B)
    Shifts are arithmetic (floor); both engines implement exactly this.
    """
    f = np.asarray(coeffs, np.int64).reshape(8, 8)
    t = (f @ IDCT_A + 1024) >> 11
    return (IDCT_A.T @ t + 65536) >> 17


def _div2_trunc(v: int) -> int:
    """Integer /2 truncating toward zero (chroma vector scaling 7.6.3.7)."""
    return -((-v) >> 1) if v < 0 else v >> 1


def _dp_half(v: int) -> int:
    """Dual-prime x/2 rounding half away from zero: (v + (v>0)) >> 1."""
    return (v + (1 if v > 0 else 0)) >> 1


# ---------------------------------------------------------------------------
# VLC decode (LUT, mirroring the native engine's structure)
# ---------------------------------------------------------------------------


class _Vlc:
    __slots__ = ("maxlen", "lut")

    def __init__(self, entries):
        self.maxlen = max(len(e[0]) for e in entries)
        self.lut = [None] * (1 << self.maxlen)
        for e in entries:
            code = int(e[0], 2)
            pad = self.maxlen - len(e[0])
            base = code << pad
            val = e[1] if len(e) == 2 else tuple(e[1:])
            for p in range(1 << pad):
                self.lut[base | p] = (len(e[0]), val)

    def decode(self, r: BitReader):
        avail = min(self.maxlen, r.bits_left())
        if avail <= 0:
            raise EOFError_("vlc at end")
        word = r.peek(avail) << (self.maxlen - avail)
        hit = self.lut[word]
        if hit is None or hit[0] > avail:
            raise Mpeg2Error("vlc desync")
        r.skip(hit[0])
        return hit[1]


_VLC_ADDR = _Vlc(T.B1_ADDR_INC)
_VLC_MBT = {1: _Vlc(T.B2_MB_TYPE_I), 2: _Vlc(T.B3_MB_TYPE_P),
            3: _Vlc(T.B4_MB_TYPE_B)}
_VLC_CBP = _Vlc(T.B9_CBP)
_VLC_MC = _Vlc(T.B10_MOTION_CODE)
_VLC_DMV = _Vlc(T.B11_DMVECTOR)
_VLC_DC_L = _Vlc(T.B12_DC_LUMA)
_VLC_DC_C = _Vlc(T.B13_DC_CHROMA)
_VLC_B14 = _Vlc(T.B14_DCT)
_VLC_B15 = _Vlc(T.B15_DCT)
_ESC_LEN = len(T.DCT_ESCAPE)
_ESC_CODE = int(T.DCT_ESCAPE, 2)
_ADDR_ESC_LEN = len(T.ADDR_INC_ESCAPE)
_ADDR_ESC_CODE = int(T.ADDR_INC_ESCAPE, 2)


class Mpeg2Error(Exception):
    """Bitstream error / unsupported feature."""


# ---------------------------------------------------------------------------
# Stream state
# ---------------------------------------------------------------------------


@dataclass
class _Seq:
    width: int = 0
    height: int = 0
    chroma_format: int = 1
    mpeg1: bool = True  # no sequence extension seen yet (11172-2 mode)
    progressive: bool = False
    intra_q: np.ndarray = field(
        default_factory=lambda: np.array(DEFAULT_INTRA_MATRIX, np.int64))
    non_intra_q: np.ndarray = field(
        default_factory=lambda: np.array(DEFAULT_NON_INTRA_MATRIX, np.int64))
    valid: bool = False


@dataclass
class _Pic:
    coding_type: int = 0
    temporal_reference: int = 0
    f_code: tuple = ((15, 15), (15, 15))
    intra_dc_precision: int = 0
    structure: int = 3  # 1 top field, 2 bottom field, 3 frame
    top_field_first: bool = False
    frame_pred_frame_dct: bool = True
    concealment: bool = False
    q_scale_type: bool = False
    intra_vlc_format: bool = False
    alternate_scan: bool = False
    repeat_first_field: bool = False
    progressive_frame: bool = False
    full_pel: tuple = (False, False)  # MPEG-1 compat, unused for MPEG-2


@dataclass
class DecodedFrame:
    """One output frame (display order). Planes are coded-size-cropped."""

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    coding_type: int = 0
    temporal_reference: int = 0
    progressive_frame: bool = False
    top_field_first: bool = False
    repeat_first_field: bool = False


class _FrameBuf:
    """Reconstruction target: mb-aligned planes + output metadata."""

    def __init__(self, mbw: int, mbh: int, chroma_format: int = 1):
        ch = 8 if chroma_format == 1 else 16  # 4:2:2 keeps full height
        self.y = np.zeros((mbh * 16, mbw * 16), np.uint8)
        self.u = np.zeros((mbh * ch, mbw * 8), np.uint8)
        self.v = np.zeros((mbh * ch, mbw * 8), np.uint8)
        self.meta = {}

    def field(self, plane: str, parity: int) -> np.ndarray:
        """View of one field (parity 0 = top)."""
        return getattr(self, plane)[parity::2]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class Mpeg2RefDecoder:
    def __init__(self):
        self.seq = _Seq()
        self.pic = _Pic()
        self._ref_old: _FrameBuf | None = None   # forward ref for B
        self._ref_new: _FrameBuf | None = None   # most recent reference
        self._pending: _FrameBuf | None = None   # reference awaiting output
        self._cur: _FrameBuf | None = None
        self._cur_first_parity = 0
        self._in_second_field = False
        self._have_i = False
        self.errors = 0

    # ---- public API --------------------------------------------------------

    def decode_picture(self, chunk: bytes) -> list[DecodedFrame]:
        """Decode one coded picture (ES bytes incl. leading headers as
        produced by ts.qp_extract.iter_picture_chunks). Returns 0+ frames
        in display order."""
        out: list[DecodedFrame] = []
        units = list(_iter_units(bytes(chunk)))
        saw_picture = False
        slices = []
        for code, payload in units:
            r = BitReader(payload)
            try:
                if code == 0xB3:
                    self._sequence_header(r)
                elif code == 0xB5:
                    self._extension(r)
                elif code == 0x00:
                    if saw_picture:
                        break
                    self._picture_header(r)
                    saw_picture = True
                elif 0x01 <= code <= 0xAF:
                    if saw_picture:
                        slices.append((code, payload))
            except (EOFError_, Mpeg2Error):
                self.errors += 1
        if not saw_picture or not self.seq.valid:
            return out
        if self.seq.chroma_format not in (1, 2):
            raise Mpeg2Error("only 4:2:0 / 4:2:2 are supported")
        ct = self.pic.coding_type
        if ct not in (1, 2, 3):  # D pictures (MPEG-1) unsupported
            self.errors += 1
            return out
        if not self._in_second_field:
            # Drop lead-in pictures that lack what they predict from; a
            # second field always continues its in-progress frame (its
            # same-parity reference can be the first field itself).
            if not self._have_i and ct != 1:
                return out  # drop P/B before the first I
            if ct in (2, 3) and self._ref_new is None:
                return out

        frame_done = self._decode_slices(slices)
        if ct == 1:
            self._have_i = True  # even mid frame: an I first field anchors
        if not frame_done:
            return out

        fin = self._cur
        self._cur = None
        if ct == 3:
            out.append(_emit(fin, self.seq))
        else:
            if self._pending is not None:
                out.append(_emit(self._pending, self.seq))
            self._pending = fin
            self._ref_old = self._ref_new
            self._ref_new = fin
        return out

    def flush(self) -> list[DecodedFrame]:
        """Emit the final pending reference frame."""
        out = []
        if self._pending is not None:
            out.append(_emit(self._pending, self.seq))
            self._pending = None
        return out

    # ---- headers -----------------------------------------------------------

    def _sequence_header(self, r: BitReader) -> None:
        s = self.seq
        s.width = r.read(12)
        s.height = r.read(12)
        r.skip(4 + 4 + 18 + 1 + 10 + 1)
        if r.read(1):
            s.intra_q = _load_matrix(r)
        else:
            s.intra_q = np.array(DEFAULT_INTRA_MATRIX, np.int64)
        if r.read(1):
            s.non_intra_q = _load_matrix(r)
        else:
            s.non_intra_q = np.array(DEFAULT_NON_INTRA_MATRIX, np.int64)
        s.mpeg1 = True  # MPEG-2 iff a sequence extension follows
        s.valid = True

    def _extension(self, r: BitReader) -> None:
        ext = r.read(4)
        if ext == 1:  # sequence extension
            self.seq.mpeg1 = False
            r.skip(8)
            self.seq.progressive = bool(r.read(1))
            self.seq.chroma_format = r.read(2)
            self.seq.width |= r.read(2) << 12
            self.seq.height |= r.read(2) << 12
            r.skip(12 + 1 + 8 + 1 + 2 + 5)
        elif ext == 8:  # picture coding extension
            p = self.pic
            fc = [[r.read(4), r.read(4)], [r.read(4), r.read(4)]]
            p.f_code = (tuple(fc[0]), tuple(fc[1]))
            p.intra_dc_precision = r.read(2)
            p.structure = r.read(2)
            p.top_field_first = bool(r.read(1))
            p.frame_pred_frame_dct = bool(r.read(1))
            p.concealment = bool(r.read(1))
            p.q_scale_type = bool(r.read(1))
            p.intra_vlc_format = bool(r.read(1))
            p.alternate_scan = bool(r.read(1))
            p.repeat_first_field = bool(r.read(1))
            r.skip(1)
            p.progressive_frame = bool(r.read(1))
        elif ext == 3:  # quant matrix extension
            if r.read(1):
                self.seq.intra_q = _load_matrix(r)
            if r.read(1):
                self.seq.non_intra_q = _load_matrix(r)
            if r.read(1):
                _load_matrix(r)  # chroma intra: 4:2:0 uses the luma matrix
            if r.read(1):
                _load_matrix(r)

    def _picture_header(self, r: BitReader) -> None:
        p = _Pic()
        p.temporal_reference = r.read(10)
        p.coding_type = r.read(3)
        r.skip(16)
        fp = [False, False]
        if p.coding_type in (2, 3, 4):
            fp[0] = bool(r.read(1))
            fc = r.read(3)
            p.f_code = ((fc, fc), p.f_code[1])
        if p.coding_type == 3:
            fp[1] = bool(r.read(1))
            fc = r.read(3)
            p.f_code = (p.f_code[0], (fc, fc))
        p.full_pel = tuple(fp)
        if self.seq.mpeg1:
            # 11172-2 fixed coding context (no picture coding extension)
            p.structure = 3
            p.frame_pred_frame_dct = True
            p.intra_dc_precision = 0
            p.q_scale_type = False
            p.intra_vlc_format = False
            p.alternate_scan = False
            p.progressive_frame = True
            p.top_field_first = False
        self.pic = p

    # ---- picture/slice machinery --------------------------------------------

    def _mb_dims(self) -> tuple[int, int]:
        mbw = (self.seq.width + 15) // 16
        h = self.seq.height if self.pic.structure == 3 else \
            (self.seq.height + 1) // 2
        mbh = (h + 15) // 16
        return mbw, mbh

    def _decode_slices(self, slices) -> bool:
        """Decode all slices of the current picture into the target
        buffer; returns True when a full frame is now complete."""
        p = self.pic
        frame_pic = p.structure == 3
        mbw, mbh = self._mb_dims()

        if frame_pic or not self._in_second_field:
            # A field picture's buffer holds the full FRAME (both fields
            # interleaved), i.e. twice the field-picture MB height.
            self._cur = _FrameBuf(mbw, mbh if frame_pic else 2 * mbh,
                                  self.seq.chroma_format)
            self._cur.meta = dict(
                coding_type=p.coding_type,
                temporal_reference=p.temporal_reference,
                progressive_frame=p.progressive_frame,
                top_field_first=p.top_field_first if frame_pic
                else (p.structure == 1),
                repeat_first_field=p.repeat_first_field,
            )
            if not frame_pic:
                self._cur_first_parity = 0 if p.structure == 1 else 1
        cur_parity = None
        if not frame_pic:
            cur_parity = 0 if p.structure == 1 else 1

        st = _SliceState(self, mbw, mbh, cur_parity)
        for code, payload in slices:
            r = BitReader(payload)
            try:
                st.decode_slice(r, code)
            except (EOFError_, Mpeg2Error):
                self.errors += 1

        if frame_pic:
            self._in_second_field = False
            return True
        if self._in_second_field:
            self._in_second_field = False
            return True
        self._in_second_field = True
        return False

    # ---- reference field access ---------------------------------------------

    def _ref_frame(self, s: int) -> _FrameBuf | None:
        """Reference frame for direction s (0 fwd, 1 bwd) per picture type."""
        if self.pic.coding_type == 2:
            return self._ref_new
        if s == 0:
            return self._ref_old if self._ref_old is not None else \
                self._ref_new
        return self._ref_new

    def _ref_field(self, s: int, parity: int, cur_parity: int):
        """(y, u, v) field views for direction s / selected parity, from a
        FIELD picture (7.6.2.1): in the second field of a P frame, the
        same-parity field comes from the previous reference frame and the
        opposite-parity field is the current frame's first field."""
        frame = self._ref_frame(s)
        if (self.pic.coding_type == 2 and s == 0 and self._in_second_field
                and parity == self._cur_first_parity):
            frame = self._cur
        if frame is None:
            frame = self._cur  # degenerate; keeps index math alive
        return (frame.field("y", parity), frame.field("u", parity),
                frame.field("v", parity))


def _emit(buf: _FrameBuf, seq: _Seq) -> DecodedFrame:
    h, w = seq.height, seq.width
    ch = (h + 1) // 2 if seq.chroma_format == 1 else h
    return DecodedFrame(
        y=buf.y[:h, :w].copy(),
        u=buf.u[:ch, :(w + 1) // 2].copy(),
        v=buf.v[:ch, :(w + 1) // 2].copy(),
        **buf.meta,
    )


def _load_matrix(r: BitReader) -> np.ndarray:
    """Quantiser matrix: 64 values in zigzag transmission order."""
    m = np.zeros(64, np.int64)
    for i in range(64):
        m[ZIGZAG_SCAN[i]] = r.read(8)
    return m


def _iter_units(es: bytes):
    n = len(es)
    i = 0
    while i + 4 <= n:
        if not (es[i] == 0 and es[i + 1] == 0 and es[i + 2] == 1):
            i += 1
            continue
        code = es[i + 3]
        j = i + 4
        while j + 3 <= n and not (es[j] == 0 and es[j + 1] == 0
                                  and es[j + 2] == 1):
            j += 1
        end = j if j + 3 <= n else n
        yield code, es[i + 4:end]
        i = end


# ---------------------------------------------------------------------------
# Slice decoding
# ---------------------------------------------------------------------------


class _SliceState:
    """Per-picture decode state shared across slices (PMVs etc. reset per
    slice; quant matrices / targets live for the picture)."""

    def __init__(self, dec: Mpeg2RefDecoder, mbw: int, mbh: int,
                 cur_parity):
        self.dec = dec
        self.mbw = mbw
        self.mbh = mbh
        self.cur_parity = cur_parity          # None for frame pictures
        p = dec.pic
        self.frame_pic = p.structure == 3
        self.scan = ALTERNATE_SCAN if p.alternate_scan else ZIGZAG_SCAN
        self.dc_mult = 8 >> p.intra_dc_precision
        self.dc_reset = 1 << (p.intra_dc_precision + 7)
        # chroma geometry: 4:2:0 halves both dims; 4:2:2 keeps height
        self.cf = dec.seq.chroma_format
        self.c_rows = 8 if self.cf == 1 else 16   # chroma rows per MB
        self.block_count = 6 if self.cf == 1 else 8
        # per-slice state
        self.pmv = np.zeros((2, 2, 2), np.int64)
        self.dc_pred = [self.dc_reset] * 3
        self.qs = 2
        # previous-MB info for B skipped MBs
        self.prev_flags = 0

    # ---- helpers ------------------------------------------------------------

    def qscale(self, code: int) -> int:
        if code < 1 or code > 31:
            raise Mpeg2Error("bad quantiser code")
        return NONLINEAR_QSCALE[code] if self.dec.pic.q_scale_type \
            else code * 2

    def reset_dc(self):
        self.dc_pred = [self.dc_reset] * 3

    def reset_pmv(self):
        self.pmv[:] = 0

    # ---- motion vectors ------------------------------------------------------

    def _mv_delta(self, r: BitReader, fcode: int) -> int:
        mag = _VLC_MC.decode(r)
        if mag == 0:
            return 0
        sign = r.read(1)
        r_size = fcode - 1
        residual = r.read(r_size) if r_size else 0
        delta = ((mag - 1) << r_size) + residual + 1
        return -delta if sign else delta

    def _mv(self, r: BitReader, rr: int, s: int, vertical_field: bool,
            dmv: bool):
        """Decode motion_vector(r, s); updates pmv[rr][s]; returns
        (vx, vy, (dmx, dmy))."""
        p = self.dec.pic
        dm = [0, 0]
        v = [0, 0]
        for t in (0, 1):
            fcode = p.f_code[s][t]
            if fcode == 15:
                raise Mpeg2Error("vector present with f_code 15")
            delta = self._mv_delta(r, fcode)
            pred = int(self.pmv[rr][s][t])
            if t == 1 and vertical_field and self.frame_pic:
                pred = _div2_trunc(pred)
            f = 1 << (fcode - 1)
            val = pred + delta
            rng = 32 * f
            if val < -16 * f:
                val += rng
            elif val > 16 * f - 1:
                val -= rng
            if t == 1 and vertical_field and self.frame_pic:
                self.pmv[rr][s][t] = 2 * val
            else:
                self.pmv[rr][s][t] = val
            v[t] = val
            if dmv:
                dm[t] = _VLC_DMV.decode(r)
        return v[0], v[1], (dm[0], dm[1])

    # ---- block decode ---------------------------------------------------------

    def _block(self, r: BitReader, intra: bool, cc: int) -> np.ndarray:
        """Decode + dequantise one 8x8 block -> int64 raster coefficients
        (saturated, mismatch-controlled). cc: 0 luma, 1 Cb, 2 Cr."""
        p = self.dec.pic
        seq = self.dec.seq
        mpeg1 = seq.mpeg1
        coeffs = np.zeros(64, np.int64)
        w_intra = seq.intra_q
        w_non = seq.non_intra_q
        qs = self.qs
        n = 0
        if intra:
            size = (_VLC_DC_L if cc == 0 else _VLC_DC_C).decode(r)
            diff = 0
            if size:
                bits = r.read(size)
                diff = bits if bits >= (1 << (size - 1)) else \
                    bits - (1 << size) + 1
            self.dc_pred[cc] += diff
            coeffs[0] = self.dc_pred[cc] * self.dc_mult
            n = 1
            first = False
        else:
            first = True
        table = _VLC_B15 if (intra and p.intra_vlc_format) else _VLC_B14
        while True:
            if first and r.peek(1) == 1:
                r.skip(1)
                sign = r.read(1)
                run, level = 0, (-1 if sign else 1)
                first = False
            else:
                first = False
                if r.bits_left() >= _ESC_LEN and \
                        r.peek(_ESC_LEN) == _ESC_CODE:
                    r.skip(_ESC_LEN)
                    run = r.read(6)
                    if mpeg1:
                        # 11172-2 escape: 8-bit level, double byte for
                        # |level| in 128..255
                        b0 = r.read(8)
                        if b0 == 0:
                            level = r.read(8)
                        elif b0 == 128:
                            level = r.read(8) - 256
                        else:
                            level = b0 - 256 if b0 > 128 else b0
                        if level == 0:
                            raise Mpeg2Error("forbidden escape level")
                    else:
                        lv = r.read(12)
                        if lv == 0 or lv == 2048:
                            raise Mpeg2Error("forbidden escape level")
                        level = lv - 4096 if lv >= 2048 else lv
                else:
                    run, mag = table.decode(r)
                    if run == T.EOB_RUN:
                        break
                    sign = r.read(1)
                    level = -mag if sign else mag
            n += run
            if n > 63:
                raise Mpeg2Error("coefficient run past block end")
            pos = self.scan[n]
            n += 1
            # dequant (7.4.2): "/" truncates toward zero
            if intra:
                if pos != 0:
                    num = 2 * level * int(w_intra[pos]) * qs
                    coeffs[pos] = int(num / 32) if num < 0 else num // 32
                else:
                    coeffs[pos] = level  # only via run past DC: invalid
            else:
                k = 0 if level == 0 else (1 if level > 0 else -1)
                num = (2 * level + k) * int(w_non[pos]) * qs
                coeffs[pos] = -((-num) // 32) if num < 0 else num // 32
            if mpeg1 and pos != 0:
                # 11172-2 2.4.4: per-coefficient oddification replaces
                # MPEG-2's per-block mismatch control (DC exempt)
                c = int(coeffs[pos])
                if c and (c & 1) == 0:
                    coeffs[pos] = c - 1 if c > 0 else c + 1
        np.clip(coeffs, -2048, 2047, out=coeffs)
        if not mpeg1 and int(coeffs.sum()) & 1 == 0:
            coeffs[63] ^= 1
        return coeffs

    # ---- prediction -----------------------------------------------------------

    def _zero_mb(self) -> dict:
        return {"y": np.zeros((16, 16), np.int32),
                "u": np.zeros((self.c_rows, 8), np.int32),
                "v": np.zeros((self.c_rows, 8), np.int32)}

    def _pred_mb(self, preds) -> dict:
        """Average 1-2 directional predictions into one (y,u,v) dict."""
        if len(preds) == 1:
            return preds[0]
        out = {}
        for k in ("y", "u", "v"):
            out[k] = (preds[0][k] + preds[1][k] + 1) >> 1
        return out

    def _fetch(self, plane: np.ndarray, sy: int, sx: int, h: int, w: int):
        """Half-sample bilinear fetch; (sy, sx) in half-sample units."""
        fy, fx = sy & 1, sx & 1
        iy, ix = sy >> 1, sx >> 1
        H, W = plane.shape
        iy = min(max(iy, 0), max(H - h - fy, 0))
        ix = min(max(ix, 0), max(W - w - fx, 0))
        a = plane[iy:iy + h + fy, ix:ix + w + fx].astype(np.int32)
        if fy and fx:
            return (a[:-1, :-1] + a[:-1, 1:] + a[1:, :-1] + a[1:, 1:]
                    + 2) >> 2
        if fy:
            return (a[:-1, :] + a[1:, :] + 1) >> 1
        if fx:
            return (a[:, :-1] + a[:, 1:] + 1) >> 1
        return a

    def _frame_pred(self, frame: _FrameBuf, mby: int, mbx: int,
                    mvx: int, mvy: int) -> dict:
        """Frame-based 16x16 prediction from a reference frame."""
        y = self._fetch(frame.y, mby * 32 + mvy, mbx * 32 + mvx, 16, 16)
        cx = _div2_trunc(mvx)
        cy = _div2_trunc(mvy) if self.cf == 1 else mvy  # 4:2:2: full v
        cr = self.c_rows
        u = self._fetch(frame.u, mby * 2 * cr + cy, mbx * 16 + cx, cr, 8)
        v = self._fetch(frame.v, mby * 2 * cr + cy, mbx * 16 + cx, cr, 8)
        return {"y": y, "u": u, "v": v}

    def _field_pred_views(self, views, fy_mb: int, mbx: int, mvx: int,
                          mvy: int, h: int, y_off: int = 0) -> dict:
        """Field prediction of h luma lines from (y,u,v) field views.
        fy_mb: destination field row of the MB top in field coords."""
        yv, uv, vv = views
        y = self._fetch(yv, (fy_mb + y_off) * 2 + mvy, mbx * 32 + mvx,
                        h, 16)
        cx = _div2_trunc(mvx)
        if self.cf == 1:
            cy, ch_rows = _div2_trunc(mvy), h // 2
            cpos = (fy_mb + y_off) + cy
        else:  # 4:2:2: chroma fields have luma's vertical resolution
            cy, ch_rows = mvy, h
            cpos = (fy_mb + y_off) * 2 + cy
        u = self._fetch(uv, cpos, mbx * 16 + cx, ch_rows, 8)
        v = self._fetch(vv, cpos, mbx * 16 + cx, ch_rows, 8)
        return {"y": y, "u": u, "v": v}

    # ---- slice ---------------------------------------------------------------

    def decode_slice(self, r: BitReader, vertical_pos: int) -> None:
        dec = self.dec
        p = dec.pic
        mb_row = vertical_pos - 1
        if dec.seq.height > 2800:
            mb_row = (r.read(3) << 7) + vertical_pos - 1
        if mb_row >= self.mbh:
            raise Mpeg2Error("slice row out of range")
        self.qs = self.qscale(r.read(5))
        if r.peek(1) == 1:
            r.skip(1 + 1 + 7)
            while r.peek(1) == 1:
                r.skip(9)
        r.skip(1)  # extra_bit_slice

        self.reset_pmv()
        self.reset_dc()
        self.prev_flags = 0
        mpeg1 = dec.seq.mpeg1
        # MPEG-1 slices may cross macroblock rows; MPEG-2 slices are
        # confined to the row named by the start code.
        addr = mb_row * self.mbw - 1
        bound = self.mbw * self.mbh if mpeg1 else (mb_row + 1) * self.mbw
        first_in_slice = True

        while True:
            if r.bits_left() <= 0 or r.peek(min(23, r.bits_left())) == 0:
                break
            while mpeg1 and r.bits_left() >= 11 and \
                    r.peek(11) == 0b00000001111:
                r.skip(11)  # macroblock_stuffing (11172-2 only)
            inc = 0
            while r.bits_left() >= _ADDR_ESC_LEN and \
                    r.peek(_ADDR_ESC_LEN) == _ADDR_ESC_CODE:
                r.skip(_ADDR_ESC_LEN)
                inc += 33
            inc += _VLC_ADDR.decode(r)
            if first_in_slice:
                addr += inc
                first_in_slice = False
            else:
                for _ in range(inc - 1):
                    addr += 1
                    if addr >= bound:
                        raise Mpeg2Error("skip run past slice end")
                    self._skipped_mb(addr // self.mbw, addr % self.mbw)
                addr += 1
            if addr >= bound:
                raise Mpeg2Error("mb address past slice end")
            self._macroblock(r, addr // self.mbw, addr % self.mbw)

    # ---- macroblock ------------------------------------------------------------

    def _skipped_mb(self, mb_row: int, mb_x: int) -> None:
        """7.6.6: P => zero-vector copy + PMV reset; B => previous MB's
        prediction with current PMVs. DC predictors reset."""
        dec = self.dec
        p = dec.pic
        self.reset_dc()
        if p.coding_type == 1:
            raise Mpeg2Error("skipped MB in I picture")
        preds = []
        if p.coding_type == 2:
            self.reset_pmv()
            flags = T.MB_MOTION_F
            mvs = {(0, 0): (0, 0)}
        else:
            flags = self.prev_flags & (T.MB_MOTION_F | T.MB_MOTION_B)
            if flags == 0:
                flags = T.MB_MOTION_F
            fpel = dec.seq.mpeg1
            mvs = {(0, s): (int(self.pmv[0][s][0])
                            * (2 if fpel and p.full_pel[s] else 1),
                            int(self.pmv[0][s][1])
                            * (2 if fpel and p.full_pel[s] else 1))
                   for s in (0, 1)}
        for s in (0, 1):
            if not (flags & (T.MB_MOTION_F if s == 0 else T.MB_MOTION_B)):
                continue
            mvx, mvy = mvs[(0, s)]
            if self.frame_pic:
                frame = dec._ref_frame(s)
                if frame is None:
                    continue
                preds.append(self._frame_pred(frame, mb_row, mb_x,
                                              mvx, mvy))
            else:
                views = dec._ref_field(s, self.cur_parity, self.cur_parity)
                preds.append(self._field_pred_views(
                    views, mb_row * 16, mb_x, mvx, mvy, 16))
        if not preds:
            return
        self._store_mb(mb_row, mb_x, self._pred_mb(preds))
        self.prev_flags = flags

    def _macroblock(self, r: BitReader, mb_row: int, mb_x: int) -> None:
        dec = self.dec
        p = dec.pic
        seq = dec.seq
        flags = _VLC_MBT[p.coding_type].decode(r)
        intra = bool(flags & T.MB_INTRA)
        motion_f = bool(flags & T.MB_MOTION_F)
        motion_b = bool(flags & T.MB_MOTION_B)
        pattern = bool(flags & T.MB_PATTERN)

        # motion type (tables 6-17/6-18)
        motion_type = 2
        if motion_f or motion_b:
            if self.frame_pic:
                motion_type = r.read(2) if not p.frame_pred_frame_dct else 2
            else:
                motion_type = r.read(2)
        elif intra and p.concealment:
            motion_type = 2 if self.frame_pic else 1

        dct_type = 0
        if self.frame_pic and not p.frame_pred_frame_dct and \
                (intra or pattern):
            dct_type = r.read(1)
        if flags & T.MB_QUANT:
            self.qs = self.qscale(r.read(5))

        preds = []
        if intra:
            if p.concealment:
                # concealment vector: updates PMV[0][0] and PMV[1][0]
                if not self.frame_pic:
                    r.skip(1)  # vertical field select (same parity)
                self._mv(r, 0, 0, False, False)
                self.pmv[1][0] = self.pmv[0][0]
                r.skip(1)  # marker
            else:
                self.reset_pmv()
        else:
            self.reset_dc()
            for s, has in ((0, motion_f), (1, motion_b)):
                if not has:
                    continue
                preds.append(self._motion(r, s, motion_type))
            if p.coding_type == 2 and not motion_f and not intra:
                # pattern-only P macroblock: zero frame/field vector
                self.reset_pmv()
                if self.frame_pic:
                    frame = dec._ref_frame(0)
                    preds.append(self._frame_pred(frame, mb_row, mb_x,
                                                  0, 0))
                else:
                    views = dec._ref_field(0, self.cur_parity,
                                           self.cur_parity)
                    preds.append(self._field_pred_views(
                        views, mb_row * 16, mb_x, 0, 0, 16))

        cbp = 0
        if pattern:
            cbp = _VLC_CBP.decode(r)
            if seq.chroma_format == 2:
                cbp = (cbp << 2) | r.read(2)
            elif seq.chroma_format == 3:
                cbp = (cbp << 6) | r.read(6)
        elif intra:
            cbp = (1 << self.block_count) - 1

        # The _motion() calls above closed over (mb_row, mb_x) via these:
        # predictions were built during _motion with stored dest; rebuild
        # here instead for clarity. (See _motion: it returns a closure.)
        preds = [pr(mb_row, mb_x) if callable(pr) else pr for pr in preds]

        mb = self._pred_mb(preds) if preds else None
        if intra or mb is None:
            mb = self._zero_mb()

        # blocks
        nblocks = self.block_count
        for b in range(nblocks):
            if not ((cbp >> (nblocks - 1 - b)) & 1):
                continue
            cc = 0 if b < 4 else 1 + (b & 1)
            coeffs = self._block(r, intra, cc)
            res = idct8x8(coeffs.reshape(8, 8)).astype(np.int32)
            if b < 4:
                if dct_type:  # field DCT interleave
                    rows = slice(b // 2, 16, 2)
                else:
                    rows = slice((b // 2) * 8, (b // 2) * 8 + 8)
                cols = slice((b & 1) * 8, (b & 1) * 8 + 8)
                tgt = mb["y"][rows, cols]
                mb["y"][rows, cols] = tgt + res if not intra else res
            else:
                key = "u" if (b & 1) == 0 else "v"
                k2 = (b - 4) // 2   # 4:2:2: second chroma block pair
                if dct_type and self.cf == 2:
                    rows = slice(k2, 16, 2)   # field-organised chroma
                else:
                    rows = slice(k2 * 8, k2 * 8 + 8)
                tgt = mb[key][rows]
                mb[key][rows] = tgt + res if not intra else res

        if not intra and not pattern:
            self.reset_dc()
        if intra:
            self.prev_flags = 0
            if p.coding_type == 3:
                self.prev_flags = 0
        else:
            self.prev_flags = flags
        self._store_mb(mb_row, mb_x, mb)

    # ---- motion decode dispatcher ------------------------------------------------

    def _motion(self, r: BitReader, s: int, motion_type: int):
        """Decode the motion vectors for direction s and return a closure
        (mb_row, mb_x) -> prediction dict. Decoding happens NOW (bit
        order), sampling happens later at the destination."""
        dec = self.dec
        p = dec.pic
        if self.frame_pic:
            if motion_type == 2:  # frame-based
                mvx, mvy, _ = self._mv(r, 0, s, False, False)
                self.pmv[1][s] = self.pmv[0][s]
                if dec.seq.mpeg1 and p.full_pel[s]:
                    mvx, mvy = mvx * 2, mvy * 2  # PMV keeps coded scale

                def pred(mb_row, mb_x, mvx=mvx, mvy=mvy):
                    frame = dec._ref_frame(s)
                    return self._frame_pred(frame, mb_row, mb_x, mvx, mvy)
                return pred
            if motion_type == 1:  # field-based in frame picture
                parts = []
                for rr in (0, 1):
                    fs = r.read(1)
                    mvx, mvy, _ = self._mv(r, rr, s, True, False)
                    parts.append((fs, mvx, mvy))

                def pred(mb_row, mb_x, parts=parts):
                    out = None
                    frame = dec._ref_frame(s)
                    for dest_par, (fs, mvx, mvy) in enumerate(parts):
                        views = (frame.field("y", fs),
                                 frame.field("u", fs),
                                 frame.field("v", fs))
                        blk = self._field_pred_views(
                            views, mb_row * 8, mb_x, mvx, mvy, 8)
                        if out is None:
                            out = self._zero_mb()
                        out["y"][dest_par::2] = blk["y"]
                        out["u"][dest_par::2] = blk["u"]
                        out["v"][dest_par::2] = blk["v"]
                    return out
                return pred
            if motion_type == 3:  # dual prime (frame picture)
                mvx, mvy, (dmx, dmy) = self._mv(r, 0, s, True, True)
                self.pmv[1][s] = self.pmv[0][s]

                def pred(mb_row, mb_x, mvx=mvx, mvy=mvy, dmx=dmx, dmy=dmy):
                    frame = dec._ref_frame(s)
                    out = self._zero_mb()
                    tff = p.top_field_first
                    for dest_par in (0, 1):
                        same = (frame.field("y", dest_par),
                                frame.field("u", dest_par),
                                frame.field("v", dest_par))
                        p1 = self._field_pred_views(
                            same, mb_row * 8, mb_x, mvx, mvy, 8)
                        # derived opposite-parity vector (7.6.3.6)
                        if dest_par == 0:
                            m = 1 if tff else 3
                            corr = -1
                        else:
                            m = 3 if tff else 1
                            corr = 1
                        ox = _dp_half(mvx * m) + dmx
                        oy = _dp_half(mvy * m) + dmy + corr
                        opp = (frame.field("y", 1 - dest_par),
                               frame.field("u", 1 - dest_par),
                               frame.field("v", 1 - dest_par))
                        p2 = self._field_pred_views(
                            opp, mb_row * 8, mb_x, ox, oy, 8)
                        for k in ("y", "u", "v"):
                            out[k][dest_par::2] = (p1[k] + p2[k] + 1) >> 1
                    return out
                return pred
            raise Mpeg2Error("bad frame_motion_type")

        # ---- field pictures ----
        cur_par = self.cur_parity
        if motion_type == 1:  # field-based
            fs = r.read(1)
            mvx, mvy, _ = self._mv(r, 0, s, False, False)
            self.pmv[1][s] = self.pmv[0][s]

            def pred(mb_row, mb_x, fs=fs, mvx=mvx, mvy=mvy):
                views = dec._ref_field(s, fs, cur_par)
                return self._field_pred_views(views, mb_row * 16, mb_x,
                                              mvx, mvy, 16)
            return pred
        if motion_type == 2:  # 16x8
            parts = []
            for rr in (0, 1):
                fs = r.read(1)
                mvx, mvy, _ = self._mv(r, rr, s, False, False)
                parts.append((fs, mvx, mvy))

            def pred(mb_row, mb_x, parts=parts):
                out = self._zero_mb()
                hc = self.c_rows // 2
                for half, (fs, mvx, mvy) in enumerate(parts):
                    views = dec._ref_field(s, fs, cur_par)
                    blk = self._field_pred_views(
                        views, mb_row * 16, mb_x, mvx, mvy, 8,
                        y_off=half * 8)
                    out["y"][half * 8:half * 8 + 8] = blk["y"]
                    out["u"][half * hc:half * hc + hc] = blk["u"]
                    out["v"][half * hc:half * hc + hc] = blk["v"]
                return out
            return pred
        if motion_type == 3:  # dual prime (field picture)
            mvx, mvy, (dmx, dmy) = self._mv(r, 0, s, False, True)
            self.pmv[1][s] = self.pmv[0][s]

            def pred(mb_row, mb_x, mvx=mvx, mvy=mvy, dmx=dmx, dmy=dmy):
                same = dec._ref_field(s, cur_par, cur_par)
                p1 = self._field_pred_views(same, mb_row * 16, mb_x,
                                            mvx, mvy, 16)
                ox = _dp_half(mvx) + dmx
                oy = _dp_half(mvy) + dmy + (1 if cur_par == 1 else -1)
                opp = dec._ref_field(s, 1 - cur_par, cur_par)
                p2 = self._field_pred_views(opp, mb_row * 16, mb_x,
                                            ox, oy, 16)
                return {k: (p1[k] + p2[k] + 1) >> 1 for k in ("y", "u",
                                                              "v")}
            return pred
        raise Mpeg2Error("bad field_motion_type")

    # ---- store -----------------------------------------------------------------

    def _store_mb(self, mb_row: int, mb_x: int, mb: dict) -> None:
        dec = self.dec
        y = np.clip(mb["y"], 0, 255).astype(np.uint8)
        u = np.clip(mb["u"], 0, 255).astype(np.uint8)
        v = np.clip(mb["v"], 0, 255).astype(np.uint8)
        if self.frame_pic:
            ty = dec._cur.y
            tu = dec._cur.u
            tv = dec._cur.v
        else:
            ty = dec._cur.field("y", self.cur_parity)
            tu = dec._cur.field("u", self.cur_parity)
            tv = dec._cur.field("v", self.cur_parity)
        cr = self.c_rows
        ty[mb_row * 16:mb_row * 16 + 16, mb_x * 16:mb_x * 16 + 16] = y
        tu[mb_row * cr:mb_row * cr + cr, mb_x * 8:mb_x * 8 + 8] = u
        tv[mb_row * cr:mb_row * cr + cr, mb_x * 8:mb_x * 8 + 8] = v


# ---------------------------------------------------------------------------
# Convenience
# ---------------------------------------------------------------------------


def decode_es(es: bytes) -> list[DecodedFrame]:
    """Decode a whole elementary stream, display order."""
    from ..ts.qp_extract import iter_picture_chunks

    dec = Mpeg2RefDecoder()
    out = []
    for chunk in iter_picture_chunks(es):
        out.extend(dec.decode_picture(chunk))
    out.extend(dec.flush())
    return out
