"""A broadcast transport stream from numpy alone: test data for the TS front
end (split, decode, audio), as synth_clip.py is for the filter stages.

`write_ts` lays down a single-program TS: PAT, PMT and PCR as the repo's
test stream generator lays them down (tests/ts_gen.py:build_simple_ts), one
MPEG-2 video stream of intra pictures (interlaced, top field first, the
sequence padded to a multiple of 16 rows by edge replication) and one ADTS
AAC-LC stereo 48 kHz stream. With video="h264" or "h265" the video stream
is H.264 (stream type 0x1B) or HEVC (0x24) instead: lossless PCM pictures
of the given frames (every macroblock I_PCM, every coding unit 16x16 IPCM)
that carry the same format (interlaced, top field first, 30000/1001, the
MPEG-2 stream's sample aspect ratio), each access unit opened by an access
unit delimiter; the audio, the timestamps and the PIDs stay as they are.
`ts_clip` fills it with a short seeded synth_clip broadcast layout
(program with the logo, 3:2 film; CM of interlaced video without it;
program again) whose audio is silent around the two cuts, so that the CM
pass has silence to find.

The writer keeps what a correct decoder must return: every picture's
reconstruction, made with the inverse DCT of video/mpeg2_ref.idct8x8 (its
two integer stages, evaluated as float64 matrix products, which are exact
at these magnitudes), and every macroblock's quantiser scale. The DCT, the
quantisation and the reconstruction of a picture run on all of its blocks
at once, and so does the VLC: the code and length of every token land in
arrays, and one pass packs them into bytes. A PCM picture's samples and
its emulation prevention bytes are laid down by numpy in the same way.
"""

from __future__ import annotations

import functools
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
from ..video import h265_tables as HT
from ..video.h265_ref import CTX_OFFSETS, init_hevc_contexts
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
STREAM_TYPES = {"mpeg2": 0x02, "h264": 0x1B, "h265": 0x24}

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
# H.264 and HEVC PCM pictures
# ---------------------------------------------------------------------------


def _ue(w: BitWriter, v: int) -> None:
    n = v + 1
    nb = n.bit_length()
    w.write(0, nb - 1)
    w.write(n, nb)


def _se(w: BitWriter, v: int) -> None:
    _ue(w, 2 * v - 1 if v > 0 else -2 * v)


def _trailing(w: BitWriter) -> bytes:
    """rbsp_trailing_bits: a one, then zeros to the byte."""
    w.write(1, 1)
    w.byte_align()
    return w.getvalue()


def emulation_prevention(rbsp: np.ndarray) -> np.ndarray:
    """0x03 inserted where two zero bytes meet a byte <= 3 (7.4.1 of both
    standards), over a uint8 array that starts after a nonzero byte: the
    scalar rule (count zeros, insert and reset at two) vectorised over the
    runs of zeros. Inside a run of k zeros an insertion falls before its
    zeros 2, 4, ...; after the run, before the next byte if k is even and
    that byte is at most 3."""
    a = np.asarray(rbsp, np.uint8)
    z = np.concatenate([[False], a == 0, [False]]).astype(np.int8)
    edge = np.diff(z)
    starts = np.flatnonzero(edge == 1)
    ends = np.flatnonzero(edge == -1)
    k = ends - starts
    inner = np.maximum(k - 1, 0) // 2
    run = np.repeat(np.arange(len(k)), inner)
    rank = np.arange(len(run)) - np.repeat(np.cumsum(inner) - inner, inner)
    at_inner = starts[run] + 2 * (rank + 1)
    after = (k % 2 == 0) & (ends < len(a))
    after[after] &= a[ends[after]] <= 3
    at = np.sort(np.concatenate([at_inner, ends[after]]))
    return np.insert(a, at, 3)


def _nal(header: bytes, rbsp) -> bytes:
    """Start code, NAL header, then the RBSP (bytes or a uint8 array) with
    its emulation prevention bytes."""
    if isinstance(rbsp, bytes):
        rbsp = np.frombuffer(rbsp, np.uint8)
    return b"\x00\x00\x00\x01" + header + \
        emulation_prevention(rbsp).tobytes()


def _pcm_blocks(planes, mbw: int, mbh: int) -> np.ndarray:
    """[mbh * mbw, 384] uint8: each 16x16 block's luma row-major, then its
    8x8 Cb and Cr, in raster order, the planes padded to mbh x mbw blocks
    by edge replication."""
    y, u, v = (np.asarray(p, np.uint8) for p in planes)
    out = np.empty((mbh, mbw, 384), np.uint8)
    for p, n, at in ((y, 16, 0), (u, 8, 256), (v, 8, 320)):
        p = np.pad(p, ((0, mbh * n - p.shape[0]), (0, mbw * n - p.shape[1])),
                   mode="edge")
        out[..., at:at + n * n] = (p.reshape(mbh, n, mbw, n)
                                   .transpose(0, 2, 1, 3)
                                   .reshape(mbh, mbw, n * n))
    return out.reshape(-1, 384)


def _sar(width: int, height: int) -> tuple[int, int]:
    """The MPEG-2 stream's sample aspect ratio: 16:9 over the frame."""
    sw, sh = 16 * height, 9 * width
    g = math.gcd(sw, sh)
    return sw // g, sh // g


# H.264: Main profile, CAVLC, poc type 2 (output order = decoding order),
# one reference frame, frame pictures of an interlaced sequence
# (frame_mbs_only_flag 0, no MBAFF).
H264_AUD_I = b"\x00\x00\x00\x01\x09\x10"  # primary_pic_type 0 (I)
# pic_timing SEI: pic_struct 3 (top field, bottom field), two
# clock_timestamp_flag 0
H264_SEI_TFF = b"\x00\x00\x00\x01\x06\x01\x01\x32\x80"
H264_END = b"\x00\x00\x00\x01\x0B"  # end of stream


def h264_parameter_sets(width: int, height: int) -> bytes:
    """SPS and PPS: the coded height a multiple of 32 (frame_mbs_only_flag
    0), cropped to `height`; VUI with the sample aspect ratio, 30000/1001
    timing and pic_struct_present_flag."""
    mbw, map_units = (width + 15) // 16, (height + 31) // 32
    w = BitWriter()
    w.write(77, 8)  # Main
    w.write(0, 8)
    w.write(40, 8)  # level 4.0
    _ue(w, 0)  # sps_id
    _ue(w, 0)  # log2_max_frame_num_minus4
    _ue(w, 2)  # pic_order_cnt_type
    _ue(w, 1)  # max_num_ref_frames
    w.write(0, 1)  # gaps_in_frame_num_value_allowed_flag
    _ue(w, mbw - 1)
    _ue(w, map_units - 1)
    w.write(0, 1)  # frame_mbs_only_flag
    w.write(0, 1)  # mb_adaptive_frame_field_flag
    w.write(1, 1)  # direct_8x8_inference_flag
    crop_r, crop_b = (mbw * 16 - width) // 2, (map_units * 32 - height) // 4
    w.write(1 if crop_r or crop_b else 0, 1)
    if crop_r or crop_b:
        for c in (0, crop_r, 0, crop_b):  # 4:2:0 units; rows in pairs
            _ue(w, c)
    w.write(1, 1)  # vui_parameters_present_flag
    w.write(1, 1)  # aspect_ratio_info_present_flag
    w.write(255, 8)  # Extended_SAR
    sar = _sar(width, height)
    w.write(sar[0], 16)
    w.write(sar[1], 16)
    w.write(0, 3)  # overscan, video signal type, chroma location
    w.write(1, 1)  # timing_info_present_flag
    w.write(1001, 32)  # num_units_in_tick
    w.write(60000, 32)  # time_scale (two ticks a frame)
    w.write(1, 1)  # fixed_frame_rate_flag
    w.write(0, 2)  # no NAL or VCL HRD
    w.write(1, 1)  # pic_struct_present_flag
    w.write(0, 1)  # bitstream_restriction_flag
    sps = _trailing(w)
    w = BitWriter()
    _ue(w, 0)  # pps_id
    _ue(w, 0)  # sps_id
    w.write(0, 2)  # CAVLC, no bottom_field_pic_order_in_frame_present
    _ue(w, 0)  # num_slice_groups_minus1
    _ue(w, 0)
    _ue(w, 0)  # num_ref_idx_l0/l1_default_active_minus1
    w.write(0, 3)  # weighted_pred_flag, weighted_bipred_idc
    _se(w, 0)
    _se(w, 0)
    _se(w, 0)  # pic_init_qp, pic_init_qs, chroma_qp_index_offset
    w.write(0, 3)  # deblocking control, constrained intra, redundant
    pps = _trailing(w)
    return _nal(b"\x67", sps) + _nal(b"\x68", pps)


def h264_pcm_slices(planes, frame_num: int, idr: bool,
                    idr_pic_id: int = 0) -> bytes:
    """I slice NALs of I_PCM macroblocks, one per macroblock row (as the
    MPEG-2 pictures have one slice per row). An I_PCM macroblock is
    mb_type ue(25) (0000 1101 0), its alignment zeros, then 384 samples:
    after a slice's first it is always the bytes 0x0D 0x00 before its
    samples. qP is 0 in an I_PCM macroblock, so the deblocking filter
    (left on) changes no sample."""
    h, width = np.asarray(planes[0]).shape
    mbw = (width + 15) // 16
    # frame_mbs_only_flag 0: whole 32-row macroblock pairs
    blocks = _pcm_blocks(planes, mbw, 2 * ((h + 31) // 32))
    body = np.empty((len(blocks), 386), np.uint8)
    body[:, 0], body[:, 1], body[:, 2:] = 0x0D, 0, blocks
    body = body.reshape(-1, mbw * 386)
    out = []
    for row, data in enumerate(body):
        w = BitWriter()
        _ue(w, row * mbw)  # first_mb_in_slice
        _ue(w, 7)  # slice_type I (all slices)
        _ue(w, 0)  # pps_id
        w.write(frame_num, 4)
        w.write(0, 1)  # field_pic_flag
        if idr:
            _ue(w, idr_pic_id)
            w.write(0, 2)  # no_output_of_prior_pics, long_term_reference
        else:
            w.write(0, 1)  # adaptive_ref_pic_marking_mode_flag
        _se(w, 0)  # slice_qp_delta
        _ue(w, 25)  # the first macroblock's mb_type: I_PCM
        w.byte_align()
        rbsp = np.concatenate([np.frombuffer(w.getvalue(), np.uint8),
                               data[2:], [0x80]]).astype(np.uint8)
        out.append(_nal(b"\x65" if idr else b"\x41", rbsp))
    return b"".join(out)


def h264_access_unit(planes, index: int) -> bytes:
    """AUD, at a GOP start the parameter sets, pic_timing SEI, then an
    IDR (at a GOP start) or a non-IDR reference picture."""
    f = index % GOP
    ps = h264_parameter_sets(planes[0].shape[1], planes[0].shape[0]) \
        if f == 0 else b""
    return (H264_AUD_I + ps + H264_SEI_TFF
            + h264_pcm_slices(planes, f, f == 0, (index // GOP) % 2))


# HEVC: Main profile, CTB = minimum CB = 16, every CU IPCM with the loop
# filter off on its samples (pcm_loop_filter_disabled_flag 1); an IDR at
# each GOP start, TRAIL_R I pictures with an empty reference set between.
H265_AUD_I = b"\x00\x00\x00\x01\x46\x01\x10"  # pic_type 0 (I)
H265_END = b"\x00\x00\x00\x01\x4A\x01"  # end of bitstream
H265_LOG2_MAX_POC = 4
_PCM_QP = 26


def _h265_ptl(w: BitWriter) -> None:
    """profile_tier_level: Main, level 4.0, interlaced source."""
    w.write(0, 3)  # profile_space, tier
    w.write(1, 5)  # Main
    w.write(1 << 30, 32)  # compatible with Main
    w.write(0, 1)  # general_progressive_source_flag
    w.write(1, 1)  # general_interlaced_source_flag
    w.write(0, 2)  # non_packed_constraint, frame_only_constraint
    w.write(0, 32)
    w.write(0, 12)  # reserved
    w.write(120, 8)  # level 4.0


def h265_parameter_sets(width: int, height: int) -> bytes:
    """VPS, SPS and PPS: the picture padded to whole 16x16 CTBs and
    cropped back by the conformance window; VUI with the sample aspect
    ratio and 30000/1001 timing."""
    wc, hc = (width + 15) // 16, (height + 15) // 16
    w = BitWriter()
    w.write(0, 4)  # vps_id
    w.write(3, 2)  # base layer internal, available
    w.write(0, 6)  # max_layers_minus1
    w.write(0, 3)  # max_sub_layers_minus1
    w.write(1, 1)  # temporal_id_nesting
    w.write(0xFFFF, 16)
    _h265_ptl(w)
    w.write(1, 1)  # sub_layer_ordering_info_present
    _ue(w, 1)  # max_dec_pic_buffering_minus1
    _ue(w, 0)  # num_reorder_pics
    _ue(w, 0)  # max_latency_increase_plus1
    w.write(0, 6)  # max_layer_id
    _ue(w, 0)  # num_layer_sets_minus1
    w.write(0, 2)  # no timing info, no extension
    vps = _trailing(w)
    w = BitWriter()
    w.write(0, 4)  # vps_id
    w.write(0, 3)  # max_sub_layers_minus1
    w.write(1, 1)  # temporal_id_nesting
    _h265_ptl(w)
    _ue(w, 0)  # sps_id
    _ue(w, 1)  # 4:2:0
    _ue(w, wc * 16)
    _ue(w, hc * 16)
    crop_r, crop_b = (wc * 16 - width) // 2, (hc * 16 - height) // 2
    w.write(1 if crop_r or crop_b else 0, 1)
    if crop_r or crop_b:
        for c in (0, crop_r, 0, crop_b):  # in chroma samples
            _ue(w, c)
    _ue(w, 0)
    _ue(w, 0)  # 8-bit luma and chroma
    _ue(w, H265_LOG2_MAX_POC - 4)
    w.write(1, 1)  # sub_layer_ordering_info_present
    _ue(w, 1)
    _ue(w, 0)
    _ue(w, 0)
    _ue(w, 1)  # log2_min_cb 4
    _ue(w, 0)  # CTB 16
    _ue(w, 0)  # log2_min_tb 2
    _ue(w, 2)  # max TB 16
    _ue(w, 0)
    _ue(w, 0)  # max transform hierarchy depths
    w.write(0, 3)  # scaling lists, AMP, SAO
    w.write(1, 1)  # pcm_enabled
    w.write(7, 4)
    w.write(7, 4)  # 8-bit PCM samples
    _ue(w, 1)  # log2_min_pcm 4
    _ue(w, 0)  # max PCM 16
    w.write(1, 1)  # pcm_loop_filter_disabled_flag
    _ue(w, 0)  # num_short_term_ref_pic_sets
    w.write(0, 3)  # long-term refs, temporal MVP, strong intra smoothing
    w.write(1, 1)  # vui_parameters_present
    w.write(1, 1)  # aspect_ratio_info_present
    w.write(255, 8)  # EXTENDED_SAR
    sar = _sar(width, height)
    w.write(sar[0], 16)
    w.write(sar[1], 16)
    # overscan, video signal type, chroma location, neutral chroma,
    # field_seq, frame_field_info, default display window
    w.write(0, 7)
    w.write(1, 1)  # vui_timing_info_present
    w.write(1001, 32)
    w.write(30000, 32)
    w.write(0, 2)  # poc_proportional_to_timing, hrd_parameters_present
    w.write(0, 1)  # bitstream_restriction
    w.write(0, 1)  # sps_extension_present
    sps = _trailing(w)
    w = BitWriter()
    _ue(w, 0)  # pps_id
    _ue(w, 0)  # sps_id
    w.write(0, 7)  # dependent slices, output flag, extra bits, SDH, init
    _ue(w, 0)
    _ue(w, 0)  # num_ref_idx defaults
    _se(w, 0)  # init_qp_minus26
    w.write(0, 3)  # constrained intra, transform skip, cu_qp_delta
    _se(w, 0)
    _se(w, 0)  # cb, cr qp offsets
    w.write(0, 6)  # chroma offsets, weighted, bypass, tiles, wavefronts
    w.write(1, 1)  # pps_loop_filter_across_slices
    w.write(0, 3)  # deblocking control, scaling list, lists modification
    _ue(w, 0)  # log2_parallel_merge_level_minus2
    w.write(0, 2)  # slice header extension, pps extension
    pps = _trailing(w)
    return (_nal(b"\x40\x01", vps) + _nal(b"\x42\x01", sps)
            + _nal(b"\x44\x01", pps))


class _Cabac:
    """The CABAC arithmetic encoder (9.3.4.2 of ITU-T H.265, the H.264
    engine) over a list of bits: one context (part_mode's), terminate and
    the flush, which writes the stop bit."""

    def __init__(self, state: list):
        self.bits: list[int] = []
        self.state = state  # [pStateIdx, valMps]
        self.restart()

    def restart(self) -> None:
        self.low, self.range_, self.outstanding, self.first = 0, 510, 0, True

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self.bits.append(b)
        self.bits += [1 - b] * self.outstanding
        self.outstanding = 0

    def _renorm(self) -> None:
        while self.range_ < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range_ <<= 1
            self.low <<= 1

    def decision(self, bit: int) -> None:
        st = self.state
        lps = HT.RANGE_LPS[4 * st[0] + ((self.range_ >> 6) & 3)]
        self.range_ -= lps
        if bit != st[1]:
            self.low += self.range_
            self.range_ = lps
            if st[0] == 0:
                st[1] = 1 - st[1]
            st[0] = HT.TRANS_IDX_LPS[st[0]]
        else:
            st[0] = HT.TRANS_IDX_MPS[st[0]]
        self._renorm()

    def terminate(self, bit: int) -> None:
        self.range_ -= 2
        if not bit:
            self._renorm()
            return
        self.low += self.range_
        self.range_ = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bits += [(self.low >> 8) & 1, 1]

    def take_bytes(self) -> bytes:
        """The bits so far, zero-padded to a byte (pcm_alignment_zero_bit
        or the slice's alignment after the flush's stop bit)."""
        bits = self.bits + [0] * (-len(self.bits) % 8)
        self.bits = []
        return np.packbits(np.asarray(bits, np.uint8)).tobytes()


@functools.lru_cache(maxsize=None)
def _h265_layout(n: int):
    """Where the CABAC bytes and the PCM samples of an n-CU slice go. The
    bytes between two PCM blocks are end_of_slice_segment_flag 0, the next
    CU's part_mode (2Nx2N: one bin in the one context, which adapts from
    CU to CU) and its pcm_flag (a terminate bin, then the flush): they
    depend on the CU's place in the slice only, so every picture of a
    size shares them. Returns (total bytes, CABAC byte positions and
    values, PCM sample positions [n, 384])."""
    state = init_hevc_contexts(0, _PCM_QP)[CTX_OFFSETS["part_mode"]]
    enc = _Cabac(list(state))
    segs = []
    for i in range(n):
        if i:
            enc.restart()  # after the PCM samples (9.3.2.5)
            enc.terminate(0)  # end_of_slice_segment_flag
        enc.decision(1)  # part_mode 2Nx2N
        enc.terminate(1)  # pcm_flag
        segs.append(enc.take_bytes())
    enc.restart()
    enc.terminate(1)  # the last end_of_slice_segment_flag
    tail = enc.take_bytes()
    lens = np.array([len(b) for b in segs], np.int64)
    offs = np.cumsum(lens + 384) - (lens + 384)
    seg_pos = (np.repeat(offs, lens) + np.arange(int(lens.sum()))
               - np.repeat(np.cumsum(lens) - lens, lens))
    total = int(offs[-1] + lens[-1] + 384)
    seg_pos = np.concatenate([seg_pos, total + np.arange(len(tail))])
    seg_val = np.frombuffer(b"".join(segs) + tail, np.uint8)
    pcm_pos = (offs + lens)[:, None] + np.arange(384)
    return total + len(tail), seg_pos, seg_val, pcm_pos


def h265_pcm_slice(planes, poc: int, idr: bool) -> bytes:
    """One I slice NAL of 16x16 IPCM CUs covering the picture: an
    IDR_W_RADL, or a TRAIL_R with an empty short-term reference set."""
    y = np.asarray(planes[0])
    wc, hc = (y.shape[1] + 15) // 16, (y.shape[0] + 15) // 16
    blocks = _pcm_blocks(planes, wc, hc)
    w = BitWriter()
    w.write(1, 1)  # first_slice_segment_in_pic_flag
    if idr:
        w.write(0, 1)  # no_output_of_prior_pics_flag
    _ue(w, 0)  # pps_id
    _ue(w, 2)  # slice_type I
    if not idr:
        w.write(poc % (1 << H265_LOG2_MAX_POC), H265_LOG2_MAX_POC)
        w.write(0, 1)  # short_term_ref_pic_set_sps_flag
        _ue(w, 0)
        _ue(w, 0)  # no negative, no positive pictures
    _se(w, 0)  # slice_qp_delta
    w.write(1, 1)  # slice_loop_filter_across_slices_enabled_flag
    head = np.frombuffer(_trailing(w), np.uint8)  # byte_alignment()
    total, seg_pos, seg_val, pcm_pos = _h265_layout(wc * hc)
    data = np.empty(total, np.uint8)
    data[seg_pos] = seg_val
    data[pcm_pos] = blocks
    return _nal(b"\x26\x01" if idr else b"\x02\x01",
                np.concatenate([head, data]))


def h265_access_unit(planes, index: int) -> bytes:
    """AUD, at a GOP start the parameter sets and an IDR, else a TRAIL_R
    picture."""
    f = index % GOP
    ps = h265_parameter_sets(planes[0].shape[1], planes[0].shape[0]) \
        if f == 0 else b""
    return H265_AUD_I + ps + h265_pcm_slice(planes, f, f == 0)


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


def _pmt(video_type: int = 0x02) -> bytes:
    payload = (0xE000 | VIDEO_PID).to_bytes(2, "big") + b"\xF0\x00"
    for stype, pid in ((video_type, VIDEO_PID), (0x0F, AUDIO_PID)):
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


def _pcm_pictures(frames, num_frames: int, video: str):
    """(coded bytes, the frame itself, no quantiser scales) of each frame:
    PCM pictures are lossless."""
    code = h264_access_unit if video == "h264" else h265_access_unit
    it = iter(frames)
    for f in range(num_frames):
        planes = tuple(np.asarray(p) for p in next(it))
        yield code(planes, f), planes, None


def write_ts(path: str, frames, num_frames: int, silent_audio,
             seed: int, video: str = "mpeg2") -> SynthTs:
    """Write `num_frames` (Y, U, V) frames of `frames` (an iterable) as
    intra pictures (one slice per macroblock row, its quantiser scale
    drawn from QS_CHOICES; a sequence header every GOP frames) with AAC
    frames that are silent where silent_audio(t0, t1) (seconds) is true,
    to `path`. The pictures are coded on one thread per core, at most 8.
    video="h264" or "h265" codes them as lossless PCM pictures instead
    (parameter sets every GOP frames; `recon` holds the frames, `qp_maps`
    stays empty); everything else of the stream is the same."""
    if video not in STREAM_TYPES:
        raise ValueError(f"unknown video codec {video!r}")
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    # one generator for the quantisers, one for the audio: the pictures
    # are drawn ahead of the muxing, by as many as the threads take
    rng_q = np.random.default_rng((seed, 4))
    rng_a = np.random.default_rng((seed, 5))
    tz = _Packetizer()
    pat, pmt = _pat(), _pmt(STREAM_TYPES[video])
    # the PCR leads the PTS by 0.4 s, as the test generator's does
    pcr0 = FIRST_PTS * 300 - int(0.4 * 27_000_000)
    out = SynthTs(path, num_frames)
    audio_next = 0
    pictures = (_pictures(frames, num_frames, rng_q, workers)
                if video == "mpeg2"
                else _pcm_pictures(frames, num_frames, video))
    for f, (es, rec, qmap) in enumerate(pictures):
        if f % GOP == 0:
            tz.section(0x0000, pat)
            tz.section(PMT_PID, pmt)
        out.recon.append(rec)
        if qmap is not None:
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
    # sequence_end_code (end of stream / bitstream NAL) in a PES of its
    # own: its start completes the last picture's PES (video PES are
    # unbounded), which a demuxer would hold back at the end otherwise
    end = FIRST_PTS + num_frames * FRAME_TICKS
    end_code = {"mpeg2": b"\x00\x00\x01\xB7", "h264": H264_END,
                "h265": H265_END}[video]
    tz.pes(VIDEO_PID, _pes(0xE0, end_code, end, None, False),
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


def ts_clip(name: str, path: str, video: str = "mpeg2"):
    """Write the short broadcast layout at one size (synth_clip's
    BROADCAST_CLIPS geometry) to `path` with the video codec `video` (see
    write_ts). Returns (SynthTs, format, logos)."""
    spec = TS_CLIPS[name]
    geom = {k: spec[k] for k in ("h", "w", "lh", "lw", "lx", "ly")}
    frames = synth_clip.make_broadcast_clip(**spec, scenes=TS_SCENES,
                                            num_frames=TS_FRAMES)
    ts = write_ts(path, frames, TS_FRAMES, silent_around_cuts, spec["seed"],
                  video)
    return (ts, synth_clip.video_format(spec["h"], spec["w"]),
            synth_clip.make_logos(**geom))
