"""H.265/HEVC normative code tables (ITU-T H.265 / ISO/IEC 23008-2).

Context-model initialisation values (9.3.2.2, Tables 9-5..9-31), scan
orders (6.5.3), intra prediction angles (8.4.4.2.6), interpolation
filters (8.5.4.2.2), inverse-transform matrices (8.6.4), dequant level
scales (8.6.3) and deblocking thresholds (8.7.2.5.3) — transcribed from
the published specification text (normative content identical in any
conforming decoder), validated bit-exactly against libavcodec on
libx265 streams (tests/test_h265_decode.py).

The arithmetic-coder state tables (rangeTabLPS / transIdxLPS) are the
same as H.264's and are reused from h264_tables.

The port's copy of amatsukaze_tpu/video/h265_tables.py.
"""

from __future__ import annotations

import numpy as np

from .h264_tables import RANGE_LPS as RANGE_LPS  # noqa: PLC0414 (re-export)
from .h264_tables import TRANS_IDX_LPS as TRANS_IDX_LPS  # noqa: PLC0414
from .h264_tables import TRANS_IDX_MPS as TRANS_IDX_MPS  # noqa: PLC0414

# ---------------------------------------------------------------------------
# CABAC context initialisation values, keyed by syntax element.
# Each entry: three rows (initType 0 = I, 1, 2) of per-context initValue
# (Tables 9-5 .. 9-31). Elements absent in an initType repeat a row so
# indexing stays uniform (those contexts are never used there).
# ---------------------------------------------------------------------------

CTX_INIT: dict[str, tuple[tuple[int, ...], ...]] = {
    "sao_merge_flag": ((153,), (153,), (153,)),
    "sao_type_idx": ((200,), (185,), (160,)),
    "split_cu_flag": ((139, 141, 157), (107, 139, 126), (107, 139, 126)),
    "cu_transquant_bypass_flag": ((154,), (154,), (154,)),
    "cu_skip_flag": ((197, 185, 201), (197, 185, 201), (197, 185, 201)),
    "pred_mode_flag": ((149,), (149,), (134,)),
    "part_mode": ((184, 154, 139, 154), (154, 139, 154, 154),
                  (154, 139, 154, 154)),
    "prev_intra_luma_pred_flag": ((184,), (154,), (183,)),
    "intra_chroma_pred_mode": ((63,), (152,), (152,)),
    "rqt_root_cbf": ((79,), (79,), (79,)),
    "merge_flag": ((110,), (110,), (154,)),
    "merge_idx": ((122,), (122,), (137,)),
    "inter_pred_idc": ((95, 79, 63, 31, 31), (95, 79, 63, 31, 31),
                       (95, 79, 63, 31, 31)),
    "ref_idx": ((153, 153), (153, 153), (153, 153)),
    "mvp_flag": ((168,), (168,), (168,)),
    "abs_mvd_greater0_flag": ((140,), (140,), (169,)),
    "abs_mvd_greater1_flag": ((198,), (198,), (198,)),
    "cu_qp_delta_abs": ((154, 154), (154, 154), (154, 154)),
    "split_transform_flag": ((153, 138, 138), (124, 138, 94),
                             (224, 167, 122)),
    "cbf_luma": ((111, 141), (153, 111), (153, 111)),
    "cbf_chroma": ((94, 138, 182, 154), (149, 107, 167, 154),
                   (149, 92, 167, 154)),
    "transform_skip_flag": ((139, 139), (139, 139), (139, 139)),
    "last_sig_coeff_x_prefix": (
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108),
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
         111, 79, 108, 123, 93)),
    "last_sig_coeff_y_prefix": (
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108),
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
         111, 79, 108, 123, 93)),
    "coded_sub_block_flag": ((91, 171, 134, 141), (121, 140, 61, 154),
                             (121, 140, 61, 154)),
    "sig_coeff_flag": (
        (111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
         153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
         125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
         136, 139, 111),
        (155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140,
         151, 183, 140),
        (170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140,
         151, 183, 140)),
    "coeff_abs_level_greater1_flag": (
        (140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139,
         107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197),
        (154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182),
        (154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182)),
    "coeff_abs_level_greater2_flag": (
        (138, 153, 136, 167, 152, 152), (107, 167, 91, 122, 107, 167),
        (107, 167, 91, 107, 107, 167)),
    "end_of_slice_segment_flag": ((63,), (63,), (63,)),  # terminate bin
}

# sig_coeff_flag context map for 4x4 blocks (9.3.4.2.5 ctxIdxMap)
SIG_CTX_MAP_4x4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)

# ---------------------------------------------------------------------------
# Scan orders (6.5.3): per 4x4 sub-block scans and sub-block scans,
# generated as (x, y) sequences. scanIdx: 0 = up-right diagonal,
# 1 = horizontal, 2 = vertical.
# ---------------------------------------------------------------------------


def _diag_scan(size: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan order array (6.5.3)."""
    out = []
    i, x, y = 0, 0, 0
    stop = False
    while not stop:
        while y >= 0:
            if x < size and y < size:
                out.append((x, y))
                i += 1
            y -= 1
            x += 1
        y = x
        x = 0
        if i >= size * size:
            stop = True
    return out


def _hor_scan(size: int) -> list[tuple[int, int]]:
    return [(x, y) for y in range(size) for x in range(size)]


def _ver_scan(size: int) -> list[tuple[int, int]]:
    return [(x, y) for x in range(size) for y in range(size)]


# scan position tables: SCAN[scanIdx][log2size] -> ((x,y), ...)
SCAN = {
    0: {k: tuple(_diag_scan(1 << k)) for k in (1, 2, 3)},
    1: {k: tuple(_hor_scan(1 << k)) for k in (1, 2, 3)},
    2: {k: tuple(_ver_scan(1 << k)) for k in (1, 2, 3)},
}

# ---------------------------------------------------------------------------
# Intra prediction (8.4.4.2.6)
# ---------------------------------------------------------------------------

# intraPredAngle for predModeIntra 2..34 (Table 8-5)
INTRA_PRED_ANGLE = (32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17,
                    -21, -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5,
                    9, 13, 17, 21, 26, 32)
# invAngle for predModeIntra 11..25 (Table 8-6); 8192/|angle| rounded
INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
             -21: -390, -26: -315, -32: -256}

# ---------------------------------------------------------------------------
# Inter interpolation filters (8.5.4.2.2)
# ---------------------------------------------------------------------------

LUMA_FILTER = (
    (0, 0, 0, 64, 0, 0, 0, 0),
    (-1, 4, -10, 58, 17, -5, 1, 0),
    (-1, 4, -11, 40, 40, -11, 4, -1),
    (0, 1, -5, 17, 58, -10, 4, -1),
)
CHROMA_FILTER = (
    (0, 64, 0, 0), (-2, 58, 10, -2), (-4, 54, 16, -2), (-6, 46, 28, -4),
    (-4, 36, 36, -4), (-4, 28, 46, -6), (-2, 16, 54, -4), (-2, 10, 58, -2),
)

# ---------------------------------------------------------------------------
# Transforms (8.6.4): integer DCT-II-style matrices and the 4x4 DST-VII.
#
# Every entry of the normative 32x32 matrix is (+/-) one of the 33
# quarter-wave sample values below; entry (k, n) is the sample at index
# (k * (2n+1)) mod 128 with cosine quadrant folding, and the smaller
# matrices are the 32x32 sub-sampled by row stride (the spec's
# transMatrix derivation). The sample values are the published
# normative integers (they deviate from pure cosine rounding at a few
# indices, e.g. index 8 is 83, not round(90.51*cos(pi/8)) = 84).
# ---------------------------------------------------------------------------

_QUARTER_WAVE = (64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73,
                 70, 67, 64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22,
                 18, 13, 9, 4, 0)


def _hevc_dct(size: int) -> np.ndarray:
    m = np.zeros((32, 32), np.int64)
    for k in range(32):
        for n in range(32):
            i = (k * (2 * n + 1)) % 128
            if i <= 32:
                v = _QUARTER_WAVE[i]
            elif i <= 64:
                v = -_QUARTER_WAVE[64 - i]
            elif i <= 96:
                v = -_QUARTER_WAVE[i - 64]
            else:
                v = _QUARTER_WAVE[128 - i]
            m[k][n] = v
    step = 32 // size
    return m[::step, :size].astype(np.int32)


DCT4 = _hevc_dct(4)
DCT8 = _hevc_dct(8)
DCT16 = _hevc_dct(16)
DCT32 = _hevc_dct(32)

DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29]], np.int32)

# dequant level scales (8.6.3)
LEVEL_SCALE = (40, 45, 51, 57, 64, 72)

# ---------------------------------------------------------------------------
# Deblocking thresholds (Table 8-12): beta' indexed by Q 0..51 and
# tc' indexed by Q 0..53.
# ---------------------------------------------------------------------------

BETA_TABLE = tuple([0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                               18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
                               40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60,
                               62, 64])
TC_TABLE = tuple([0] * 16 + [0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
                             3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10,
                             11, 13, 14, 16, 18, 20, 22, 24])

# chroma QP mapping for 4:2:0 (Table 8-10)
CHROMA_QP_MAP = tuple(list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35,
                                         35, 36, 36, 37, 37] + list(
    range(38, 52)))


def chroma_qp_from_luma(qp_i: int) -> int:
    """qPc derivation input mapping (8.6.1, 4:2:0): qPi -> qPc."""
    if qp_i < 30:
        return qp_i
    if qp_i > 43:
        return qp_i - 6
    return CHROMA_QP_MAP[qp_i]


# default scaling lists (Table 7-5/7-6), flat-16 not included: HEVC's
# default 8x8+ intra/inter lists for when scaling_list_enabled with
# defaults; Main-profile streams from x265 default to flat (disabled).
DEFAULT_SCALING_INTRA8 = (
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115)
DEFAULT_SCALING_INTER8 = (
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91)
