"""Pure-Python H.264 decoder (ISO/IEC 14496-10) — the oracle.

Like the MPEG-2 stack (video/mpeg2_ref.py + native/mpeg2dec.cpp), this
defines every arithmetic step of H.264 decoding in exactly reproducible
integer terms; a native C++ engine mirrors it bit-for-bit.  The
reference project decodes H.264 via FFmpeg (reference
Amatsukaze/ReaderWriterFFmpeg.hpp:256-483, AMTSource.hpp:97-152), so
there is no reference decoder to mirror — the implementation follows
14496-10 semantics and is cross-validated bit-exactly against the
system libavcodec on libx264-encoded streams (tests/test_h264_decode.py).

Scope (grown stage by stage, each stage held bit-exact vs FFmpeg):
- NAL/RBSP, full SPS/PPS incl. scaling matrices, slice headers
- I slices: Intra_4x4 / Intra_16x16 / I_PCM prediction, CAVLC residual
  decode (coeff_token nC contexts, total_zeros, run_before), integer
  4x4 transform, luma DC Hadamard, chroma DC 2x2
- P/B slices: quarter-pel MC, MV prediction, skip/direct, ref lists
- deblocking filter, CABAC, 8x8 transform, interlace (PAFF/MBAFF)

Normative code tables live in video/h264_tables.py.

The port's copy of amatsukaze_tpu/video/h264_ref.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.bits import BitReader, EOFError_
from . import h264_tables as T

# ---------------------------------------------------------------------------
# Scan orders (4x4 / 8x8, frame). scan[n] = raster index of n-th coeff.
# ---------------------------------------------------------------------------

ZIGZAG_4x4 = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
FIELD_SCAN_4x4 = (0, 4, 1, 8, 12, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15)

ZIGZAG_8x8 = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)
FIELD_SCAN_8x8 = (
    0, 8, 16, 1, 9, 24, 32, 17, 2, 25, 40, 48, 56, 33, 10, 3,
    18, 41, 49, 57, 26, 11, 4, 19, 34, 42, 50, 58, 27, 12, 5, 20,
    35, 43, 51, 59, 28, 13, 6, 21, 36, 44, 52, 60, 29, 14, 22, 37,
    45, 53, 61, 30, 7, 15, 38, 46, 54, 62, 23, 31, 39, 47, 55, 63,
)

# Default scaling lists (Tables 7-3 / 7-4), in zigzag (decode) order.
DEFAULT_4x4_INTRA = (6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42)
DEFAULT_4x4_INTER = (10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34)
DEFAULT_8x8_INTRA = (
    6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
    23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
    27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31,
    31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42,
)
DEFAULT_8x8_INTER = (
    9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
    21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
    24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
    27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35,
)

# normAdjust4x4 (Table in 8.5.12.1): row = qp % 6, col = position class
# (0: both even coords, 1: both odd, 2: mixed).
_NORM_ADJUST_4x4 = tuple(
    tuple(T.DEQUANT4_COEFF_INIT[3 * m : 3 * m + 3]) for m in range(6)
)
# position class of each raster index in a 4x4 block: 0 = both coords even,
# 2 = both odd, 1 = mixed (FFmpeg-probed: see tests/test_h264_decode.py)
_POS_CLASS_4x4 = tuple(
    (0 if (i % 2 == 0 and j % 2 == 0) else 2 if (i % 2 == 1 and j % 2 == 1) else 1)
    for i in range(4)
    for j in range(4)
)
# normAdjust8x8: row = qp % 6, col = position class 0..5
_NORM_ADJUST_8x8 = tuple(
    tuple(T.DEQUANT8_COEFF_INIT[6 * m : 6 * m + 6]) for m in range(6)
)
# normAdjust8x8 position class repeats in a 4x4 pattern over the 8x8 block:
# class of raster index i = pattern[(row % 4) * 4 + (col % 4)]
_POS_CLASS_8x8 = tuple(
    T.DEQUANT8_COEFF_INIT_SCAN[((i >> 1) & 12) | (i & 3)] for i in range(64)
)


# ---------------------------------------------------------------------------
# CAVLC decode dictionaries built from the flat normative tables
# ---------------------------------------------------------------------------

def _vlc_dict(len_tab, bits_tab, lo, n, value_of):
    """{(length, bits): value} for entries lo..lo+n-1 (len 0 = invalid)."""
    d = {}
    maxlen = 0
    for k in range(n):
        ln = len_tab[lo + k]
        if ln == 0:
            continue
        key = (ln, bits_tab[lo + k])
        assert key not in d, f"duplicate code {key}"
        d[key] = value_of(k)
        maxlen = max(maxlen, ln)
    return d, maxlen

# coeff_token: 4 nC classes, entries indexed 4*total_coeff + trailing_ones
_COEFF_TOKEN = [
    _vlc_dict(T.COEFF_TOKEN_LEN, T.COEFF_TOKEN_BITS, 68 * c, 68,
              lambda k: (k >> 2, k & 3))
    for c in range(4)
]
_COEFF_TOKEN_CHROMA_DC = _vlc_dict(
    T.CHROMA_DC_COEFF_TOKEN_LEN, T.CHROMA_DC_COEFF_TOKEN_BITS, 0, 20,
    lambda k: (k >> 2, k & 3))
_COEFF_TOKEN_CHROMA422_DC = _vlc_dict(
    T.CHROMA422_DC_COEFF_TOKEN_LEN, T.CHROMA422_DC_COEFF_TOKEN_BITS, 0, 36,
    lambda k: (k >> 2, k & 3))

# total_zeros: rows total_coeff-1 = 0..14, 16 columns (value = column)
_TOTAL_ZEROS = [
    _vlc_dict(T.TOTAL_ZEROS_LEN, T.TOTAL_ZEROS_BITS, 16 * row, 16, lambda k: k)
    for row in range(15)
]
_TOTAL_ZEROS_CHROMA_DC = [
    _vlc_dict(T.CHROMA_DC_TOTAL_ZEROS_LEN, T.CHROMA_DC_TOTAL_ZEROS_BITS,
              4 * row, 4, lambda k: k)
    for row in range(3)
]
_TOTAL_ZEROS_CHROMA422_DC = [
    _vlc_dict(T.CHROMA422_DC_TOTAL_ZEROS_LEN, T.CHROMA422_DC_TOTAL_ZEROS_BITS,
              8 * row, 8, lambda k: k)
    for row in range(7)
]

# run_before: rows = min(zeros_left, 7) - 1, value = run
_RUN_BEFORE = [
    _vlc_dict(T.RUN_BEFORE_LEN, T.RUN_BEFORE_BITS, 16 * row, 16, lambda k: k)
    for row in range(7)
]


def _read_vlc(r: BitReader, table) -> int:
    d, maxlen = table
    acc = 0
    for ln in range(1, maxlen + 1):
        acc = (acc << 1) | r.read(1)
        v = d.get((ln, acc))
        if v is not None:
            return v
    raise EOFError_(f"invalid VLC code {acc:b}")


# ---------------------------------------------------------------------------
# NAL / RBSP
# ---------------------------------------------------------------------------

def ebsp_to_rbsp(data: bytes) -> bytes:
    """Strip emulation_prevention_three_byte (00 00 03 -> 00 00)."""
    if b"\x00\x00\x03" not in data:
        return data
    out = bytearray()
    i, n = 0, len(data)
    while True:
        j = data.find(b"\x00\x00\x03", i)
        if j < 0:
            out += data[i:]
            return bytes(out)
        out += data[i : j + 2]
        i = j + 3


def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex B byte stream into NAL units (no start codes)."""
    nals = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        j = data.find(b"\x00\x00\x01", i + 3)
        end = len(data) if j < 0 else j
        # trailing_zero_8bits before the next start code
        while end > i + 3 and data[end - 1] == 0:
            end -= 1
        if end > i + 3:
            nals.append(data[i + 3 : end])
        if j < 0:
            break
        i = j
    return nals


# ---------------------------------------------------------------------------
# Parameter sets
# ---------------------------------------------------------------------------

def _parse_scaling_list(r: BitReader, size: int):
    """-> (list in zigzag order, use_default flag)."""
    scale = [0] * size
    last, nxt = 8, 8
    use_default = False
    for j in range(size):
        if nxt != 0:
            delta = r.se()
            nxt = (last + delta + 256) % 256
            if j == 0 and nxt == 0:
                use_default = True
        scale[j] = last if nxt == 0 else nxt
        last = scale[j]
    return scale, use_default


def _zz_to_raster(zz_list, size):
    scan = ZIGZAG_4x4 if size == 16 else ZIGZAG_8x8
    out = [0] * size
    for k in range(size):
        out[scan[k]] = zz_list[k]
    return out


_DEFAULT_LISTS_4 = (DEFAULT_4x4_INTRA, DEFAULT_4x4_INTER)
_DEFAULT_LISTS_8 = (DEFAULT_8x8_INTRA, DEFAULT_8x8_INTER)


def _read_scaling_matrices(r: BitReader, n_lists: int, fallback):
    """Parse scaling_list() syntax for n_lists lists.

    fallback[i] = list used when scaling_list_present_flag[i] == 0
    (rule A: defaults chain; rule B: the SPS matrices).  Returns lists in
    ZIGZAG order (length 16 for i<6, 64 for i>=6).
    """
    out = []
    for i in range(n_lists):
        size = 16 if i < 6 else 64
        present = r.read(1)
        if present:
            lst, use_def = _parse_scaling_list(r, size)
            if use_def:
                lst = list(_default_list(i))
        else:
            lst = list(fallback(i, out))
        out.append(lst)
    return out


def _default_list(i: int):
    if i < 6:
        return _DEFAULT_LISTS_4[0] if i < 3 else _DEFAULT_LISTS_4[1]
    return _DEFAULT_LISTS_8[0] if (i - 6) % 2 == 0 else _DEFAULT_LISTS_8[1]


def _fallback_rule_a(i: int, parsed):
    # list 0 and 3 (and every 8x8 list) fall to defaults; others to previous
    if i in (0, 3) or i >= 6:
        return _default_list(i)
    return parsed[i - 1]


@dataclass
class SPS:
    profile_idc: int = 0
    level_idc: int = 0
    sps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: int = 0
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    qpprime_y_zero_transform_bypass: int = 0
    scaling_matrix: list = None  # 8 or 12 lists, zigzag order, or None (flat)
    log2_max_frame_num: int = 4
    poc_type: int = 0
    log2_max_poc_lsb: int = 4
    delta_pic_order_always_zero: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: tuple = ()
    max_num_ref_frames: int = 0
    gaps_in_frame_num_allowed: int = 0
    pic_width_in_mbs: int = 0
    pic_height_in_map_units: int = 0
    frame_mbs_only: int = 1
    mb_adaptive_frame_field: int = 0
    direct_8x8_inference: int = 0
    crop: tuple = (0, 0, 0, 0)  # left, right, top, bottom (in units)

    @property
    def width(self) -> int:
        return self.pic_width_in_mbs * 16

    @property
    def height(self) -> int:
        return self.pic_height_in_map_units * 16 * (2 - self.frame_mbs_only)


def parse_sps(rbsp: bytes) -> SPS:
    r = BitReader(rbsp)
    s = SPS()
    s.profile_idc = r.read(8)
    r.skip(8)  # constraint flags + reserved
    s.level_idc = r.read(8)
    s.sps_id = r.ue()
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        s.chroma_format_idc = r.ue()
        if s.chroma_format_idc == 3:
            s.separate_colour_plane = r.read(1)
        s.bit_depth_luma = 8 + r.ue()
        s.bit_depth_chroma = 8 + r.ue()
        s.qpprime_y_zero_transform_bypass = r.read(1)
        if r.read(1):  # seq_scaling_matrix_present
            n = 8 if s.chroma_format_idc != 3 else 12
            s.scaling_matrix = _read_scaling_matrices(r, n, _fallback_rule_a)
    s.log2_max_frame_num = 4 + r.ue()
    s.poc_type = r.ue()
    if s.poc_type == 0:
        s.log2_max_poc_lsb = 4 + r.ue()
    elif s.poc_type == 1:
        s.delta_pic_order_always_zero = r.read(1)
        s.offset_for_non_ref_pic = r.se()
        s.offset_for_top_to_bottom_field = r.se()
        n = r.ue()
        s.offset_for_ref_frame = tuple(r.se() for _ in range(n))
    s.max_num_ref_frames = r.ue()
    s.gaps_in_frame_num_allowed = r.read(1)
    s.pic_width_in_mbs = r.ue() + 1
    s.pic_height_in_map_units = r.ue() + 1
    s.frame_mbs_only = r.read(1)
    if not s.frame_mbs_only:
        s.mb_adaptive_frame_field = r.read(1)
    s.direct_8x8_inference = r.read(1)
    if r.read(1):  # frame_cropping
        s.crop = (r.ue(), r.ue(), r.ue(), r.ue())
    # VUI ignored for pixel decode (timing handled by ts/video_h264.py)
    return s


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    entropy_coding_mode: int = 0
    bottom_field_pic_order_in_frame_present: int = 0
    num_slice_groups: int = 1
    num_ref_idx_default: tuple = (1, 1)
    weighted_pred: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: int = 0
    constrained_intra_pred: int = 0
    redundant_pic_cnt_present: int = 0
    transform_8x8_mode: int = 0
    scaling_matrix: list = None  # resolved final lists (zigzag) or None
    second_chroma_qp_index_offset: int = 0


def parse_pps(rbsp: bytes, sps_map: dict[int, SPS]) -> PPS:
    r = BitReader(rbsp)
    p = PPS()
    p.pps_id = r.ue()
    p.sps_id = r.ue()
    sps = sps_map.get(p.sps_id)
    p.entropy_coding_mode = r.read(1)
    p.bottom_field_pic_order_in_frame_present = r.read(1)
    p.num_slice_groups = r.ue() + 1
    if p.num_slice_groups > 1:  # FMO — not used by broadcast/x264
        map_type = r.ue()
        if map_type == 0:
            for _ in range(p.num_slice_groups):
                r.ue()
        elif map_type == 2:
            for _ in range(p.num_slice_groups - 1):
                r.ue(), r.ue()
        elif map_type in (3, 4, 5):
            r.read(1)
            r.ue()
        elif map_type == 6:
            n = r.ue() + 1
            bits = max(1, (p.num_slice_groups - 1).bit_length())
            for _ in range(n):
                r.read(bits)
    p.num_ref_idx_default = (r.ue() + 1, r.ue() + 1)
    p.weighted_pred = r.read(1)
    p.weighted_bipred_idc = r.read(2)
    p.pic_init_qp = 26 + r.se()
    p.pic_init_qs = 26 + r.se()
    p.chroma_qp_index_offset = r.se()
    p.deblocking_filter_control_present = r.read(1)
    p.constrained_intra_pred = r.read(1)
    p.redundant_pic_cnt_present = r.read(1)
    p.second_chroma_qp_index_offset = p.chroma_qp_index_offset
    p.scaling_matrix = sps.scaling_matrix if sps is not None else None
    if r.bits_left() > 8 or (r.bits_left() >= 1 and r.peek(min(8, r.bits_left())) not in _rbsp_stop_codes(r)):
        # more_rbsp_data(): detect via trailing-bits pattern
        pass
    if _more_rbsp_data(r):
        p.transform_8x8_mode = r.read(1)
        if r.read(1):  # pic_scaling_matrix_present
            n = 6 + ((6 if (sps and sps.chroma_format_idc == 3) else 2)
                     * p.transform_8x8_mode)
            sps_mat = sps.scaling_matrix if sps is not None else None

            def fallback_b(i, parsed):
                if i in (0, 3) or i >= 6:
                    if sps_mat is not None and i < len(sps_mat):
                        return sps_mat[i]
                    return _default_list(i)
                return parsed[i - 1]

            mats = _read_scaling_matrices(r, n, fallback_b)
            if n == 8:
                # only 2 8x8 lists coded (Y intra, Y inter)
                pass
            p.scaling_matrix = mats
        p.second_chroma_qp_index_offset = r.se()
    else:
        p.second_chroma_qp_index_offset = p.chroma_qp_index_offset
    return p


def _rbsp_stop_codes(r):
    return ()


def _more_rbsp_data(r: BitReader) -> bool:
    """True if syntax elements remain before rbsp_trailing_bits()."""
    left = r.bits_left()
    if left <= 0:
        return False
    # find the last set bit in the remainder (the rbsp_stop_one_bit)
    tail = r.peek(left)
    if tail == 0:
        return False  # malformed; treat as no more data
    # position of the lowest set bit from the end
    stop = tail.bit_length()  # bits up to & including first 1 from MSB side
    # bits after current pos down to the final 1-bit: if any non-trailing
    # bits exist before the stop bit, there is more data
    lowest = tail & -tail
    n_trailing = lowest.bit_length()  # stop bit position from LSB (1-based)
    return left - n_trailing >= 1


# ---------------------------------------------------------------------------
# Slice header
# ---------------------------------------------------------------------------

SLICE_P, SLICE_B, SLICE_I, SLICE_SP, SLICE_SI = 0, 1, 2, 3, 4


@dataclass
class SliceHeader:
    first_mb: int = 0
    slice_type: int = 0  # modulo 5
    all_equal: bool = False  # slice_type was 5..9
    pps_id: int = 0
    frame_num: int = 0
    field_pic_flag: int = 0
    bottom_field_flag: int = 0
    idr: bool = False
    idr_pic_id: int = 0
    poc_lsb: int = 0
    delta_poc_bottom: int = 0
    delta_poc: tuple = (0, 0)
    redundant_pic_cnt: int = 0
    direct_spatial_mv_pred: int = 0
    num_ref_idx: tuple = (0, 0)
    ref_list_mods: tuple = ((), ())  # per list: ((op, val), ...)
    # explicit weighted prediction: luma_log2_denom, chroma_log2_denom,
    # weights[list][ref] = (wY, oY, wCb, oCb, wCr, oCr) or None
    pred_weights: tuple = None
    mmco: tuple = ()  # ((op, v1[, v2]), ...) or ('long_term_ref_flag', f) for IDR
    no_output_of_prior_pics: int = 0
    long_term_reference_flag: int = 0
    adaptive_ref_pic_marking: bool = False
    cabac_init_idc: int = 0
    slice_qp: int = 26
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    nal_ref_idc: int = 0
    # bit position where slice data starts (after the header)
    data_bit_pos: int = 0


def parse_slice_header(rbsp: bytes, nal_ref_idc: int, nal_type: int,
                       sps_map: dict, pps_map: dict) -> tuple[SliceHeader, SPS, PPS]:
    r = BitReader(rbsp)
    h = SliceHeader()
    h.nal_ref_idc = nal_ref_idc
    h.idr = nal_type == 5
    h.first_mb = r.ue()
    st = r.ue()
    h.all_equal = st >= 5
    h.slice_type = st % 5
    h.pps_id = r.ue()
    pps = pps_map[h.pps_id]
    sps = sps_map[pps.sps_id]
    if sps.separate_colour_plane:
        r.read(2)  # colour_plane_id
    h.frame_num = r.read(sps.log2_max_frame_num)
    if not sps.frame_mbs_only:
        h.field_pic_flag = r.read(1)
        if h.field_pic_flag:
            h.bottom_field_flag = r.read(1)
    if h.idr:
        h.idr_pic_id = r.ue()
    if sps.poc_type == 0:
        h.poc_lsb = r.read(sps.log2_max_poc_lsb)
        if pps.bottom_field_pic_order_in_frame_present and not h.field_pic_flag:
            h.delta_poc_bottom = r.se()
    elif sps.poc_type == 1 and not sps.delta_pic_order_always_zero:
        d0 = r.se()
        d1 = r.se() if (pps.bottom_field_pic_order_in_frame_present
                        and not h.field_pic_flag) else 0
        h.delta_poc = (d0, d1)
    if pps.redundant_pic_cnt_present:
        h.redundant_pic_cnt = r.ue()
    if h.slice_type == SLICE_B:
        h.direct_spatial_mv_pred = r.read(1)
    n0, n1 = pps.num_ref_idx_default
    if h.slice_type in (SLICE_P, SLICE_SP, SLICE_B):
        if r.read(1):  # num_ref_idx_active_override
            n0 = r.ue() + 1
            if h.slice_type == SLICE_B:
                n1 = r.ue() + 1
    h.num_ref_idx = (n0, n1 if h.slice_type == SLICE_B else 0)
    # ref_pic_list_modification
    mods = [[], []]
    n_lists = 0
    if h.slice_type in (SLICE_P, SLICE_SP, SLICE_B):
        n_lists = 2 if h.slice_type == SLICE_B else 1
    for lx in range(n_lists):
        if r.read(1):  # ref_pic_list_modification_flag
            while True:
                op = r.ue()
                if op == 3:
                    break
                mods[lx].append((op, r.ue()))
    h.ref_list_mods = (tuple(mods[0]), tuple(mods[1]))
    # pred_weight_table
    if (pps.weighted_pred and h.slice_type in (SLICE_P, SLICE_SP)) or (
            pps.weighted_bipred_idc == 1 and h.slice_type == SLICE_B):
        h.pred_weights = _parse_pred_weights(r, h, sps)
    # dec_ref_pic_marking
    if nal_ref_idc:
        if h.idr:
            h.no_output_of_prior_pics = r.read(1)
            h.long_term_reference_flag = r.read(1)
        else:
            if r.read(1):  # adaptive_ref_pic_marking_mode_flag
                h.adaptive_ref_pic_marking = True
                ops = []
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    vals = [op]
                    if op in (1, 3):
                        vals.append(r.ue())  # difference_of_pic_nums_minus1
                    if op == 2:
                        vals.append(r.ue())  # long_term_pic_num
                    if op in (3, 6):
                        vals.append(r.ue())  # long_term_frame_idx
                    if op == 4:
                        vals.append(r.ue())  # max_long_term_frame_idx_plus1
                    ops.append(tuple(vals))
                h.mmco = tuple(ops)
    if pps.entropy_coding_mode and h.slice_type not in (SLICE_I, SLICE_SI):
        h.cabac_init_idc = r.ue()
    h.slice_qp = pps.pic_init_qp + r.se()
    if h.slice_type in (SLICE_SP, SLICE_SI):
        if h.slice_type == SLICE_SP:
            r.read(1)  # sp_for_switch_flag
        r.se()  # slice_qs_delta
    if pps.deblocking_filter_control_present:
        h.disable_deblocking_filter_idc = r.ue()
        if h.disable_deblocking_filter_idc != 1:
            h.slice_alpha_c0_offset_div2 = r.se()
            h.slice_beta_offset_div2 = r.se()
    # slice groups: not supported (num_slice_groups == 1 everywhere here)
    h.data_bit_pos = r.pos
    return h, sps, pps


def _parse_pred_weights(r: BitReader, h: SliceHeader, sps: SPS):
    luma_log2 = r.ue()
    chroma_log2 = r.ue() if sps.chroma_format_idc != 0 else 0
    out = []
    for lx in range(2 if h.slice_type == SLICE_B else 1):
        lst = []
        for _ in range(h.num_ref_idx[lx] if lx == 1 else h.num_ref_idx[0]):
            wy, oy = 1 << luma_log2, 0
            if r.read(1):  # luma_weight_flag
                wy, oy = r.se(), r.se()
            wcb = wcr = 1 << chroma_log2
            ocb = ocr = 0
            if sps.chroma_format_idc != 0 and r.read(1):
                wcb, ocb = r.se(), r.se()
                wcr, ocr = r.se(), r.se()
            lst.append((wy, oy, wcb, ocb, wcr, ocr))
        out.append(tuple(lst))
    while len(out) < 2:
        out.append(())
    return (luma_log2, chroma_log2, tuple(out))


# ---------------------------------------------------------------------------
# CAVLC residual block decode (9.2)
# ---------------------------------------------------------------------------

def _cavlc_block(r: BitReader, nc: int, max_coeff: int):
    """Decode one residual block. Returns (coeffs in scan order, total_coeff)."""
    if nc >= 0:
        cls = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
        tc, t1 = _read_vlc(r, _COEFF_TOKEN[cls])
    elif nc == -1:
        tc, t1 = _read_vlc(r, _COEFF_TOKEN_CHROMA_DC)
    else:  # nc == -2, 4:2:2 chroma DC
        tc, t1 = _read_vlc(r, _COEFF_TOKEN_CHROMA422_DC)
    coeffs = [0] * max_coeff
    if tc == 0:
        return coeffs, 0
    suffix_len = 1 if (tc > 10 and t1 < 3) else 0
    levels = []
    for i in range(tc):
        if i < t1:
            levels.append(1 - 2 * r.read(1))
            continue
        prefix = 0
        while r.read(1) == 0:
            prefix += 1
            if prefix > 32:
                raise EOFError_("bad level_prefix")
        lcode = min(15, prefix) << suffix_len
        sz = suffix_len
        if prefix >= 15:
            sz = prefix - 3
        elif prefix == 14 and suffix_len == 0:
            sz = 4
        if sz:
            lcode += r.read(sz)
        if prefix >= 15 and suffix_len == 0:
            lcode += 15
        if prefix >= 16:
            lcode += (1 << (prefix - 3)) - 4096
        if i == t1 and t1 < 3:
            lcode += 2
        level = (lcode + 2) >> 1 if (lcode & 1) == 0 else -((lcode + 1) >> 1)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
        levels.append(level)
    if tc < max_coeff:
        if nc == -1:
            total_zeros = _read_vlc(r, _TOTAL_ZEROS_CHROMA_DC[tc - 1])
        elif nc == -2:
            total_zeros = _read_vlc(r, _TOTAL_ZEROS_CHROMA422_DC[tc - 1])
        else:
            total_zeros = _read_vlc(r, _TOTAL_ZEROS[tc - 1])
    else:
        total_zeros = 0
    zeros_left = total_zeros
    idx = tc + total_zeros - 1
    for k in range(tc):
        coeffs[idx] = levels[k]
        if k == tc - 1:
            break
        if zeros_left > 0:
            run = _read_vlc(r, _RUN_BEFORE[min(zeros_left, 7) - 1])
        else:
            run = 0
        zeros_left -= run
        idx -= 1 + run
    return coeffs, tc


# ---------------------------------------------------------------------------
# Dequantisation + integer transforms (8.5)
# ---------------------------------------------------------------------------

_FLAT16 = (16,) * 16
_FLAT64 = (16,) * 64


def _dequant4_tab(qp: int, weight_raster) -> tuple:
    """LevelScale4x4 = W(i,j) * normAdjust(qp%6, i, j) per raster position;
    the qp-dependent shift (with low-qp rounding) is applied per
    coefficient by _dequant4_apply.  For the flat weight 16 this is
    bit-identical to a plain (LS << qp/6) >> 4."""
    na = _NORM_ADJUST_4x4[qp % 6]
    return tuple(weight_raster[k] * na[_POS_CLASS_4x4[k]] for k in range(16))


def _dequant4_apply(c: int, ls: int, qp: int) -> int:
    """8.5.12.1: left-shift above qp 24, rounded right-shift below (the
    rounding only shows with non-flat scaling matrices)."""
    if qp >= 24:
        return (c * ls) << (qp // 6 - 4)
    return (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)


def _idct4x4(d):
    """Exact 14496-10 8.5.12.2 inverse 4x4 transform. d: raster list of 16
    dequantised ints. Returns raster residual after (x + 32) >> 6."""
    e = [0] * 16
    for i in range(4):  # rows
        d0, d1, d2, d3 = d[4 * i : 4 * i + 4]
        a0 = d0 + d2
        a1 = d0 - d2
        a2 = (d1 >> 1) - d3
        a3 = d1 + (d3 >> 1)
        e[4 * i] = a0 + a3
        e[4 * i + 1] = a1 + a2
        e[4 * i + 2] = a1 - a2
        e[4 * i + 3] = a0 - a3
    out = [0] * 16
    for j in range(4):  # columns
        d0, d1, d2, d3 = e[j], e[4 + j], e[8 + j], e[12 + j]
        a0 = d0 + d2
        a1 = d0 - d2
        a2 = (d1 >> 1) - d3
        a3 = d1 + (d3 >> 1)
        out[j] = (a0 + a3 + 32) >> 6
        out[4 + j] = (a1 + a2 + 32) >> 6
        out[8 + j] = (a1 - a2 + 32) >> 6
        out[12 + j] = (a0 - a3 + 32) >> 6
    return out


def _dequant8_tab(qp: int, weight_raster) -> tuple:
    """LevelScale8x8 per raster position (8.5.13.1), shift applied at use."""
    na = _NORM_ADJUST_8x8[qp % 6]
    return tuple(weight_raster[k] * na[_POS_CLASS_8x8[k]] for k in range(64))


def _dequant8_apply(c: int, ls: int, qp: int) -> int:
    """FFmpeg-probed rounding (tests/test_h264_decode.py 8x8 DC probes):
    right-shift with +2^(5-qp/6) rounding below qp 36, left-shift above."""
    if qp >= 36:
        return (c * ls) << (qp // 6 - 6)
    return (c * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def _idct8_1d(d):
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    a0 = d0 + d4
    a2 = d0 - d4
    a4 = (d2 >> 1) - d6
    a6 = d2 + (d6 >> 1)
    b0 = a0 + a6
    b2 = a2 + a4
    b4 = a2 - a4
    b6 = a0 - a6
    a1 = -d3 + d5 - d7 - (d7 >> 1)
    a3 = d1 + d7 - d3 - (d3 >> 1)
    a5 = -d1 + d7 + d5 + (d5 >> 1)
    a7 = d3 + d5 + d1 + (d1 >> 1)
    b1 = a1 + (a7 >> 2)
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    b7 = a7 - (a1 >> 2)
    return (b0 + b7, b2 + b5, b4 + b3, b6 + b1,
            b6 - b1, b4 - b3, b2 - b5, b0 - b7)


def _idct8x8(d):
    """8.5.13.2 inverse 8x8 transform, rows then columns (FFmpeg-matched
    order — the >>1 floors make pass order observable); (f+32)>>6 at end."""
    e = [0] * 64
    for i in range(8):
        e[8 * i : 8 * i + 8] = _idct8_1d(d[8 * i : 8 * i + 8])
    out = [0] * 64
    for j in range(8):
        col = _idct8_1d(e[j::8])
        for i in range(8):
            out[8 * i + j] = (col[i] + 32) >> 6
    return out


def _pred8x8(mode: int, left, top, topleft, avail_l, avail_t, avail_tl):
    """Intra 8x8 prediction (8.3.2.2.2+) on FILTERED reference samples.
    top: 16 filtered samples (incl. top-right extension), left: 8."""
    pred = [[0] * 8 for _ in range(8)]
    t, l, tl = top, left, topleft
    if mode == 0:  # Vertical
        for y in range(8):
            pred[y] = list(t[:8])
    elif mode == 1:  # Horizontal
        for y in range(8):
            pred[y] = [l[y]] * 8
    elif mode == 2:  # DC
        if avail_l and avail_t:
            v = (sum(t[:8]) + sum(l) + 8) >> 4
        elif avail_l:
            v = (sum(l) + 4) >> 3
        elif avail_t:
            v = (sum(t[:8]) + 4) >> 3
        else:
            v = 128
        for y in range(8):
            pred[y] = [v] * 8
    elif mode == 3:  # Diagonal down-left
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    pred[y][x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    pred[y][x] = (t[x + y] + 2 * t[x + y + 1]
                                  + t[x + y + 2] + 2) >> 2
    elif mode in (4, 5, 6):  # down-right / vertical-right / horizontal-down
        # spec sample index -1 designates p[-1,-1] (the filtered top-left);
        # guard against Python's wrap-around indexing
        def tx(i):
            return tl if i < 0 else t[i]

        def lx(i):
            return tl if i < 0 else l[i]

        if mode == 4:
            for y in range(8):
                for x in range(8):
                    if x > y:
                        pred[y][x] = (tx(x - y - 2) + 2 * tx(x - y - 1)
                                      + t[x - y] + 2) >> 2
                    elif x < y:
                        pred[y][x] = (lx(y - x - 2) + 2 * lx(y - x - 1)
                                      + l[y - x] + 2) >> 2
                    else:
                        pred[y][x] = (t[0] + 2 * tl + l[0] + 2) >> 2
        elif mode == 5:
            for y in range(8):
                for x in range(8):
                    z = 2 * x - y
                    if z >= 0 and z % 2 == 0:
                        pred[y][x] = (tx(x - (y >> 1) - 1)
                                      + t[x - (y >> 1)] + 1) >> 1
                    elif z >= 0:
                        pred[y][x] = (tx(x - (y >> 1) - 2)
                                      + 2 * tx(x - (y >> 1) - 1)
                                      + t[x - (y >> 1)] + 2) >> 2
                    elif z == -1:
                        pred[y][x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                    else:
                        pred[y][x] = (lx(y - 2 * x - 1) + 2 * lx(y - 2 * x - 2)
                                      + lx(y - 2 * x - 3) + 2) >> 2
        else:  # mode 6
            for y in range(8):
                for x in range(8):
                    z = 2 * y - x
                    if z >= 0 and z % 2 == 0:
                        pred[y][x] = (lx(y - (x >> 1) - 1)
                                      + l[y - (x >> 1)] + 1) >> 1
                    elif z >= 0:
                        pred[y][x] = (lx(y - (x >> 1) - 2)
                                      + 2 * lx(y - (x >> 1) - 1)
                                      + l[y - (x >> 1)] + 2) >> 2
                    elif z == -1:
                        pred[y][x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                    else:
                        pred[y][x] = (tx(x - 2 * y - 1) + 2 * tx(x - 2 * y - 2)
                                      + tx(x - 2 * y - 3) + 2) >> 2
    elif mode == 7:  # Vertical left
        for y in range(8):
            for x in range(8):
                if y % 2 == 0:
                    pred[y][x] = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1
                else:
                    pred[y][x] = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                                  + t[x + (y >> 1) + 2] + 2) >> 2
    elif mode == 8:  # Horizontal up
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z % 2 == 0 and z < 14:
                    pred[y][x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1
                elif z < 13:
                    pred[y][x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                                  + l[y + (x >> 1) + 2] + 2) >> 2
                elif z == 13:
                    pred[y][x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    pred[y][x] = l[7]
    else:
        raise ValueError(f"bad intra8x8 mode {mode}")
    return pred


def _filter_i8_refs(left, top, topleft, avail_l, avail_t, avail_tl):
    """Reference sample filtering for intra 8x8 (8.3.2.2.1).
    left: 8 raw or None; top: 16 raw (with top-right substitution already
    applied) or None; topleft: raw int or None."""
    fl = ft = None
    ftl = 0
    if avail_t:
        ft = [0] * 16
        if avail_tl:
            ft[0] = (topleft + 2 * top[0] + top[1] + 2) >> 2
        else:
            ft[0] = (3 * top[0] + top[1] + 2) >> 2
        for x in range(1, 15):
            ft[x] = (top[x - 1] + 2 * top[x] + top[x + 1] + 2) >> 2
        ft[15] = (top[14] + 3 * top[15] + 2) >> 2
    if avail_tl:
        if avail_l and avail_t:
            ftl = (top[0] + 2 * topleft + left[0] + 2) >> 2
        elif avail_t:
            ftl = (3 * topleft + top[0] + 2) >> 2
        elif avail_l:
            ftl = (3 * topleft + left[0] + 2) >> 2
        else:
            ftl = topleft
    if avail_l:
        fl = [0] * 8
        if avail_tl:
            fl[0] = (topleft + 2 * left[0] + left[1] + 2) >> 2
        else:
            fl[0] = (3 * left[0] + left[1] + 2) >> 2
        for y in range(1, 7):
            fl[y] = (left[y - 1] + 2 * left[y] + left[y + 1] + 2) >> 2
        fl[7] = (left[6] + 3 * left[7] + 2) >> 2
    return fl, ft, ftl


def _hadamard4x4(c):
    """Inverse 4x4 Hadamard for Intra_16x16 luma DC (8.5.10), no scaling."""
    e = [0] * 16
    for i in range(4):
        c0, c1, c2, c3 = c[4 * i : 4 * i + 4]
        a0 = c0 + c2
        a1 = c0 - c2
        a2 = c1 - c3
        a3 = c1 + c3
        e[4 * i] = a0 + a3
        e[4 * i + 1] = a1 + a2
        e[4 * i + 2] = a1 - a2
        e[4 * i + 3] = a0 - a3
    out = [0] * 16
    for j in range(4):
        c0, c1, c2, c3 = e[j], e[4 + j], e[8 + j], e[12 + j]
        a0 = c0 + c2
        a1 = c0 - c2
        a2 = c1 - c3
        a3 = c1 + c3
        out[j] = a0 + a3
        out[4 + j] = a1 + a2
        out[8 + j] = a1 - a2
        out[12 + j] = a0 - a3
    return out


def _luma_dc_dequant(f, qp: int, w0: int):
    """Scale inverse-Hadamard luma DC values (8.5.10):
    (f * W(0,0)*normAdjust << qp/6 + 32) >> 6, arithmetic shift.
    Pinned by FFmpeg probes over crafted streams at discriminating DC
    values (tests/test_h264_decode.py): rounding +32 present (unlike the
    chroma DC path), shifts floor."""
    ls = (w0 * _NORM_ADJUST_4x4[qp % 6][0]) << (qp // 6)
    return [(v * ls + 32) >> 6 for v in f]


def _chroma_dc_dequant(f, qp: int, w0: int):
    """Scale 2x2 chroma DC values (8.5.11):
    ((f * W(0,0)*normAdjust) << qp/6) >> 5, plain floor shift, no
    rounding term — FFmpeg-probed at discriminating negative DC values
    (tests/test_h264_decode.py)."""
    ls = w0 * _NORM_ADJUST_4x4[qp % 6][0]
    sh = qp // 6
    return [((v * ls) << sh) >> 5 for v in f]


def chroma_qp(qp_luma: int, offset: int) -> int:
    qpi = min(51, max(0, qp_luma + offset))
    return T.CHROMA_QP_TABLE[qpi]


def _clip1(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


# z-scan index -> (x4, y4) position of a 4x4 block inside the MB
_Z_TO_XY = tuple(((k & 1) + 2 * ((k >> 2) & 1), ((k >> 1) & 1) + 2 * ((k >> 3) & 1))
                 for k in range(16))
_XY_TO_Z = {xy: k for k, xy in enumerate(_Z_TO_XY)}


# ---------------------------------------------------------------------------
# Intra prediction (8.3)
# ---------------------------------------------------------------------------

def _pred4x4(mode: int, P, avail_l: bool, avail_t: bool, avail_tl: bool):
    """4x4 intra prediction (8.3.1.2). P(x, y) returns the neighbour sample
    for x in -1..7, y in -1..3 (top-right already substituted by caller when
    unavailable). Returns a 4x4 list-of-rows."""
    pred = [[0] * 4 for _ in range(4)]
    if mode == 0:  # Vertical
        t = [P(x, -1) for x in range(4)]
        for y in range(4):
            pred[y] = t[:]
    elif mode == 1:  # Horizontal
        for y in range(4):
            v = P(-1, y)
            pred[y] = [v] * 4
    elif mode == 2:  # DC
        if avail_l and avail_t:
            v = (sum(P(x, -1) for x in range(4))
                 + sum(P(-1, y) for y in range(4)) + 4) >> 3
        elif avail_l:
            v = (sum(P(-1, y) for y in range(4)) + 2) >> 2
        elif avail_t:
            v = (sum(P(x, -1) for x in range(4)) + 2) >> 2
        else:
            v = 128
        for y in range(4):
            pred[y] = [v] * 4
    elif mode == 3:  # Diagonal down-left
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    pred[y][x] = (P(6, -1) + 3 * P(7, -1) + 2) >> 2
                else:
                    pred[y][x] = (P(x + y, -1) + 2 * P(x + y + 1, -1)
                                  + P(x + y + 2, -1) + 2) >> 2
    elif mode == 4:  # Diagonal down-right
        for y in range(4):
            for x in range(4):
                if x > y:
                    pred[y][x] = (P(x - y - 2, -1) + 2 * P(x - y - 1, -1)
                                  + P(x - y, -1) + 2) >> 2
                elif x < y:
                    pred[y][x] = (P(-1, y - x - 2) + 2 * P(-1, y - x - 1)
                                  + P(-1, y - x) + 2) >> 2
                else:
                    pred[y][x] = (P(0, -1) + 2 * P(-1, -1) + P(-1, 0) + 2) >> 2
    elif mode == 5:  # Vertical right
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    pred[y][x] = (P(x - (y >> 1) - 1, -1)
                                  + P(x - (y >> 1), -1) + 1) >> 1
                elif z >= 0:
                    pred[y][x] = (P(x - (y >> 1) - 2, -1)
                                  + 2 * P(x - (y >> 1) - 1, -1)
                                  + P(x - (y >> 1), -1) + 2) >> 2
                elif z == -1:
                    pred[y][x] = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2
                else:
                    pred[y][x] = (P(-1, y - 2 * x - 1) + 2 * P(-1, y - 2 * x - 2)
                                  + P(-1, y - 2 * x - 3) + 2) >> 2
    elif mode == 6:  # Horizontal down
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    pred[y][x] = (P(-1, y - (x >> 1) - 1)
                                  + P(-1, y - (x >> 1)) + 1) >> 1
                elif z >= 0:
                    pred[y][x] = (P(-1, y - (x >> 1) - 2)
                                  + 2 * P(-1, y - (x >> 1) - 1)
                                  + P(-1, y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    pred[y][x] = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2
                else:
                    pred[y][x] = (P(x - 2 * y - 1, -1) + 2 * P(x - 2 * y - 2, -1)
                                  + P(x - 2 * y - 3, -1) + 2) >> 2
    elif mode == 7:  # Vertical left
        for y in range(4):
            for x in range(4):
                if y % 2 == 0:
                    pred[y][x] = (P(x + (y >> 1), -1)
                                  + P(x + (y >> 1) + 1, -1) + 1) >> 1
                else:
                    pred[y][x] = (P(x + (y >> 1), -1)
                                  + 2 * P(x + (y >> 1) + 1, -1)
                                  + P(x + (y >> 1) + 2, -1) + 2) >> 2
    elif mode == 8:  # Horizontal up
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z % 2 == 0 and z < 6:
                    pred[y][x] = (P(-1, y + (x >> 1))
                                  + P(-1, y + (x >> 1) + 1) + 1) >> 1
                elif z < 5:
                    pred[y][x] = (P(-1, y + (x >> 1))
                                  + 2 * P(-1, y + (x >> 1) + 1)
                                  + P(-1, y + (x >> 1) + 2) + 2) >> 2
                elif z == 5:
                    pred[y][x] = (P(-1, 2) + 3 * P(-1, 3) + 2) >> 2
                else:
                    pred[y][x] = P(-1, 3)
    else:
        raise ValueError(f"bad intra4x4 mode {mode}")
    return pred


def _pred16x16(mode: int, left, top, topleft, avail_l, avail_t):
    """16x16 luma intra prediction (8.3.3). left/top: 16 samples or None."""
    pred = np.empty((16, 16), np.int32)
    if mode == 0:  # Vertical
        pred[:] = np.asarray(top, np.int32)[None, :]
    elif mode == 1:  # Horizontal
        pred[:] = np.asarray(left, np.int32)[:, None]
    elif mode == 2:  # DC
        if avail_l and avail_t:
            v = (int(sum(top)) + int(sum(left)) + 16) >> 5
        elif avail_l:
            v = (int(sum(left)) + 8) >> 4
        elif avail_t:
            v = (int(sum(top)) + 8) >> 4
        else:
            v = 128
        pred[:] = v
    else:  # Plane
        H = sum((i + 1) * (top[8 + i] - (topleft if i == 7 else top[6 - i]))
                for i in range(8))
        V = sum((i + 1) * (left[8 + i] - (topleft if i == 7 else left[6 - i]))
                for i in range(8))
        a = 16 * (left[15] + top[15])
        b = (5 * H + 32) >> 6
        c = (5 * V + 32) >> 6
        xs = np.arange(16, dtype=np.int32)
        grid = a + b * (xs[None, :] - 7) + c * (xs[:, None] - 7) + 16
        pred[:] = np.clip(grid >> 5, 0, 255)
    return pred


def _pred_chroma8x8(mode: int, left, top, topleft, avail_l, avail_t):
    """8x8 chroma intra prediction (8.3.4). Modes 0 DC / 1 H / 2 V / 3 Plane."""
    pred = np.empty((8, 8), np.int32)
    if mode == 0:  # DC, per 4x4 sub-block
        for by in (0, 4):
            for bx in (0, 4):
                t = top[bx : bx + 4] if avail_t else None
                l = left[by : by + 4] if avail_l else None
                if bx == by:  # (0,0) and (4,4): both edges
                    if t is not None and l is not None:
                        v = (int(sum(t)) + int(sum(l)) + 4) >> 3
                    elif l is not None:
                        v = (int(sum(l)) + 2) >> 2
                    elif t is not None:
                        v = (int(sum(t)) + 2) >> 2
                    else:
                        v = 128
                elif bx > by:  # (4,0): prefer top
                    if t is not None:
                        v = (int(sum(t)) + 2) >> 2
                    elif l is not None:
                        v = (int(sum(l)) + 2) >> 2
                    else:
                        v = 128
                else:  # (0,4): prefer left
                    if l is not None:
                        v = (int(sum(l)) + 2) >> 2
                    elif t is not None:
                        v = (int(sum(t)) + 2) >> 2
                    else:
                        v = 128
                pred[by : by + 4, bx : bx + 4] = v
    elif mode == 1:  # Horizontal
        pred[:] = np.asarray(left, np.int32)[:, None]
    elif mode == 2:  # Vertical
        pred[:] = np.asarray(top, np.int32)[None, :]
    else:  # Plane
        H = sum((i + 1) * (top[4 + i] - (topleft if i == 3 else top[2 - i]))
                for i in range(4))
        V = sum((i + 1) * (left[4 + i] - (topleft if i == 3 else left[2 - i]))
                for i in range(4))
        a = 16 * (left[7] + top[7])
        b = (34 * H + 32) >> 6
        c = (34 * V + 32) >> 6
        xs = np.arange(8, dtype=np.int32)
        grid = a + b * (xs[None, :] - 3) + c * (xs[:, None] - 3) + 16
        pred[:] = np.clip(grid >> 5, 0, 255)
    return pred


# ---------------------------------------------------------------------------
# Inter prediction: quarter-pel luma / eighth-pel chroma interpolation (8.4.2.2)
# ---------------------------------------------------------------------------

def _six_h(a):
    return (a[:, :-5] - 5 * a[:, 1:-4] + 20 * a[:, 2:-3]
            + 20 * a[:, 3:-2] - 5 * a[:, 4:-1] + a[:, 5:])


def _six_v(a):
    return (a[:-5] - 5 * a[1:-4] + 20 * a[2:-3]
            + 20 * a[3:-2] - 5 * a[4:-1] + a[5:])


def _clip255(a):
    return np.clip(a, 0, 255)


def _mc_luma(refY: np.ndarray, x0: int, y0: int, w: int, h: int,
             mvx: int, mvy: int) -> np.ndarray:
    """Motion-compensated luma block (8.4.2.2.1), int32 result 0..255.
    Sample coordinates are clamped to the picture (the spec's Clip3 on
    xIntL/yIntL), implemented by clipped fancy-indexing."""
    H, W = refY.shape
    fx, fy = mvx & 3, mvy & 3
    ix, iy = x0 + (mvx >> 2), y0 + (mvy >> 2)
    rows = np.clip(np.arange(iy - 2, iy + h + 3), 0, H - 1)
    cols = np.clip(np.arange(ix - 2, ix + w + 3), 0, W - 1)
    ext = refY[np.ix_(rows, cols)].astype(np.int32)  # (h+5+1? ) -> (h+5, w+5)
    # ext covers rows iy-2 .. iy+h+2, cols ix-2 .. ix+w+2  (h+5, w+5)
    if fx == 0 and fy == 0:
        return ext[2 : 2 + h, 2 : 2 + w]
    G = ext[2 : 2 + h, 2 : 2 + w]
    out = None
    b = hh = j = None
    if fy == 0:
        b1 = _six_h(ext[2 : 2 + h])  # (h, w)
        b = (b1 + 16) >> 5
        b = _clip255(b)
        if fx == 1:
            out = (G + b + 1) >> 1
        elif fx == 2:
            out = b
        else:
            Hs = ext[2 : 2 + h, 3 : 3 + w]
            out = (Hs + b + 1) >> 1
        return out
    if fx == 0:
        h1 = _six_v(ext[:, 2 : 2 + w])  # (h, w)
        hh = _clip255((h1 + 16) >> 5)
        if fy == 1:
            out = (G + hh + 1) >> 1
        elif fy == 2:
            out = hh
        else:
            M = ext[3 : 3 + h, 2 : 2 + w]
            out = (M + hh + 1) >> 1
        return out
    # both fractional: need j and/or b/h/m/s
    b1_all = _six_h(ext)              # (h+5, w)    rows iy-2..iy+h+2
    h1_all = _six_v(ext)              # (h, w+5)    cols ix-2..ix+w+2
    j1 = _six_v(b1_all)               # (h, w)
    j = _clip255((j1 + 512) >> 10)
    if fx == 2 and fy == 2:
        return j
    b = _clip255((b1_all[2 : 2 + h] + 16) >> 5)          # at (x, y)
    s = _clip255((b1_all[3 : 3 + h] + 16) >> 5)          # b at y+1
    hh = _clip255((h1_all[:, 2 : 2 + w] + 16) >> 5)      # at (x, y)
    m = _clip255((h1_all[:, 3 : 3 + w] + 16) >> 5)       # h at x+1
    if fy == 1:
        if fx == 1:
            out = (b + hh + 1) >> 1      # e
        elif fx == 2:
            out = (b + j + 1) >> 1       # f
        else:
            out = (b + m + 1) >> 1       # g
    elif fy == 2:
        if fx == 1:
            out = (hh + j + 1) >> 1      # i
        else:
            out = (j + m + 1) >> 1       # k
    else:  # fy == 3
        if fx == 1:
            out = (hh + s + 1) >> 1      # p
        elif fx == 2:
            out = (j + s + 1) >> 1       # q
        else:
            out = (m + s + 1) >> 1       # r
    return out


def _mc_chroma(refC: np.ndarray, cx0: int, cy0: int, w: int, h: int,
               mvx: int, mvy: int) -> np.ndarray:
    """Motion-compensated chroma block (8.4.2.2.2), 1/8-pel bilinear."""
    H, W = refC.shape
    dx, dy = mvx & 7, mvy & 7
    ix, iy = cx0 + (mvx >> 3), cy0 + (mvy >> 3)
    rows = np.clip(np.arange(iy, iy + h + 1), 0, H - 1)
    cols = np.clip(np.arange(ix, ix + w + 1), 0, W - 1)
    A = refC[np.ix_(rows, cols)].astype(np.int32)
    return ((8 - dx) * (8 - dy) * A[:h, :w] + dx * (8 - dy) * A[:h, 1:]
            + (8 - dx) * dy * A[1:, :w] + dx * dy * A[1:, 1:] + 32) >> 6


def _median3(a, b, c):
    return a + b + c - min(a, b, c) - max(a, b, c)


# ---------------------------------------------------------------------------
# Decoded picture + decoder
# ---------------------------------------------------------------------------

# mb class codes
MB_I4, MB_I16, MB_IPCM, MB_I8, MB_P, MB_B = 0, 1, 2, 3, 4, 5


class _Picture:
    """One decoded frame with all the per-MB side state the decoder and
    the deblocking filter need."""

    def __init__(self, sps: SPS, pps: PPS):
        self.sps, self.pps = sps, pps
        w, h = sps.width, sps.height
        self.w, self.h = w, h
        self.mb_w, self.mb_h = w // 16, h // 16
        self.Y = np.zeros((h, w), np.uint8)
        self.U = np.zeros((h // 2, w // 2), np.uint8)
        self.V = np.zeros((h // 2, w // 2), np.uint8)
        n4w, n4h = self.mb_w * 4, self.mb_h * 4
        self.nnz_y = np.zeros((n4h, n4w), np.int32)
        self.nnz_c = np.zeros((2, n4h // 2, n4w // 2), np.int32)
        self.i4_modes = np.full((n4h, n4w), 2, np.int32)
        self.mb_slice = np.full((self.mb_h, self.mb_w), -1, np.int32)
        self.mb_class = np.zeros((self.mb_h, self.mb_w), np.int32)
        self.mb_qp = np.zeros((self.mb_h, self.mb_w), np.int32)
        self.mb_cbp = np.zeros((self.mb_h, self.mb_w), np.int32)
        # DC-coefficient presence (for deblock bS when nnz grids are AC-only)
        self.mb_dc_flag = np.zeros((self.mb_h, self.mb_w), np.int32)
        self.mb_tf8 = np.zeros((self.mb_h, self.mb_w), np.int32)
        # per-MB deblock parameters (from the slice header of the slice the
        # MB belongs to; 8.7: offsets/disable follow the *current* (q) MB)
        self.mb_alpha_off = np.zeros((self.mb_h, self.mb_w), np.int32)
        self.mb_beta_off = np.zeros((self.mb_h, self.mb_w), np.int32)
        self.mb_disable = np.zeros((self.mb_h, self.mb_w), np.int32)
        # per-4x4-block motion state (P/B): mv in quarter-pel, ref picture
        # identity per list (-1 = unused); bS=1 rule compares these
        self.mv = np.zeros((2, n4h, n4w, 2), np.int32)
        self.ref_id = np.full((2, n4h, n4w), -1, np.int64)
        self.ref_idx = np.full((2, n4h, n4w), -1, np.int32)
        # CABAC context state (coded_block_flag neighbours, skip/direct,
        # chroma mode, per-cell motion vector differences)
        self.cbf_y = np.zeros((n4h, n4w), np.int8)
        self.cbf_c = np.zeros((2, n4h // 2, n4w // 2), np.int8)
        self.mb_skip = np.zeros((self.mb_h, self.mb_w), np.int8)
        self.mb_chroma_mode = np.zeros((self.mb_h, self.mb_w), np.int8)
        self.mb_bdirect = np.zeros((self.mb_h, self.mb_w), np.int8)
        self.mvd = np.zeros((2, n4h, n4w, 2), np.int32)
        self.cell_direct = np.zeros((n4h, n4w), np.int8)
        # display metadata
        self.poc = 0
        self.field_poc = (0, 0)
        self.frame_num = 0
        self.is_ref = False
        self.is_idr = False
        self.qp_y = 0
        # reference management
        self.pic_id = -1          # unique decode counter (bS identity)
        self._epoch = 0
        self.long_term = False
        self.long_term_idx = -1
        self._mmco = ()
        self._long_term_ref_flag = 0

    def is_intra(self, mbx: int, mby: int) -> bool:
        return self.mb_class[mby, mbx] in (MB_I4, MB_I16, MB_IPCM, MB_I8)


class H264RefDecoder:
    """Annex B H.264 -> (Y, U, V) frames, display order."""

    def __init__(self):
        self.sps_map: dict[int, SPS] = {}
        self.pps_map: dict[int, PPS] = {}
        self.cur: _Picture | None = None
        self.cur_hdr: SliceHeader | None = None
        self._slice_counter = 0
        self._out: list[_Picture] = []      # pending display-order output
        self._emitted: list[_Picture] = []
        # POC state
        self._prev_poc_msb = 0
        self._prev_poc_lsb = 0
        self._prev_frame_num = 0
        self._prev_frame_num_offset = 0
        self._hold = 5  # display reorder hold-back depth
        # reference picture state (8.2.4 / 8.2.5)
        self.dpb: list[_Picture] = []
        self._pic_counter = 0
        self._max_long_term_idx = -1
        self._epoch = 0  # bumped per IDR: POC comparisons only valid within

    # -- public API --------------------------------------------------------

    def decode(self, es: bytes) -> list[tuple]:
        """Push Annex B bytes (whole NALs). Returns decoded frames ready
        for display as (Y, U, V, poc) tuples."""
        for nal in split_annexb(es):
            self._nal(nal)
        out = self._drain(self._hold)
        return out

    def flush(self) -> list[tuple]:
        self._finish_picture()
        return self._drain(0)

    # -- NAL dispatch ------------------------------------------------------

    def _nal(self, nal: bytes) -> None:
        if not nal:
            return
        hdr = nal[0]
        if hdr & 0x80:
            return  # forbidden_zero_bit set: corrupt
        ref_idc = (hdr >> 5) & 3
        typ = hdr & 0x1F
        if typ == 7:
            s = parse_sps(ebsp_to_rbsp(nal[1:]))
            self.sps_map[s.sps_id] = s
        elif typ == 8:
            p = parse_pps(ebsp_to_rbsp(nal[1:]), self.sps_map)
            self.pps_map[p.pps_id] = p
        elif typ in (1, 5):
            rbsp = ebsp_to_rbsp(nal[1:])
            h, sps, pps = parse_slice_header(rbsp, ref_idc, typ,
                                             self.sps_map, self.pps_map)
            self._decode_slice(rbsp, h, sps, pps)
        # SEI (6), AUD (9), filler etc: ignored for pixel decode

    # -- picture management ------------------------------------------------

    def _is_new_picture(self, h: SliceHeader) -> bool:
        if self.cur is None or self.cur_hdr is None:
            return True
        prev = self.cur_hdr
        if h.first_mb == 0:
            return True
        return (h.frame_num != prev.frame_num or h.pps_id != prev.pps_id
                or h.field_pic_flag != prev.field_pic_flag
                or h.idr != prev.idr)

    def _start_picture(self, h: SliceHeader, sps: SPS, pps: PPS) -> None:
        self._finish_picture()
        pic = _Picture(sps, pps)
        pic.frame_num = h.frame_num
        pic.is_ref = h.nal_ref_idc != 0
        pic.is_idr = h.idr
        top = self._compute_poc(h, sps)
        # BottomFieldOrderCnt (8.2.1): frame pictures carry both field
        # POCs; progressive streams have delta 0 so pic.poc is unchanged
        if sps.poc_type == 0:
            bottom = top + h.delta_poc_bottom
        elif sps.poc_type == 1:
            bottom = top + sps.offset_for_top_to_bottom_field + h.delta_poc[1]
        else:
            bottom = top
        pic.field_poc = (top, bottom)
        pic.poc = min(top, bottom)
        pic.pic_id = self._pic_counter
        self._pic_counter += 1
        if h.idr:
            self._epoch += 1
        pic._epoch = self._epoch
        pic._mmco = h.mmco
        pic._long_term_ref_flag = h.long_term_reference_flag
        self.cur = pic
        self._slice_counter = 0

    def _finish_picture(self) -> None:
        if getattr(self, "_paff_st", None) is not None or getattr(
                self, "_paff_pending", None) is not None:
            from . import h264_paff

            h264_paff.finalize_pending(self)
        self._finish_frame_picture()

    def _finish_frame_picture(self) -> None:
        if self.cur is None:
            return
        pic = self.cur
        self.cur = None
        self.cur_hdr = None
        self._deblock_picture(pic)
        self._mark_references(pic)
        self._out.append(pic)

    # -- reference marking (8.2.5) ----------------------------------------

    def _frame_num_wrap(self, p: _Picture, cur_frame_num: int, sps: SPS) -> int:
        max_fn = 1 << sps.log2_max_frame_num
        return p.frame_num - max_fn if p.frame_num > cur_frame_num else p.frame_num

    def _mark_references(self, pic: _Picture) -> None:
        if not pic.is_ref:
            return
        sps = pic.sps
        if pic.is_idr:
            self.dpb = []
            if pic._long_term_ref_flag:
                pic.long_term = True
                pic.long_term_idx = 0
                self._max_long_term_idx = 0
            else:
                self._max_long_term_idx = -1
            self.dpb.append(pic)
            return
        max_fn = 1 << sps.log2_max_frame_num
        if pic._mmco:
            cur_pn = pic.frame_num
            for op_vals in pic._mmco:
                op = op_vals[0]
                if op == 1:
                    pn = cur_pn - (op_vals[1] + 1)
                    self.dpb = [p for p in self.dpb if p.long_term or
                                self._frame_num_wrap(p, cur_pn, sps) != pn]
                elif op == 2:
                    self.dpb = [p for p in self.dpb
                                if not (p.long_term
                                        and p.long_term_idx == op_vals[1])]
                elif op == 3:
                    pn = cur_pn - (op_vals[1] + 1)
                    idx = op_vals[2]
                    self.dpb = [p for p in self.dpb
                                if not (p.long_term and p.long_term_idx == idx)]
                    for p in self.dpb:
                        if (not p.long_term
                                and self._frame_num_wrap(p, cur_pn, sps) == pn):
                            p.long_term = True
                            p.long_term_idx = idx
                elif op == 4:
                    self._max_long_term_idx = op_vals[1] - 1
                    self.dpb = [p for p in self.dpb if not p.long_term
                                or p.long_term_idx <= self._max_long_term_idx]
                elif op == 5:
                    self.dpb = []
                    self._max_long_term_idx = -1
                    pic.frame_num = 0
                    self._prev_frame_num = 0
                    self._prev_poc_msb = self._prev_poc_lsb = 0
                elif op == 6:
                    idx = op_vals[1]
                    self.dpb = [p for p in self.dpb
                                if not (p.long_term and p.long_term_idx == idx)]
                    pic.long_term = True
                    pic.long_term_idx = idx
        else:
            # sliding window
            while len(self.dpb) >= max(1, sps.max_num_ref_frames):
                sts = [p for p in self.dpb if not p.long_term]
                if not sts:
                    break
                victim = min(sts, key=lambda p: self._frame_num_wrap(
                    p, pic.frame_num, sps))
                self.dpb.remove(victim)
        self.dpb.append(pic)

    # -- reference list construction (8.2.4) --------------------------------

    def _build_ref_list_p(self, h: SliceHeader, sps: SPS) -> list:
        cur_pn = h.frame_num
        max_fn = 1 << sps.log2_max_frame_num
        shorts = sorted(
            [p for p in self.dpb if not p.long_term],
            key=lambda p: -self._frame_num_wrap(p, cur_pn, sps))
        longs = sorted([p for p in self.dpb if p.long_term],
                       key=lambda p: p.long_term_idx)
        lst = shorts + longs
        lst = self._modify_ref_list(lst, h.ref_list_mods[0], cur_pn, max_fn,
                                    h.num_ref_idx[0])
        return lst

    def _build_ref_lists_b(self, h: SliceHeader, sps: SPS, cur_poc: int):
        """RefPicList0/1 for B slices (8.2.4.2.3, frame coding)."""
        cur_pn = h.frame_num
        max_fn = 1 << sps.log2_max_frame_num
        shorts = [p for p in self.dpb if not p.long_term]
        longs = sorted([p for p in self.dpb if p.long_term],
                       key=lambda p: p.long_term_idx)
        before = sorted([p for p in shorts if p.poc < cur_poc],
                        key=lambda p: -p.poc)
        after = sorted([p for p in shorts if p.poc > cur_poc],
                       key=lambda p: p.poc)
        l0 = before + after + longs
        l1 = after + before + longs
        if len(l1) > 1 and l0 == l1:
            l1 = [l1[1], l1[0]] + l1[2:]
        l0 = self._modify_ref_list(l0, h.ref_list_mods[0], cur_pn, max_fn,
                                   h.num_ref_idx[0])
        l1 = self._modify_ref_list(l1, h.ref_list_mods[1], cur_pn, max_fn,
                                   h.num_ref_idx[1])
        return l0, l1

    def _modify_ref_list(self, lst, mods, cur_pn, max_fn, num_active):
        """8.2.4.3.1/.2 exactly: shift-insert at refIdxLX, then compact away
        later entries of the same picture within the working window.  A
        picture inserted twice by separate ops stays duplicated (x264
        weightp=2 relies on this to give one picture two weight sets)."""
        if not mods:
            return lst[:num_active]
        work = list(lst[:num_active])
        pred = cur_pn
        ref_idx = 0
        for op, val in mods:
            target = None
            if op in (0, 1):
                adp = val + 1
                if op == 0:
                    nw = pred - adp
                    if nw < 0:
                        nw += max_fn
                else:
                    nw = pred + adp
                    if nw >= max_fn:
                        nw -= max_fn
                pred = nw
                pn = nw - max_fn if nw > cur_pn else nw
                for p in self.dpb:
                    if not p.long_term and self._frame_num_wrap_h(
                            p, cur_pn, max_fn) == pn:
                        target = p
                        break
            else:  # op == 2: long-term
                for p in self.dpb:
                    if p.long_term and p.long_term_idx == val:
                        target = p
                        break
            if target is None:
                continue  # non-conformant; be tolerant
            work.insert(ref_idx, target)
            ref_idx += 1
            i = ref_idx
            while i < len(work):
                if work[i] is target:
                    del work[i]
                else:
                    i += 1
        return work[:num_active]

    @staticmethod
    def _frame_num_wrap_h(p: _Picture, cur_fn: int, max_fn: int) -> int:
        return p.frame_num - max_fn if p.frame_num > cur_fn else p.frame_num

    def _drain(self, hold: int) -> list[tuple]:
        out = []
        while len(self._out) > hold:
            # emit lowest-(epoch, POC) pending picture: POC only orders
            # pictures between IDRs (it resets at each IDR)
            k = min(range(len(self._out)),
                    key=lambda i: (self._out[i]._epoch, self._out[i].poc))
            pic = self._out.pop(k)
            out.append((pic.Y, pic.U, pic.V, pic.poc))
        return out

    def _compute_poc(self, h: SliceHeader, sps: SPS) -> int:
        if sps.poc_type == 0:
            max_lsb = 1 << sps.log2_max_poc_lsb
            if h.idr:
                self._prev_poc_msb = 0
                self._prev_poc_lsb = 0
            lsb = h.poc_lsb
            if lsb < self._prev_poc_lsb and self._prev_poc_lsb - lsb >= max_lsb // 2:
                msb = self._prev_poc_msb + max_lsb
            elif lsb > self._prev_poc_lsb and lsb - self._prev_poc_lsb > max_lsb // 2:
                msb = self._prev_poc_msb - max_lsb
            else:
                msb = self._prev_poc_msb
            if h.nal_ref_idc:
                self._prev_poc_msb, self._prev_poc_lsb = msb, lsb
            return msb + lsb  # TopFieldOrderCnt (frames: use top)
        if sps.poc_type == 2:
            if h.idr:
                self._prev_frame_num_offset = 0
                off = 0
            else:
                max_fn = 1 << sps.log2_max_frame_num
                off = self._prev_frame_num_offset
                if h.frame_num < self._prev_frame_num:
                    off += max_fn
                self._prev_frame_num_offset = off
            self._prev_frame_num = h.frame_num
            n = off + h.frame_num
            return 2 * n - (0 if h.nal_ref_idc else 1)
        # poc_type 1
        if h.idr:
            self._prev_frame_num_offset = 0
            off = 0
        else:
            max_fn = 1 << sps.log2_max_frame_num
            off = self._prev_frame_num_offset
            if h.frame_num < self._prev_frame_num:
                off += max_fn
            self._prev_frame_num_offset = off
        self._prev_frame_num = h.frame_num
        abs_frame_num = off + h.frame_num
        if not h.nal_ref_idc and abs_frame_num > 0:
            abs_frame_num -= 1
        ncyc = len(sps.offset_for_ref_frame)
        expected = 0
        if abs_frame_num > 0 and ncyc:
            cycle_sum = sum(sps.offset_for_ref_frame)
            pic_order_cycle_cnt = (abs_frame_num - 1) // ncyc
            frame_num_in_cycle = (abs_frame_num - 1) % ncyc
            expected = pic_order_cycle_cnt * cycle_sum + sum(
                sps.offset_for_ref_frame[: frame_num_in_cycle + 1])
        if not h.nal_ref_idc:
            expected += sps.offset_for_non_ref_pic
        return expected + h.delta_poc[0]

    # -- slice decode ------------------------------------------------------

    def _decode_slice(self, rbsp: bytes, h: SliceHeader, sps: SPS, pps: PPS) -> None:
        if h.slice_type not in (SLICE_I, SLICE_P, SLICE_B):
            raise NotImplementedError("SP/SI slices not supported")
        if h.field_pic_flag:
            from . import h264_paff

            self._finish_frame_picture()  # close a pending FRAME picture
            h264_paff.decode_field_slice(self, rbsp, h, sps, pps)
            return
        if self._is_new_picture(h):
            self._start_picture(h, sps, pps)
        self.cur_hdr = h
        self._slice_counter += 1
        if sps.mb_adaptive_frame_field:
            from . import h264_mbaff

            sl = h264_mbaff.MbaffSlice(self, self.cur, h, sps, pps,
                                       self._slice_counter)
            if h.slice_type == SLICE_P:
                sl.ref_l0 = self._build_ref_list_p(h, sps)
            elif h.slice_type == SLICE_B:
                sl.ref_l0, sl.ref_l1 = self._build_ref_lists_b(
                    h, sps, self.cur.poc)
            if pps.entropy_coding_mode:
                sl.decode_cabac(rbsp)
            else:
                sl.decode_cavlc(BitReader(rbsp, h.data_bit_pos))
            return
        pic = self.cur
        ctx = _SliceCtx(pic, h, sps, pps, self._slice_counter)
        if h.slice_type == SLICE_P:
            ctx.ref_l0 = self._build_ref_list_p(h, sps)
        elif h.slice_type == SLICE_B:
            ctx.ref_l0, ctx.ref_l1 = self._build_ref_lists_b(h, sps, pic.poc)
        run_slice_data(ctx, rbsp, h, pic, pps)

    # -- deblocking (8.7) --------------------------------------------------

    def _deblock_picture(self, pic: _Picture) -> None:
        if getattr(pic, "mbaff", None) is not None:
            from . import h264_mbaff

            h264_mbaff.deblock_picture_mbaff(pic)
            return
        for mby in range(pic.mb_h):
            for mbx in range(pic.mb_w):
                if pic.mb_slice[mby, mbx] < 0:
                    continue
                if pic.mb_disable[mby, mbx] == 1:
                    continue
                _deblock_mb(pic, mbx, mby)


def run_slice_data(ctx, rbsp: bytes, h: SliceHeader, pic, pps: PPS) -> None:
    """Drive the slice-data loop (7.3.4, non-MBAFF) over a picture —
    frame pictures and PAFF field pictures alike."""
    if pps.entropy_coding_mode:
        from . import h264_cabac
        cb = h264_cabac.CabacSlice(ctx, rbsp, h)
        n_mbs = pic.mb_w * pic.mb_h
        mb_idx = h.first_mb
        while mb_idx < n_mbs:
            mbx, mby = mb_idx % pic.mb_w, mb_idx // pic.mb_w
            if (h.slice_type in (SLICE_P, SLICE_B)
                    and cb.mb_skip_flag(mbx, mby)):
                ctx.decode_skip_mb(mb_idx)
                pic.mb_skip[mby, mbx] = 1
                if h.slice_type == SLICE_B:
                    pic.mb_bdirect[mby, mbx] = 1
                cb.prev_qp_delta_nz = 0
            else:
                ctx.decode_mb_cabac(cb, mb_idx)
            mb_idx += 1
            if cb.end_of_slice():
                break
        return
    r = BitReader(rbsp, h.data_bit_pos)
    n_mbs = pic.mb_w * pic.mb_h
    mb_idx = h.first_mb
    if h.slice_type == SLICE_I:
        while mb_idx < n_mbs:
            ctx.decode_mb_cavlc(r, mb_idx)
            mb_idx += 1
            if not _more_rbsp_data(r):
                break
        return
    more = True
    while more and mb_idx < n_mbs:
        skip_run = r.ue()
        for _ in range(skip_run):
            if mb_idx >= n_mbs:
                break
            ctx.decode_skip_mb(mb_idx)
            mb_idx += 1
        more = _more_rbsp_data(r)
        if more and mb_idx < n_mbs:
            ctx.decode_mb_cavlc(r, mb_idx)
            mb_idx += 1
            more = _more_rbsp_data(r)


# ---------------------------------------------------------------------------
# Deblocking filter (8.7) — in-place, MB raster order, vertical edges then
# horizontal, using already-filtered neighbour samples (normative order).
# ---------------------------------------------------------------------------

def _bs_mv(pic: _Picture, gxp, gyp, gxq, gyq) -> int:
    """bS in {0, 1} from motion (8.7.2.1, both blocks inter, no coeffs).
    Field pictures use the 2-quarter-field vertical threshold."""
    vth = 2 if getattr(pic, "is_field_pic", False) else 4
    up = []
    uq = []
    for l in range(2):
        rp = int(pic.ref_id[l, gyp, gxp])
        if rp >= 0:
            up.append((rp, (int(pic.mv[l, gyp, gxp, 0]),
                            int(pic.mv[l, gyp, gxp, 1]))))
        rq = int(pic.ref_id[l, gyq, gxq])
        if rq >= 0:
            uq.append((rq, (int(pic.mv[l, gyq, gxq, 0]),
                            int(pic.mv[l, gyq, gxq, 1]))))
    if len(up) != len(uq):
        return 1
    if sorted(r for r, _ in up) != sorted(r for r, _ in uq):
        return 1

    def far(a, b):
        return abs(a[0] - b[0]) >= 4 or abs(a[1] - b[1]) >= vth

    if len(up) == 1:
        return 1 if far(up[0][1], uq[0][1]) else 0
    if len(up) == 0:
        return 0
    if up[0][0] != up[1][0]:
        for r, mv in up:
            mv2 = next(m for rr, m in uq if rr == r)
            if far(mv, mv2):
                return 1
        return 0
    # both predictions from the same picture: near under either assignment
    a = not far(up[0][1], uq[0][1]) and not far(up[1][1], uq[1][1])
    b = not far(up[0][1], uq[1][1]) and not far(up[1][1], uq[0][1])
    return 0 if (a or b) else 1


def _nnz_for_bs(pic: _Picture, gx: int, gy: int) -> int:
    """Coefficient presence for bS: with the 8x8 transform, a 4x4 cell is
    'coded' when its covering 8x8 transform block has any coefficients."""
    mbx, mby = gx >> 2, gy >> 2
    if pic.mb_tf8[mby, mbx]:
        x0 = (gx & ~1)
        y0 = (gy & ~1)
        return int(pic.nnz_y[y0 : y0 + 2, x0 : x0 + 2].sum())
    return int(pic.nnz_y[gy, gx])


def _bs(pic: _Picture, gxp, gyp, gxq, gyq, mb_edge: bool,
        vertical: bool = True) -> int:
    pmbx, pmby = gxp >> 2, gyp >> 2
    qmbx, qmby = gxq >> 2, gyq >> 2
    field = getattr(pic, "is_field_pic", False)
    if pic.is_intra(pmbx, pmby) or pic.is_intra(qmbx, qmby):
        # field pictures: bS 4 only on vertical MB edges (8.7.2.1)
        return 4 if (mb_edge and (vertical or not field)) else 3
    if _nnz_for_bs(pic, gxp, gyp) or _nnz_for_bs(pic, gxq, gyq):
        return 2
    return _bs_mv(pic, gxp, gyp, gxq, gyq)


def _deblock_line(plane, y, x, dy, dx, bs, alpha, beta, tc0, luma) -> None:
    """Filter one sample line across an edge. (y, x) = q0 position;
    (dy, dx) = step towards q3 (p samples lie in the opposite direction)."""
    p0 = int(plane[y - dy, x - dx])
    p1 = int(plane[y - 2 * dy, x - 2 * dx])
    p2 = int(plane[y - 3 * dy, x - 3 * dx])
    q0 = int(plane[y, x])
    q1 = int(plane[y + dy, x + dx])
    q2 = int(plane[y + 2 * dy, x + 2 * dx])
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or abs(q1 - q0) >= beta:
        return
    ap = abs(p2 - p0)
    aq = abs(q2 - q0)
    if bs < 4:
        if luma:
            tc = tc0 + (1 if ap < beta else 0) + (1 if aq < beta else 0)
        else:
            tc = tc0 + 1
        delta = (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3
        delta = -tc if delta < -tc else tc if delta > tc else delta
        plane[y - dy, x - dx] = _clip1(p0 + delta)
        plane[y, x] = _clip1(q0 - delta)
        if luma and ap < beta:
            d = (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1
            d = -tc0 if d < -tc0 else tc0 if d > tc0 else d
            plane[y - 2 * dy, x - 2 * dx] = p1 + d
        if luma and aq < beta:
            d = (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1
            d = -tc0 if d < -tc0 else tc0 if d > tc0 else d
            plane[y + dy, x + dx] = q1 + d
    else:
        if luma:
            strong = abs(p0 - q0) < (alpha >> 2) + 2
            if strong and ap < beta:
                p3 = int(plane[y - 4 * dy, x - 4 * dx])
                plane[y - dy, x - dx] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
                plane[y - 2 * dy, x - 2 * dx] = (p2 + p1 + p0 + q0 + 2) >> 2
                plane[y - 3 * dy, x - 3 * dx] = (
                    2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
            else:
                plane[y - dy, x - dx] = (2 * p1 + p0 + q1 + 2) >> 2
            if strong and aq < beta:
                q3 = int(plane[y + 3 * dy, x + 3 * dx])
                plane[y, x] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
                plane[y + dy, x + dx] = (q2 + q1 + q0 + p0 + 2) >> 2
                plane[y + 2 * dy, x + 2 * dx] = (
                    2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
            else:
                plane[y, x] = (2 * q1 + q0 + p1 + 2) >> 2
        else:
            plane[y - dy, x - dx] = (2 * p1 + p0 + q1 + 2) >> 2
            plane[y, x] = (2 * q1 + q0 + p1 + 2) >> 2


def _edge_bs_and_qp(pic: _Picture, mbx, mby, e, vertical):
    """Per-4-sample-segment (bS, indexA inputs) for one luma edge."""
    out = []
    for seg in range(4):
        if vertical:
            gxq, gyq = mbx * 4 + e, mby * 4 + seg
            gxp, gyp = gxq - 1, gyq
        else:
            gxq, gyq = mbx * 4 + seg, mby * 4 + e
            gxp, gyp = gxq, gyq - 1
        bs = _bs(pic, gxp, gyp, gxq, gyq, e == 0, vertical)
        qpp = int(pic.mb_qp[gyp >> 2, gxp >> 2])
        qpq = int(pic.mb_qp[gyq >> 2, gxq >> 2])
        out.append((bs, qpp, qpq))
    return out


def _deblock_mb(pic: _Picture, mbx, mby) -> None:
    aoff = int(pic.mb_alpha_off[mby, mbx])
    boff = int(pic.mb_beta_off[mby, mbx])
    disable = int(pic.mb_disable[mby, mbx])
    tf8 = int(pic.mb_tf8[mby, mbx])
    sid = int(pic.mb_slice[mby, mbx])
    pps = pic.pps
    coff = (pps.chroma_qp_index_offset, pps.second_chroma_qp_index_offset)

    def thresholds(qpp, qpq, bs, chroma_comp=None):
        if chroma_comp is None:
            qav = (qpp + qpq + 1) >> 1
        else:
            qav = (chroma_qp(qpp, coff[chroma_comp])
                   + chroma_qp(qpq, coff[chroma_comp]) + 1) >> 1
        ia = min(51, max(0, qav + aoff))
        ib = min(51, max(0, qav + boff))
        alpha = T.DEBLOCK_ALPHA[ia]
        beta = T.DEBLOCK_BETA[ib]
        tc0 = T.DEBLOCK_TC0[bs - 1][ia] if bs < 4 else 0
        return alpha, beta, tc0

    for vertical in (True, False):
        for e in range(4):
            if e == 0:
                nmbx, nmby = (mbx - 1, mby) if vertical else (mbx, mby - 1)
                if nmbx < 0 or nmby < 0:
                    continue
                if pic.mb_slice[nmby, nmbx] < 0:
                    continue
                if disable == 2 and pic.mb_slice[nmby, nmbx] != sid:
                    continue
            elif tf8 and (e & 1):
                continue
            segs = _edge_bs_and_qp(pic, mbx, mby, e, vertical)
            # luma
            for seg, (bs, qpp, qpq) in enumerate(segs):
                if bs == 0:
                    continue
                alpha, beta, tc0 = thresholds(qpp, qpq, bs)
                if alpha == 0 or beta == 0:
                    continue
                for i in range(4):
                    if vertical:
                        _deblock_line(pic.Y, mby * 16 + seg * 4 + i,
                                      mbx * 16 + e * 4, 0, 1, bs, alpha, beta,
                                      tc0, True)
                    else:
                        _deblock_line(pic.Y, mby * 16 + e * 4,
                                      mbx * 16 + seg * 4 + i, 1, 0, bs, alpha,
                                      beta, tc0, True)
            # chroma (4:2:0): luma edges 0 and 2 only
            if e in (0, 2):
                for comp, plane in ((0, pic.U), (1, pic.V)):
                    for seg, (bs, qpp, qpq) in enumerate(segs):
                        if bs == 0:
                            continue
                        alpha, beta, tc0 = thresholds(qpp, qpq, bs, comp)
                        if alpha == 0 or beta == 0:
                            continue
                        for i in range(2):
                            if vertical:
                                _deblock_line(plane, mby * 8 + seg * 2 + i,
                                              mbx * 8 + e * 2, 0, 1, bs,
                                              alpha, beta, tc0, False)
                            else:
                                _deblock_line(plane, mby * 8 + e * 2,
                                              mbx * 8 + seg * 2 + i, 1, 0, bs,
                                              alpha, beta, tc0, False)


class _SliceCtx:
    """Per-slice decode state + MB decode/reconstruction."""

    def __init__(self, pic: _Picture, h: SliceHeader, sps: SPS, pps: PPS,
                 slice_id: int):
        self.pic, self.h, self.sps, self.pps = pic, h, sps, pps
        self.sid = slice_id
        self.qp = h.slice_qp
        # resolved raster-order scaling weights (lists 0..5 4x4, 6..7 8x8)
        mats = pps.scaling_matrix
        if mats is None:
            self.w4 = [_FLAT16] * 6
            self.w8 = [_FLAT64] * 2
        else:
            self.w4 = [tuple(_zz_to_raster(mats[i], 16)) for i in range(6)]
            if len(mats) > 6:
                self.w8 = [tuple(_zz_to_raster(mats[i], 64)) for i in (6, 7)]
            else:
                self.w8 = [_FLAT64] * 2
        self._dequant_cache: dict = {}
        # field pictures (PAFF) use the field residual scans
        if getattr(pic, "is_field_pic", False):
            self.scan4 = FIELD_SCAN_4x4
            self.scan8 = FIELD_SCAN_8x8
        else:
            self.scan4 = ZIGZAG_4x4
            self.scan8 = ZIGZAG_8x8
        self.ref_l0: list[_Picture] = []
        self.ref_l1: list[_Picture] = []
        self._cur_mbx = self._cur_mby = 0
        self._cur_z = 0
        self._pred_chroma = None  # (U 8x8, V 8x8) int32 for inter recon
        self._direct_cache = None  # per-MB spatial-direct MB-level state

    # -- availability helpers ---------------------------------------------

    def _mb_avail(self, mbx: int, mby: int) -> bool:
        pic = self.pic
        if mbx < 0 or mby < 0 or mbx >= pic.mb_w or mby >= pic.mb_h:
            return False
        return pic.mb_slice[mby, mbx] == self.sid

    def _mb_avail_intra(self, mbx: int, mby: int) -> bool:
        if not self._mb_avail(mbx, mby):
            return False
        if self.pps.constrained_intra_pred and not self.pic.is_intra(mbx, mby):
            return False
        return True

    def _blk_avail_intra(self, gx: int, gy: int, cur_z: int,
                         cur_mbx: int, cur_mby: int) -> bool:
        """Availability of the luma 4x4 block at global 4x4 coords (gx,gy)
        for intra prediction from the block cur_z of MB (cur_mbx,cur_mby)."""
        if gx < 0 or gy < 0:
            return False
        mbx, mby = gx >> 2, gy >> 2
        if mbx == cur_mbx and mby == cur_mby:
            return _XY_TO_Z[(gx & 3, gy & 3)] < cur_z
        if not self._mb_avail_intra(mbx, mby):
            return False
        # different MB: must precede in decode (raster) order
        return mby < cur_mby or (mby == cur_mby and mbx < cur_mbx)

    # -- nC (9.2.1) --------------------------------------------------------

    def _nnz_luma(self, gx: int, gy: int):
        pic = self.pic
        if gx < 0 or gy < 0 or gx >= pic.mb_w * 4 or gy >= pic.mb_h * 4:
            return None
        if pic.mb_slice[gy >> 2, gx >> 2] != self.sid:
            return None
        return int(pic.nnz_y[gy, gx])

    def _nnz_chroma(self, comp: int, cx: int, cy: int):
        pic = self.pic
        if cx < 0 or cy < 0 or cx >= pic.mb_w * 2 or cy >= pic.mb_h * 2:
            return None
        if pic.mb_slice[cy >> 1, cx >> 1] != self.sid:
            return None
        return int(pic.nnz_c[comp, cy, cx])

    @staticmethod
    def _combine_nc(na, nb) -> int:
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    # -- dequant -----------------------------------------------------------

    def _dq4(self, qp: int, list_idx: int):
        key = (qp, list_idx)
        t = self._dequant_cache.get(key)
        if t is None:
            t = _dequant4_tab(qp, self.w4[list_idx])
            self._dequant_cache[key] = t
        return t

    def _dq8(self, qp: int, list_idx: int):
        key = (qp, 8, list_idx)
        t = self._dequant_cache.get(key)
        if t is None:
            t = _dequant8_tab(qp, self.w8[list_idx])
            self._dequant_cache[key] = t
        return t

    def _parse_luma8x8_cavlc(self, r: BitReader, b: int):
        """Four interleaved 4x4 CAVLC blocks -> 64 coeffs in 8x8 scan order
        (coeff k of 4x4 sub-block i lands at scan 4k+i).  Per-4x4 nnz
        bookkeeping; nC neighbours only ever read odd-x / odd-y cells so
        the per-sub counts are what both sides observe."""
        pic = self.pic
        mbx, mby = self._cur_mbx, self._cur_mby
        gx0, gy0 = mbx * 4, mby * 4
        scan64 = [0] * 64
        for i in range(4):
            z = 4 * b + i
            x4, y4 = _Z_TO_XY[z]
            gx, gy = gx0 + x4, gy0 + y4
            nc = self._combine_nc(self._nnz_luma(gx - 1, gy),
                                  self._nnz_luma(gx, gy - 1))
            blk, tc = _cavlc_block(r, nc, 16)
            pic.nnz_y[gy, gx] = tc
            for k in range(16):
                scan64[4 * k + i] = blk[k]
        return scan64

    def _residual8x8(self, scan64, qp: int, list_idx: int):
        """Dequant + inverse 8x8 transform -> 64 raster residuals."""
        ls = self._dq8(qp, list_idx)
        d = [0] * 64
        for s in range(64):
            c = scan64[s]
            if c:
                pos = self.scan8[s]
                d[pos] = _dequant8_apply(c, ls[pos], qp)
        return _idct8x8(d)

    # -- MB decode ---------------------------------------------------------

    def _mark_mb(self, mbx: int, mby: int) -> None:
        pic, h = self.pic, self.h
        pic.mb_slice[mby, mbx] = self.sid
        pic.mb_alpha_off[mby, mbx] = h.slice_alpha_c0_offset_div2 * 2
        pic.mb_beta_off[mby, mbx] = h.slice_beta_offset_div2 * 2
        pic.mb_disable[mby, mbx] = h.disable_deblocking_filter_idc

    def decode_mb_cavlc(self, r: BitReader, mb_idx: int) -> None:
        pic = self.pic
        mbx, mby = mb_idx % pic.mb_w, mb_idx // pic.mb_w
        self._mark_mb(mbx, mby)
        mb_type = r.ue()
        if self.h.slice_type == SLICE_P:
            if mb_type < 5:
                self._decode_p_mb(r, mbx, mby, mb_type)
            else:
                self._decode_intra_mb(r, mbx, mby, mb_type - 5)
            return
        if self.h.slice_type == SLICE_B:
            if mb_type < 23:
                self._decode_b_mb(r, mbx, mby, mb_type)
            else:
                self._decode_intra_mb(r, mbx, mby, mb_type - 23)
            return
        # I-slice mb_type: 0 I_NxN, 1..24 I_16x16, 25 I_PCM
        self._decode_intra_mb(r, mbx, mby, mb_type)

    # -- CABAC macroblock layer (entropy parse via h264_cabac.CabacSlice,
    #    reconstruction shared with the CAVLC path) -------------------------

    def decode_mb_cabac(self, cb, mb_idx: int) -> None:
        pic = self.pic
        mbx, mby = mb_idx % pic.mb_w, mb_idx // pic.mb_w
        self._mark_mb(mbx, mby)
        self._cur_mbx, self._cur_mby = mbx, mby
        self._cur_z = 0
        st = self.h.slice_type
        if st == SLICE_P:
            mb_type = cb.mb_type_p(mbx, mby)
            if mb_type < 5:
                self._decode_p_mb_cabac(cb, mbx, mby, mb_type)
            else:
                self._decode_intra_mb_cabac(cb, mbx, mby, mb_type - 5)
        elif st == SLICE_B:
            mb_type = cb.mb_type_b(mbx, mby)
            if mb_type < 23:
                self._decode_b_mb_cabac(cb, mbx, mby, mb_type)
            else:
                self._decode_intra_mb_cabac(cb, mbx, mby, mb_type - 23)
        else:
            mb_type = cb.mb_type_i(mbx, mby)
            self._decode_intra_mb_cabac(cb, mbx, mby, mb_type)

    def _decode_intra_mb_cabac(self, cb, mbx, mby, imb: int) -> None:
        pic = self.pic
        if imb == 25:
            self._decode_ipcm_cabac(cb, mbx, mby)
            return
        if imb == 0:
            tf8 = 0
            if self.pps.transform_8x8_mode:
                tf8 = cb.transform_size_8x8(mbx, mby)
            if tf8:
                self._decode_i8x8_cabac(cb, mbx, mby)
            else:
                self._decode_i4x4_cabac(cb, mbx, mby)
            return
        self._decode_i16_cabac(cb, mbx, mby, imb - 1)

    def _decode_ipcm_cabac(self, cb, mbx, mby) -> None:
        pic = self.pic
        e = cb.e
        if e.pos & 7:
            e.pos += 8 - (e.pos & 7)
        y0, x0 = mby * 16, mbx * 16
        data = e.data
        p = e.pos >> 3
        for yy in range(16):
            for xx in range(16):
                pic.Y[y0 + yy, x0 + xx] = data[p]
                p += 1
        for plane in (pic.U, pic.V):
            for yy in range(8):
                for xx in range(8):
                    plane[mby * 8 + yy, mbx * 8 + xx] = data[p]
                    p += 1
        e.pos = p << 3
        # re-initialise the arithmetic engine (9.3.1.2)
        e.range_ = 510
        off = 0
        for _ in range(9):
            off = (off << 1) | e._bit()
        e.offset = off
        pic.mb_class[mby, mbx] = MB_IPCM
        pic.nnz_y[mby * 4 : mby * 4 + 4, mbx * 4 : mbx * 4 + 4] = 16
        pic.cbf_y[mby * 4 : mby * 4 + 4, mbx * 4 : mbx * 4 + 4] = 1
        pic.nnz_c[:, mby * 2 : mby * 2 + 2, mbx * 2 : mbx * 2 + 2] = 16
        pic.cbf_c[:, mby * 2 : mby * 2 + 2, mbx * 2 : mbx * 2 + 2] = 1
        pic.mb_qp[mby, mbx] = 0
        pic.mb_cbp[mby, mbx] = 0x2F
        cb.prev_qp_delta_nz = 0

    def _qp_delta_cabac(self, cb, mbx, mby, cbp: int, always: bool) -> None:
        pic = self.pic
        if cbp or always:
            self.qp = (self.qp + cb.mb_qp_delta() + 52) % 52
        else:
            cb.prev_qp_delta_nz = 0
        pic.mb_qp[mby, mbx] = self.qp
        pic.mb_cbp[mby, mbx] = cbp

    def _luma4_residual_cabac(self, cb, k: int, cat: int):
        """Parse one luma 4x4 residual (cat 1 or 2) with cbf/nnz updates."""
        pic = self.pic
        x4, y4 = _Z_TO_XY[k]
        gx = self._cur_mbx * 4 + x4
        gy = self._cur_mby * 4 + y4
        blk = cb.residual(cat, 15 if cat == 1 else 16, (gx, gy))
        if blk is None:
            pic.cbf_y[gy, gx] = 0
            pic.nnz_y[gy, gx] = 0
            return None
        pic.cbf_y[gy, gx] = 1
        pic.nnz_y[gy, gx] = sum(1 for c in blk if c)
        return blk

    def _decode_i4x4_cabac(self, cb, mbx, mby) -> None:
        pic = self.pic
        pic.mb_class[mby, mbx] = MB_I4
        modes = [2] * 16
        gx0, gy0 = mbx * 4, mby * 4
        for k in range(16):
            x4, y4 = _Z_TO_XY[k]
            gx, gy = gx0 + x4, gy0 + y4
            ma = self._i4_mode_at(gx - 1, gy, k, mbx, mby)
            mb_ = self._i4_mode_at(gx, gy - 1, k, mbx, mby)
            pred = 2 if (ma is None or mb_ is None) else min(ma, mb_)
            mode = cb.intra_pred_mode(pred)
            modes[k] = mode
            pic.i4_modes[gy, gx] = mode
        chroma_mode = cb.chroma_pred_mode(mbx, mby)
        pic.mb_chroma_mode[mby, mbx] = chroma_mode
        cbp = cb.cbp(mbx, mby)
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        self._qp_delta_cabac(cb, mbx, mby, cbp, False)
        coeffs = [None] * 16
        for k in range(16):
            if cbp_luma & (1 << (k >> 2)):
                coeffs[k] = self._luma4_residual_cabac(cb, k, 2)
        for k in range(16):
            self._recon_i4_block(mbx, mby, k, modes[k], coeffs[k])
        self._decode_chroma_cabac(cb, mbx, mby, chroma_mode, cbp_chroma, True)

    def _decode_i8x8_cabac(self, cb, mbx, mby) -> None:
        pic = self.pic
        pic.mb_class[mby, mbx] = MB_I8
        pic.mb_tf8[mby, mbx] = 1
        modes = [2] * 4
        gx0, gy0 = mbx * 4, mby * 4
        for b in range(4):
            bx, by = (b & 1) * 2, (b >> 1) * 2
            gx, gy = gx0 + bx, gy0 + by
            z = _XY_TO_Z[(bx, by)]
            ma = self._i4_mode_at(gx - 1, gy, z, mbx, mby)
            mb_ = self._i4_mode_at(gx, gy - 1, z, mbx, mby)
            pred = 2 if (ma is None or mb_ is None) else min(ma, mb_)
            mode = cb.intra_pred_mode(pred)
            modes[b] = mode
            pic.i4_modes[gy : gy + 2, gx : gx + 2] = mode
        chroma_mode = cb.chroma_pred_mode(mbx, mby)
        pic.mb_chroma_mode[mby, mbx] = chroma_mode
        cbp = cb.cbp(mbx, mby)
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        self._qp_delta_cabac(cb, mbx, mby, cbp, False)
        coeffs = [None] * 4
        for b in range(4):
            bx, by = (b & 1) * 2, (b >> 1) * 2
            if cbp_luma & (1 << b):
                blk = cb.residual(5, 64)
                coeffs[b] = blk
                nz = sum(1 for c in blk if c)
                pic.cbf_y[gy0 + by : gy0 + by + 2, gx0 + bx : gx0 + bx + 2] = 1
                pic.nnz_y[gy0 + by : gy0 + by + 2, gx0 + bx : gx0 + bx + 2] = nz
        for b in range(4):
            self._recon_i8_block(mbx, mby, b, modes[b], coeffs[b])
        self._decode_chroma_cabac(cb, mbx, mby, chroma_mode, cbp_chroma, True)

    def _decode_i16_cabac(self, cb, mbx, mby, k: int) -> None:
        pic = self.pic
        pred_mode = k % 4
        cbp_chroma = (k // 4) % 3
        cbp_luma = 15 if k >= 12 else 0
        pic.mb_class[mby, mbx] = MB_I16
        chroma_mode = cb.chroma_pred_mode(mbx, mby)
        pic.mb_chroma_mode[mby, mbx] = chroma_mode
        self._qp_delta_cabac(cb, mbx, mby, cbp_luma | (cbp_chroma << 4), True)
        dc = cb.residual(0, 16, None)
        if dc is not None:
            pic.mb_dc_flag[mby, mbx] |= 1
        dc_scan = dc if dc is not None else [0] * 16
        coeffs = [None] * 16
        if cbp_luma:
            for kk in range(16):
                coeffs[kk] = self._luma4_residual_cabac(cb, kk, 1)
        self._recon_i16(mbx, mby, pred_mode, dc_scan, coeffs)
        self._decode_chroma_cabac(cb, mbx, mby, chroma_mode, cbp_chroma, True)

    def _decode_chroma_cabac(self, cb, mbx, mby, chroma_mode, cbp_chroma,
                             intra: bool) -> None:
        pic = self.pic
        dc_scan = [[0] * 4, [0] * 4]
        coeffs = [[None] * 4 for _ in range(2)]
        if cbp_chroma:
            for comp in range(2):
                blk = cb.residual(3, 4, comp)
                if blk is not None:
                    dc_scan[comp] = blk
                    pic.mb_dc_flag[mby, mbx] |= 2 << comp
        if cbp_chroma & 2:
            for comp in range(2):
                for b in range(4):
                    cx = mbx * 2 + (b & 1)
                    cy = mby * 2 + (b >> 1)
                    blk = cb.residual(4, 15, (comp, cx, cy))
                    coeffs[comp][b] = blk
                    if blk is None:
                        pic.cbf_c[comp, cy, cx] = 0
                        pic.nnz_c[comp, cy, cx] = 0
                    else:
                        pic.cbf_c[comp, cy, cx] = 1
                        pic.nnz_c[comp, cy, cx] = sum(1 for c in blk if c)
        self._recon_chroma(mbx, mby, chroma_mode, dc_scan, coeffs, intra)

    def _store_part_mvd(self, bx4, by4, w4, h4, l, mvdx, mvdy) -> None:
        pic = self.pic
        gx0 = self._cur_mbx * 4 + bx4
        gy0 = self._cur_mby * 4 + by4
        pic.mvd[l, gy0 : gy0 + h4, gx0 : gx0 + w4] = (mvdx, mvdy)

    def _part_motion_cabac(self, cb, l, bx4, by4, w4, h4, ref_idx,
                           kind="", part_i=0):
        """Parse mvd (CABAC ctx uses stored neighbour mvds), derive and
        store mv + mvd for one partition; returns the mv."""
        self._cur_z = _XY_TO_Z[(bx4, by4)]
        mvdx = cb.mvd(l, bx4, by4, 0)
        mvdy = cb.mvd(l, bx4, by4, 1)
        px, py = self._mv_pred(bx4, by4, w4, h4, ref_idx, kind, part_i, l)
        mv = (px + mvdx, py + mvdy)
        refs = (self.ref_l0, self.ref_l1)[l]
        self._store_part_mv(bx4, by4, w4, h4, ref_idx, refs[ref_idx],
                            mv[0], mv[1], l)
        self._store_part_mvd(bx4, by4, w4, h4, l, mvdx, mvdy)
        return mv

    def _decode_p_mb_cabac(self, cb, mbx, mby, mb_type: int) -> None:
        pic = self.pic
        pic.mb_class[mby, mbx] = MB_P
        n0 = self.h.num_ref_idx[0]
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        gx0, gy0 = mbx * 4, mby * 4
        if mb_type in (0, 1, 2):
            kind, parts = self._P_PARTS[mb_type]
            refs = []
            for (bx4, by4, w4, h4) in parts:
                self._cur_z = _XY_TO_Z[(bx4, by4)]
                r = cb.ref_idx(0, bx4, by4) if n0 > 1 else 0
                refs.append(r)
                # earlier partitions' refs are visible to later ref ctx
                pic.ref_idx[0, gy0 + by4 : gy0 + by4 + h4,
                            gx0 + bx4 : gx0 + bx4 + w4] = r
            for i, (bx4, by4, w4, h4) in enumerate(parts):
                mv = self._part_motion_cabac(cb, 0, bx4, by4, w4, h4,
                                             refs[i], kind, i)
                self._mc_part(predY, predU, predV, bx4, by4, w4, h4,
                              refs[i], mv[0], mv[1])
            sub_types = None
        else:
            sub_types = [cb.sub_mb_type_p() for _ in range(4)]
            refs = [0, 0, 0, 0]
            for b in range(4):
                bx0, by0 = (b & 1) * 2, (b >> 1) * 2
                if mb_type == 3 and n0 > 1:
                    self._cur_z = _XY_TO_Z[(bx0, by0)]
                    refs[b] = cb.ref_idx(0, bx0, by0)
                pic.ref_idx[0, gy0 + by0 : gy0 + by0 + 2,
                            gx0 + bx0 : gx0 + bx0 + 2] = refs[b]
            for b in range(4):
                bx0, by0 = (b & 1) * 2, (b >> 1) * 2
                for (sx, sy, w4, h4) in self._SUB_PARTS[sub_types[b]]:
                    bx4, by4 = bx0 + sx, by0 + sy
                    mv = self._part_motion_cabac(cb, 0, bx4, by4, w4, h4,
                                                 refs[b])
                    self._mc_part(predY, predU, predV, bx4, by4, w4, h4,
                                  refs[b], mv[0], mv[1])
        self._cur_z = 16
        tf8_ok = mb_type in (0, 1, 2) or all(st == 0 for st in sub_types)
        self._inter_residual_cabac(cb, mbx, mby, predY, predU, predV, tf8_ok)

    def _decode_b_mb_cabac(self, cb, mbx, mby, mb_type: int) -> None:
        pic = self.pic
        self._direct_cache = None
        pic.mb_class[mby, mbx] = MB_B
        n_act = self.h.num_ref_idx
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        if mb_type == 0:  # B_Direct_16x16
            pic.mb_bdirect[mby, mbx] = 1
            for b in range(4):
                self._decode_direct_8x8(b, predY, predU, predV)
            self._cur_z = 16
            self._inter_residual_cabac(cb, mbx, mby, predY, predU, predV,
                                       bool(self.sps.direct_8x8_inference))
            return
        tf8_ok = True
        if mb_type < 22:
            kind, preds = self._B_TYPES[mb_type]
            parts = self._PART_GEOM[kind]
            np_ = len(parts)
            refs = [[-1] * np_, [-1] * np_]
            gx0, gy0 = mbx * 4, mby * 4
            for l in (0, 1):
                for i, pm in enumerate(preds):
                    if pm == 2 or pm == l:
                        bx4, by4, w4, h4 = parts[i]
                        self._cur_z = _XY_TO_Z[(bx4, by4)]
                        r = (cb.ref_idx(l, bx4, by4)
                             if n_act[l] > 1 else 0)
                        refs[l][i] = r
                        pic.ref_idx[l, gy0 + by4 : gy0 + by4 + h4,
                                    gx0 + bx4 : gx0 + bx4 + w4] = r
            mvs = [[None] * np_, [None] * np_]
            for l in (0, 1):
                for i, (bx4, by4, w4, h4) in enumerate(parts):
                    if refs[l][i] < 0:
                        continue
                    mvs[l][i] = self._part_motion_cabac(
                        cb, l, bx4, by4, w4, h4, refs[l][i], kind, i)
            for i, (bx4, by4, w4, h4) in enumerate(parts):
                p0 = (self._fetch_pred(0, refs[0][i], bx4, by4, w4, h4,
                                       *mvs[0][i]) if refs[0][i] >= 0 else None)
                p1 = (self._fetch_pred(1, refs[1][i], bx4, by4, w4, h4,
                                       *mvs[1][i]) if refs[1][i] >= 0 else None)
                self._combine_store(predY, predU, predV, bx4, by4, w4, h4,
                                    p0, p1, refs[0][i], refs[1][i])
        else:  # B_8x8
            sub_types = [cb.sub_mb_type_b() for _ in range(4)]
            if any(st > 12 for st in sub_types):
                raise EOFError_(f"bad B sub_mb_type {sub_types}")
            for b in range(4):
                if self._B_SUB[sub_types[b]][0] == -1:
                    self._cur_z = _XY_TO_Z[((b & 1) * 2, (b >> 1) * 2)]
                    self._decode_direct_8x8(b, predY, predU, predV)
            refs = [[-1] * 4, [-1] * 4]
            gx0, gy0 = mbx * 4, mby * 4
            for l in (0, 1):
                for b in range(4):
                    pm = self._B_SUB[sub_types[b]][0]
                    if pm == 2 or pm == l:
                        bx0, by0 = (b & 1) * 2, (b >> 1) * 2
                        self._cur_z = _XY_TO_Z[(bx0, by0)]
                        r = (cb.ref_idx(l, bx0, by0)
                             if n_act[l] > 1 else 0)
                        refs[l][b] = r
                        pic.ref_idx[l, gy0 + by0 : gy0 + by0 + 2,
                                    gx0 + bx0 : gx0 + bx0 + 2] = r
            submvs = {}
            for l in (0, 1):
                for b in range(4):
                    pm, sparts = self._B_SUB[sub_types[b]]
                    if pm == -1 or not (pm == 2 or pm == l):
                        continue
                    for sp in sparts:
                        sx, sy, w4, h4 = sp
                        bx4, by4 = (b & 1) * 2 + sx, (b >> 1) * 2 + sy
                        submvs[(l, b, sp)] = self._part_motion_cabac(
                            cb, l, bx4, by4, w4, h4, refs[l][b])
            for b in range(4):
                pm, sparts = self._B_SUB[sub_types[b]]
                if pm == -1:
                    continue
                for sp in sparts:
                    sx, sy, w4, h4 = sp
                    bx4, by4 = (b & 1) * 2 + sx, (b >> 1) * 2 + sy
                    p0 = p1 = None
                    if refs[0][b] >= 0:
                        p0 = self._fetch_pred(0, refs[0][b], bx4, by4, w4, h4,
                                              *submvs[(0, b, sp)])
                    if refs[1][b] >= 0:
                        p1 = self._fetch_pred(1, refs[1][b], bx4, by4, w4, h4,
                                              *submvs[(1, b, sp)])
                    self._combine_store(predY, predU, predV, bx4, by4, w4, h4,
                                        p0, p1, refs[0][b], refs[1][b])
            tf8_ok = all(
                (st == 0 and self.sps.direct_8x8_inference) or st in (1, 2, 3)
                for st in sub_types)
        self._cur_z = 16
        self._inter_residual_cabac(cb, mbx, mby, predY, predU, predV, tf8_ok)

    def _inter_residual_cabac(self, cb, mbx, mby, predY, predU, predV,
                              tf8_ok: bool) -> None:
        pic = self.pic
        cbp = cb.cbp(mbx, mby)
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        tf8 = 0
        if cbp_luma and tf8_ok and self.pps.transform_8x8_mode:
            tf8 = cb.transform_size_8x8(mbx, mby)
        pic.mb_tf8[mby, mbx] = tf8
        self._qp_delta_cabac(cb, mbx, mby, cbp, False)
        gx0, gy0 = mbx * 4, mby * 4
        Y = pic.Y
        if tf8:
            for b in range(4):
                bx, by = (b & 1) * 2, (b >> 1) * 2
                px, py = mbx * 16 + bx * 4, mby * 16 + by * 4
                if not (cbp_luma & (1 << b)):
                    for yy in range(8):
                        Y[py + yy, px : px + 8] = predY[by * 4 + yy,
                                                        bx * 4 : bx * 4 + 8]
                    continue
                scan64 = cb.residual(5, 64)
                nz = sum(1 for c in scan64 if c)
                pic.cbf_y[gy0 + by : gy0 + by + 2, gx0 + bx : gx0 + bx + 2] = 1
                pic.nnz_y[gy0 + by : gy0 + by + 2, gx0 + bx : gx0 + bx + 2] = nz
                res = self._residual8x8(scan64, self.qp, 1)
                for yy in range(8):
                    row = Y[py + yy]
                    base = 8 * yy
                    for xx in range(8):
                        row[px + xx] = _clip1(
                            int(predY[by * 4 + yy, bx * 4 + xx])
                            + res[base + xx])
            self._pred_chroma = (predU, predV)
            self._decode_chroma_cabac(cb, mbx, mby, 0, cbp_chroma, False)
            return
        dq = self._dq4(self.qp, 3)
        for k in range(16):
            x4, y4 = _Z_TO_XY[k]
            px, py = mbx * 16 + x4 * 4, mby * 16 + y4 * 4
            blk = None
            if cbp_luma & (1 << (k >> 2)):
                blk = self._luma4_residual_cabac(cb, k, 2)
            if blk is None:
                for yy in range(4):
                    Y[py + yy, px : px + 4] = predY[y4 * 4 + yy,
                                                    x4 * 4 : x4 * 4 + 4]
                continue
            d = [0] * 16
            for s in range(16):
                c = blk[s]
                if c:
                    pos = self.scan4[s]
                    d[pos] = _dequant4_apply(c, dq[pos], self.qp)
            res = _idct4x4(d)
            for yy in range(4):
                row = Y[py + yy]
                base = 4 * yy
                for xx in range(4):
                    row[px + xx] = _clip1(
                        int(predY[y4 * 4 + yy, x4 * 4 + xx]) + res[base + xx])
        self._pred_chroma = (predU, predV)
        self._decode_chroma_cabac(cb, mbx, mby, 0, cbp_chroma, False)

    def _decode_intra_mb(self, r: BitReader, mbx: int, mby: int,
                         imb: int) -> None:
        pic = self.pic
        if imb == 25:
            self._decode_ipcm(r, mbx, mby)
            return
        if imb == 0:
            self._decode_i4x4(r, mbx, mby)
        else:
            self._decode_i16x16(r, mbx, mby, imb - 1)

    def _decode_ipcm(self, r: BitReader, mbx: int, mby: int) -> None:
        pic = self.pic
        r.byte_align()
        y0, x0 = mby * 16, mbx * 16
        for yy in range(16):
            for xx in range(16):
                pic.Y[y0 + yy, x0 + xx] = r.read(8)
        for comp, plane in ((0, pic.U), (1, pic.V)):
            for yy in range(8):
                for xx in range(8):
                    plane[mby * 8 + yy, mbx * 8 + xx] = r.read(8)
        pic.mb_class[mby, mbx] = MB_IPCM
        pic.nnz_y[mby * 4 : mby * 4 + 4, mbx * 4 : mbx * 4 + 4] = 16
        pic.nnz_c[:, mby * 2 : mby * 2 + 2, mbx * 2 : mbx * 2 + 2] = 16
        pic.mb_qp[mby, mbx] = 0
        pic.mb_cbp[mby, mbx] = 0x2F  # deblock treats PCM as fully coded

    def _read_i4x4_modes(self, r: BitReader, mbx: int, mby: int):
        """Parse 16 prediction modes, resolving the predictive coding
        against neighbour modes (8.3.1.1)."""
        pic = self.pic
        modes = [2] * 16
        gx0, gy0 = mbx * 4, mby * 4
        for k in range(16):
            x4, y4 = _Z_TO_XY[k]
            gx, gy = gx0 + x4, gy0 + y4
            ma = self._i4_mode_at(gx - 1, gy, k, mbx, mby)
            mb_ = self._i4_mode_at(gx, gy - 1, k, mbx, mby)
            pred = 2 if (ma is None or mb_ is None) else min(ma, mb_)
            if r.read(1):  # prev_intra4x4_pred_mode_flag
                mode = pred
            else:
                rem = r.read(3)
                mode = rem if rem < pred else rem + 1
            modes[k] = mode
            pic.i4_modes[gy, gx] = mode
        return modes

    def _i4_mode_at(self, gx: int, gy: int, cur_z: int, mbx: int, mby: int):
        """Mode of neighbour block for prediction-mode inference: None if
        unavailable; 2 if the MB is not Intra_4x4/Intra_8x8 coded."""
        if gx < 0 or gy < 0:
            return None
        nmbx, nmby = gx >> 2, gy >> 2
        if nmbx == mbx and nmby == mby:
            return int(self.pic.i4_modes[gy, gx])
        if not self._mb_avail_intra(nmbx, nmby):
            return None
        cls = self.pic.mb_class[nmby, nmbx]
        if cls in (MB_I4, MB_I8):
            return int(self.pic.i4_modes[gy, gx])
        return 2  # available but not 4x4-coded -> DC

    def _decode_i4x4(self, r: BitReader, mbx: int, mby: int) -> None:
        pic, pps = self.pic, self.pps
        tf8 = 0
        if pps.transform_8x8_mode:
            tf8 = r.read(1)
        if tf8:
            self._decode_i8x8_mb(r, mbx, mby)
            return
        pic.mb_class[mby, mbx] = MB_I4
        modes = self._read_i4x4_modes(r, mbx, mby)
        chroma_mode = r.ue()
        cbp = T.GOLOMB_TO_INTRA4X4_CBP[r.ue()]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            self.qp = (self.qp + r.se() + 52) % 52
        pic.mb_qp[mby, mbx] = self.qp
        pic.mb_cbp[mby, mbx] = cbp
        # parse residuals (z order), reconstructing each block in turn:
        # intra 4x4 prediction needs the reconstructed neighbours, and CAVLC
        # nC needs the nnz of previously parsed blocks — both follow z order.
        gx0, gy0 = mbx * 4, mby * 4
        coeffs = [None] * 16
        for k in range(16):
            if cbp_luma & (1 << (k >> 2)):
                x4, y4 = _Z_TO_XY[k]
                gx, gy = gx0 + x4, gy0 + y4
                nc = self._combine_nc(self._nnz_luma(gx - 1, gy),
                                      self._nnz_luma(gx, gy - 1))
                blk, tc = _cavlc_block(r, nc, 16)
                coeffs[k] = blk
                pic.nnz_y[gy, gx] = tc
        # reconstruct luma blocks in z order
        for k in range(16):
            self._recon_i4_block(mbx, mby, k, modes[k], coeffs[k])
        self._decode_chroma_cavlc(r, mbx, mby, chroma_mode, cbp_chroma,
                                  intra=True)

    def _read_i8x8_modes(self, r: BitReader, mbx: int, mby: int):
        """Four Intra8x8 prediction modes with neighbour inference (8.3.2.1).
        Modes are stored into all four 4x4 cells of each 8x8 block so the
        per-4x4 neighbour lookups work across I4/I8 macroblocks."""
        pic = self.pic
        modes = [2] * 4
        gx0, gy0 = mbx * 4, mby * 4
        for b in range(4):
            bx, by = (b & 1) * 2, (b >> 1) * 2
            gx, gy = gx0 + bx, gy0 + by
            z = _XY_TO_Z[(bx, by)]
            ma = self._i4_mode_at(gx - 1, gy, z, mbx, mby)
            mb_ = self._i4_mode_at(gx, gy - 1, z, mbx, mby)
            pred = 2 if (ma is None or mb_ is None) else min(ma, mb_)
            if r.read(1):
                mode = pred
            else:
                rem = r.read(3)
                mode = rem if rem < pred else rem + 1
            modes[b] = mode
            pic.i4_modes[gy : gy + 2, gx : gx + 2] = mode
        return modes

    def _decode_i8x8_mb(self, r: BitReader, mbx: int, mby: int) -> None:
        pic = self.pic
        self._cur_mbx, self._cur_mby = mbx, mby
        pic.mb_class[mby, mbx] = MB_I8
        pic.mb_tf8[mby, mbx] = 1
        modes = self._read_i8x8_modes(r, mbx, mby)
        chroma_mode = r.ue()
        cbp = T.GOLOMB_TO_INTRA4X4_CBP[r.ue()]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            self.qp = (self.qp + r.se() + 52) % 52
        pic.mb_qp[mby, mbx] = self.qp
        pic.mb_cbp[mby, mbx] = cbp
        coeffs = [None] * 4
        for b in range(4):
            if cbp_luma & (1 << b):
                coeffs[b] = self._parse_luma8x8_cavlc(r, b)
        for b in range(4):
            self._recon_i8_block(mbx, mby, b, modes[b], coeffs[b])
        self._decode_chroma_cavlc(r, mbx, mby, chroma_mode, cbp_chroma,
                                  intra=True)

    def _recon_i8_block(self, mbx: int, mby: int, b: int, mode: int,
                        scan64) -> None:
        pic = self.pic
        bx, by = (b & 1) * 2, (b >> 1) * 2
        gx, gy = mbx * 4 + bx, mby * 4 + by
        z = _XY_TO_Z[(bx, by)]
        px, py = gx * 4, gy * 4
        Y = pic.Y
        avail_l = self._blk_avail_intra(gx - 1, gy, z, mbx, mby)
        avail_t = self._blk_avail_intra(gx, gy - 1, z, mbx, mby)
        avail_tl = self._blk_avail_intra(gx - 1, gy - 1, z, mbx, mby)
        avail_tr = self._blk_avail_intra(gx + 2, gy - 1, z, mbx, mby)
        left = [int(Y[py + i, px - 1]) for i in range(8)] if avail_l else None
        top = None
        if avail_t:
            top = [int(Y[py - 1, px + i]) for i in range(8)]
            if avail_tr:
                top += [int(Y[py - 1, px + 8 + i]) for i in range(8)]
            else:
                top += [top[7]] * 8
        tl = int(Y[py - 1, px - 1]) if avail_tl else None
        fl, ft, ftl = _filter_i8_refs(left, top, tl,
                                      avail_l, avail_t, avail_tl)
        pred = _pred8x8(mode, fl, ft, ftl, avail_l, avail_t, avail_tl)
        if scan64 is None:
            for yy in range(8):
                Y[py + yy, px : px + 8] = pred[yy]
            return
        res = self._residual8x8(scan64, self.qp, 0)
        for yy in range(8):
            row = Y[py + yy]
            base = 8 * yy
            for xx in range(8):
                row[px + xx] = _clip1(pred[yy][xx] + res[base + xx])

    def _recon_i4_block(self, mbx: int, mby: int, k: int, mode: int,
                        coeffs) -> None:
        pic = self.pic
        x4, y4 = _Z_TO_XY[k]
        gx, gy = mbx * 4 + x4, mby * 4 + y4
        px, py = gx * 4, gy * 4
        Y = pic.Y
        avail_l = self._blk_avail_intra(gx - 1, gy, k, mbx, mby)
        avail_t = self._blk_avail_intra(gx, gy - 1, k, mbx, mby)
        avail_tl = self._blk_avail_intra(gx - 1, gy - 1, k, mbx, mby)
        avail_tr = self._blk_avail_intra(gx + 1, gy - 1, k, mbx, mby)
        l = [int(Y[py + i, px - 1]) for i in range(4)] if avail_l else [0] * 4
        t = [int(Y[py - 1, px + i]) for i in range(4)] if avail_t else [0] * 4
        tl = int(Y[py - 1, px - 1]) if avail_tl else 0
        if avail_tr:
            tr = [int(Y[py - 1, px + 4 + i]) for i in range(4)]
        elif avail_t:
            tr = [t[3]] * 4
        else:
            tr = [0] * 4

        def P(x, y):
            if y == -1:
                if x == -1:
                    return tl
                return t[x] if x < 4 else tr[x - 4]
            return l[y]

        pred = _pred4x4(mode, P, avail_l, avail_t, avail_tl)
        if coeffs is None:
            for yy in range(4):
                Y[py + yy, px : px + 4] = pred[yy]
            return
        dq = self._dq4(self.qp, 0)
        d = [0] * 16
        for s in range(16):
            c = coeffs[s]
            if c:
                pos = self.scan4[s]
                d[pos] = _dequant4_apply(c, dq[pos], self.qp)
        res = _idct4x4(d)
        for yy in range(4):
            row = Y[py + yy]
            base = 4 * yy
            for xx in range(4):
                row[px + xx] = _clip1(pred[yy][xx] + res[base + xx])

    def _decode_i16x16(self, r: BitReader, mbx: int, mby: int, k: int) -> None:
        pic = self.pic
        pred_mode = k % 4
        cbp_chroma = (k // 4) % 3
        cbp_luma = 15 if k >= 12 else 0
        chroma_mode = r.ue()
        self.qp = (self.qp + r.se() + 52) % 52
        pic.mb_class[mby, mbx] = MB_I16
        pic.mb_qp[mby, mbx] = self.qp
        pic.mb_cbp[mby, mbx] = cbp_luma | (cbp_chroma << 4)
        gx0, gy0 = mbx * 4, mby * 4
        # luma DC (4x4 scan over the DC array)
        nc = self._combine_nc(self._nnz_luma(gx0 - 1, gy0),
                              self._nnz_luma(gx0, gy0 - 1))
        dc_scan, dc_tc = _cavlc_block(r, nc, 16)
        if dc_tc:
            pic.mb_dc_flag[mby, mbx] |= 1
        # AC blocks
        coeffs = [None] * 16
        for kk in range(16):
            x4, y4 = _Z_TO_XY[kk]
            gx, gy = gx0 + x4, gy0 + y4
            if cbp_luma:
                ncb = self._combine_nc(self._nnz_luma(gx - 1, gy),
                                       self._nnz_luma(gx, gy - 1))
                blk, tc = _cavlc_block(r, ncb, 15)
                coeffs[kk] = blk
                pic.nnz_y[gy, gx] = tc
        self._recon_i16(mbx, mby, pred_mode, dc_scan, coeffs)
        self._decode_chroma_cavlc(r, mbx, mby, chroma_mode, cbp_chroma,
                                  intra=True)

    def _recon_i16(self, mbx: int, mby: int, pred_mode: int,
                   dc_scan, coeffs) -> None:
        """Intra_16x16 luma reconstruction from parsed DC (scan order) and
        AC blocks (15-coeff scan order or None)."""
        pic = self.pic
        avail_l = self._mb_avail_intra(mbx - 1, mby)
        avail_t = self._mb_avail_intra(mbx, mby - 1)
        avail_tl = self._mb_avail_intra(mbx - 1, mby - 1)
        px, py = mbx * 16, mby * 16
        Y = pic.Y
        left = [int(Y[py + i, px - 1]) for i in range(16)] if avail_l else [0] * 16
        top = [int(Y[py - 1, px + i]) for i in range(16)] if avail_t else [0] * 16
        tl = int(Y[py - 1, px - 1]) if avail_tl else 0
        pred = _pred16x16(pred_mode, left, top, tl, avail_l, avail_t)
        # DC transform
        dcr = [0] * 16
        for s in range(16):
            dcr[self.scan4[s]] = dc_scan[s]
        f = _hadamard4x4(dcr)
        dc = _luma_dc_dequant(f, self.qp, self.w4[0][0])
        dq = self._dq4(self.qp, 0)
        for kk in range(16):
            x4, y4 = _Z_TO_XY[kk]
            d = [0] * 16
            blk = coeffs[kk]
            if blk is not None:
                for s in range(15):
                    c = blk[s]
                    if c:
                        pos = self.scan4[s + 1]
                        d[pos] = _dequant4_apply(c, dq[pos], self.qp)
            d[0] = dc[4 * y4 + x4]
            res = _idct4x4(d)
            bx, by = px + 4 * x4, py + 4 * y4
            for yy in range(4):
                row = Y[by + yy]
                prow = pred[by - py + yy]
                base = 4 * yy
                for xx in range(4):
                    row[bx + xx] = _clip1(int(prow[bx - px + xx]) + res[base + xx])

    def _decode_chroma_cavlc(self, r: BitReader, mbx: int, mby: int,
                             chroma_mode: int, cbp_chroma: int,
                             intra: bool) -> None:
        pic, pps = self.pic, self.pps
        dc_scan = [[0] * 4, [0] * 4]
        if cbp_chroma:
            for comp in range(2):
                blk, tc = _cavlc_block(r, -1, 4)
                dc_scan[comp] = blk
                if tc:
                    pic.mb_dc_flag[mby, mbx] |= 2 << comp
        coeffs = [[None] * 4 for _ in range(2)]
        if cbp_chroma & 2:
            for comp in range(2):
                for b in range(4):
                    cx = mbx * 2 + (b & 1)
                    cy = mby * 2 + (b >> 1)
                    nc = self._combine_nc(self._nnz_chroma(comp, cx - 1, cy),
                                          self._nnz_chroma(comp, cx, cy - 1))
                    blk, tc = _cavlc_block(r, nc, 15)
                    coeffs[comp][b] = blk
                    pic.nnz_c[comp, cy, cx] = tc
        self._recon_chroma(mbx, mby, chroma_mode, dc_scan, coeffs, intra)

    def _recon_chroma(self, mbx: int, mby: int, chroma_mode: int,
                      dc_scan, coeffs, intra: bool) -> None:
        """Chroma reconstruction from parsed DC (2x2 scan) and AC blocks."""
        pic, pps = self.pic, self.pps
        avail_l = self._mb_avail_intra(mbx - 1, mby)
        avail_t = self._mb_avail_intra(mbx, mby - 1)
        avail_tl = self._mb_avail_intra(mbx - 1, mby - 1)
        qpc = (chroma_qp(self.qp, pps.chroma_qp_index_offset),
               chroma_qp(self.qp, pps.second_chroma_qp_index_offset))
        for comp, plane in ((0, pic.U), (1, pic.V)):
            px, py = mbx * 8, mby * 8
            if intra:
                left = ([int(plane[py + i, px - 1]) for i in range(8)]
                        if avail_l else [0] * 8)
                top = ([int(plane[py - 1, px + i]) for i in range(8)]
                       if avail_t else [0] * 8)
                tl = int(plane[py - 1, px - 1]) if avail_tl else 0
                pred = _pred_chroma8x8(chroma_mode, left, top, tl,
                                       avail_l, avail_t)
            else:
                pred = self._inter_chroma_pred(comp, mbx, mby)
            qp = qpc[comp]
            list_idx = (1 + comp) if intra else (4 + comp)
            # DC 2x2 transform
            c0, c1, c2, c3 = dc_scan[comp]
            f = (c0 + c1 + c2 + c3, c0 - c1 + c2 - c3,
                 c0 + c1 - c2 - c3, c0 - c1 - c2 + c3)
            dc = _chroma_dc_dequant(f, qp, self.w4[list_idx][0])
            dq = self._dq4(qp, list_idx)
            out = pred.copy()
            for b in range(4):
                bx, by = 4 * (b & 1), 4 * (b >> 1)
                d = [0] * 16
                blk = coeffs[comp][b]
                if blk is not None:
                    for s in range(15):
                        c = blk[s]
                        if c:
                            pos = self.scan4[s + 1]
                            d[pos] = _dequant4_apply(c, dq[pos], qp)
                d[0] = dc[b]
                if any(d):
                    res = _idct4x4(d)
                    for yy in range(4):
                        base = 4 * yy
                        for xx in range(4):
                            out[by + yy, bx + xx] = _clip1(
                                int(pred[by + yy, bx + xx]) + res[base + xx])
            plane[py : py + 8, px : px + 8] = np.clip(out, 0, 255)

    def _inter_chroma_pred(self, comp, mbx, mby):
        return self._pred_chroma[comp]

    # -- inter decoding (P slices) -----------------------------------------

    def _read_te(self, r: BitReader, cmax: int) -> int:
        if cmax == 0:
            return 0
        if cmax == 1:
            return 1 - r.read(1)
        return r.ue()

    def _mv_ref_at(self, gx: int, gy: int, l: int = 0):
        """(avail, ref_idx, mvx, mvy) of the list-l motion of the 4x4 block at
        global 4x4 coords for MV prediction (8.4.1.3.2). Blocks in the
        current MB count as decoded when their z index < self._cur_z."""
        pic = self.pic
        if gx < 0 or gy < 0 or gx >= pic.mb_w * 4 or gy >= pic.mb_h * 4:
            return (False, -1, 0, 0)
        mbx, mby = gx >> 2, gy >> 2
        if mbx == self._cur_mbx and mby == self._cur_mby:
            if _XY_TO_Z[(gx & 3, gy & 3)] >= self._cur_z:
                return (False, -1, 0, 0)
        elif pic.mb_slice[mby, mbx] != self.sid:
            return (False, -1, 0, 0)
        elif not (mby < self._cur_mby
                  or (mby == self._cur_mby and mbx < self._cur_mbx)):
            return (False, -1, 0, 0)
        return (True, int(pic.ref_idx[l, gy, gx]),
                int(pic.mv[l, gy, gx, 0]), int(pic.mv[l, gy, gx, 1]))

    def _mv_pred(self, bx4: int, by4: int, w4: int, h4: int, ref_idx: int,
                 part_kind: str = "", part_i: int = 0, l: int = 0):
        """Median/directional motion vector prediction (8.4.1.3)."""
        gx0 = self._cur_mbx * 4 + bx4
        gy0 = self._cur_mby * 4 + by4
        A = self._mv_ref_at(gx0 - 1, gy0, l)
        B = self._mv_ref_at(gx0, gy0 - 1, l)
        C = self._mv_ref_at(gx0 + w4, gy0 - 1, l)
        if not C[0]:
            C = self._mv_ref_at(gx0 - 1, gy0 - 1, l)  # D substitution
        ra, rb, rc = A[1], B[1], C[1]
        # directional overrides for 16x8 / 8x16 partitions
        if part_kind == "16x8":
            if part_i == 0 and rb == ref_idx:
                return (B[2], B[3])
            if part_i == 1 and ra == ref_idx:
                return (A[2], A[3])
        elif part_kind == "8x16":
            if part_i == 0 and ra == ref_idx:
                return (A[2], A[3])
            if part_i == 1 and rc == ref_idx:
                return (C[2], C[3])
        match_a = ra == ref_idx
        match_b = rb == ref_idx
        match_c = rc == ref_idx
        if match_a and not match_b and not match_c:
            return (A[2], A[3])
        if match_b and not match_a and not match_c:
            return (B[2], B[3])
        if match_c and not match_a and not match_b:
            return (C[2], C[3])
        if not B[0] and not C[0]:
            return (A[2], A[3])
        return (_median3(A[2], B[2], C[2]), _median3(A[3], B[3], C[3]))

    def _store_part_mv(self, bx4, by4, w4, h4, ref_idx, ref: _Picture,
                      mvx, mvy, l: int = 0) -> None:
        pic = self.pic
        gx0 = self._cur_mbx * 4 + bx4
        gy0 = self._cur_mby * 4 + by4
        pic.mv[l, gy0 : gy0 + h4, gx0 : gx0 + w4] = (mvx, mvy)
        pic.ref_idx[l, gy0 : gy0 + h4, gx0 : gx0 + w4] = ref_idx
        pic.ref_id[l, gy0 : gy0 + h4, gx0 : gx0 + w4] = ref.pic_id

    def _wp_apply(self, blk: np.ndarray, l: int, ref_idx: int,
                  comp: int) -> np.ndarray:
        """Explicit single-list weighted prediction (8.4.2.3.2).
        comp: -1 = luma, 0/1 = Cb/Cr."""
        pw = self.h.pred_weights
        if pw is None:
            return blk
        logwd = pw[0] if comp < 0 else pw[1]
        wt = pw[2][l][ref_idx]
        if comp < 0:
            w, o = wt[0], wt[1]
        else:
            w, o = wt[2 + 2 * comp], wt[3 + 2 * comp]
        if logwd >= 1:
            blk = ((blk * w + (1 << (logwd - 1))) >> logwd) + o
        else:
            blk = blk * w + o
        return _clip255(blk)

    def _fetch_pred(self, l: int, ref_idx: int, bx4, by4, w4, h4,
                    mvx: int, mvy: int):
        """Raw (unweighted) interpolated blocks (Y, U, V) from list l.
        Field pictures referencing the opposite parity apply the 8.4.1.4
        chroma vertical MV adjustment (top->bottom -2, bottom->top +2)."""
        ref = (self.ref_l0 if l == 0 else self.ref_l1)[ref_idx]
        mbx, mby = self._cur_mbx, self._cur_mby
        x0, y0 = mbx * 16 + bx4 * 4, mby * 16 + by4 * 4
        cx0, cy0 = mbx * 8 + bx4 * 2, mby * 8 + by4 * 2
        cmvy = mvy
        if getattr(self.pic, "is_field_pic", False):
            cur_parity = self.pic.parity
            ref_parity = getattr(ref, "parity", cur_parity)
            if cur_parity == 0 and ref_parity == 1:
                cmvy = mvy - 2
            elif cur_parity == 1 and ref_parity == 0:
                cmvy = mvy + 2
        return (_mc_luma(ref.Y, x0, y0, w4 * 4, h4 * 4, mvx, mvy),
                _mc_chroma(ref.U, cx0, cy0, w4 * 2, h4 * 2, mvx, cmvy),
                _mc_chroma(ref.V, cx0, cy0, w4 * 2, h4 * 2, mvx, cmvy))

    def _implicit_weights(self, ref_idx0: int, ref_idx1: int):
        """(w0, w1) per 8.4.2.3.1 implicit mode."""
        pic0 = self.ref_l0[ref_idx0]
        pic1 = self.ref_l1[ref_idx1]
        cur = self.pic.poc
        if pic1.poc == pic0.poc or pic0.long_term or pic1.long_term:
            return (32, 32)
        tb = min(127, max(-128, cur - pic0.poc))
        td = min(127, max(-128, pic1.poc - pic0.poc))
        tx = (16384 + abs(td) // 2) // td
        dsf = min(1023, max(-1024, (tb * tx + 32) >> 6))
        w1 = dsf >> 2
        if w1 < -64 or w1 > 128:
            return (32, 32)
        return (64 - w1, w1)

    def _combine_store(self, predY, predU, predV, bx4, by4, w4, h4,
                       p0, p1, ref_idx0: int, ref_idx1: int) -> None:
        """Combine per-list predictions (weighted as configured) and place
        into the MB prediction planes.  p0/p1: (Y, U, V) or None."""
        pps, h = self.pps, self.h
        out = [None, None, None]
        if p0 is not None and p1 is not None:
            if h.slice_type == SLICE_B and pps.weighted_bipred_idc == 2:
                w0, w1 = self._implicit_weights(ref_idx0, ref_idx1)
                for c in range(3):
                    out[c] = _clip255(
                        (p0[c] * w0 + p1[c] * w1 + 32) >> 6)
            elif h.slice_type == SLICE_B and pps.weighted_bipred_idc == 1 \
                    and h.pred_weights is not None:
                pw = h.pred_weights
                for c in range(3):
                    logwd = pw[0] if c == 0 else pw[1]
                    wt0 = pw[2][0][ref_idx0]
                    wt1 = pw[2][1][ref_idx1]
                    if c == 0:
                        w0, o0, w1, o1 = wt0[0], wt0[1], wt1[0], wt1[1]
                    else:
                        k = 2 * c
                        w0, o0 = wt0[k], wt0[k + 1]
                        w1, o1 = wt1[k], wt1[k + 1]
                    out[c] = _clip255(
                        ((p0[c] * w0 + p1[c] * w1 + (1 << logwd))
                         >> (logwd + 1)) + ((o0 + o1 + 1) >> 1))
            else:
                for c in range(3):
                    out[c] = (p0[c] + p1[c] + 1) >> 1
        else:
            l = 0 if p1 is None else 1
            p = p0 if p1 is None else p1
            ref_idx = ref_idx0 if p1 is None else ref_idx1
            weighted = (h.pred_weights is not None
                        and (h.slice_type != SLICE_B
                             or pps.weighted_bipred_idc == 1))
            for c in range(3):
                out[c] = (self._wp_apply(p[c], l, ref_idx, c - 1 if c else -1)
                          if weighted else p[c])
        predY[by4 * 4 : by4 * 4 + h4 * 4,
              bx4 * 4 : bx4 * 4 + w4 * 4] = out[0]
        predU[by4 * 2 : by4 * 2 + h4 * 2,
              bx4 * 2 : bx4 * 2 + w4 * 2] = out[1]
        predV[by4 * 2 : by4 * 2 + h4 * 2,
              bx4 * 2 : bx4 * 2 + w4 * 2] = out[2]

    def _mc_part(self, predY, predU, predV, bx4, by4, w4, h4,
                 ref_idx: int, mvx: int, mvy: int) -> None:
        """P single-list MC + explicit weighting."""
        p0 = self._fetch_pred(0, ref_idx, bx4, by4, w4, h4, mvx, mvy)
        self._combine_store(predY, predU, predV, bx4, by4, w4, h4,
                            p0, None, ref_idx, -1)

    def _skip_mv(self):
        """P_Skip motion (8.4.1.1)."""
        gx0 = self._cur_mbx * 4
        gy0 = self._cur_mby * 4
        A = self._mv_ref_at(gx0 - 1, gy0)
        B = self._mv_ref_at(gx0, gy0 - 1)
        if not A[0] or not B[0]:
            return (0, 0)
        if A[1] == 0 and A[2] == 0 and A[3] == 0:
            return (0, 0)
        if B[1] == 0 and B[2] == 0 and B[3] == 0:
            return (0, 0)
        return self._mv_pred(0, 0, 4, 4, 0)

    def decode_skip_mb(self, mb_idx: int) -> None:
        if self.h.slice_type == SLICE_B:
            self.decode_b_skip_mb(mb_idx)
            return
        pic = self.pic
        mbx, mby = mb_idx % pic.mb_w, mb_idx // pic.mb_w
        self._mark_mb(mbx, mby)
        self._cur_mbx, self._cur_mby, self._cur_z = mbx, mby, 0
        pic.mb_class[mby, mbx] = MB_P
        pic.mb_qp[mby, mbx] = self.qp
        pic.mb_cbp[mby, mbx] = 0
        mvx, mvy = self._skip_mv()
        self._cur_z = 16
        self._store_part_mv(0, 0, 4, 4, 0, self.ref_l0[0], mvx, mvy)
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        self._mc_part(predY, predU, predV, 0, 0, 4, 4, 0, mvx, mvy)
        pic.Y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16] = predY
        pic.U[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8] = predU
        pic.V[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8] = predV

    _P_PARTS = {
        0: ("16x16", ((0, 0, 4, 4),)),
        1: ("16x8", ((0, 0, 4, 2), (0, 2, 4, 2))),
        2: ("8x16", ((0, 0, 2, 4), (2, 0, 2, 4))),
    }
    _SUB_PARTS = {
        0: ((0, 0, 2, 2),),
        1: ((0, 0, 2, 1), (0, 1, 2, 1)),
        2: ((0, 0, 1, 2), (1, 0, 1, 2)),
        3: ((0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)),
    }

    def _decode_p_mb(self, r: BitReader, mbx: int, mby: int, mb_type: int) -> None:
        pic = self.pic
        self._cur_mbx, self._cur_mby = mbx, mby
        self._cur_z = 0
        pic.mb_class[mby, mbx] = MB_P
        n0 = self.h.num_ref_idx[0]
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        if mb_type in (0, 1, 2):
            kind, parts = self._P_PARTS[mb_type]
            refs = [self._read_te(r, n0 - 1) for _ in parts]
            for i, (bx4, by4, w4, h4) in enumerate(parts):
                mvdx, mvdy = r.se(), r.se()
                self._cur_z = _XY_TO_Z[(bx4, by4)]
                px, py = self._mv_pred(bx4, by4, w4, h4, refs[i], kind, i)
                mvx, mvy = px + mvdx, py + mvdy
                self._store_part_mv(bx4, by4, w4, h4, refs[i],
                                    self.ref_l0[refs[i]], mvx, mvy)
                self._mc_part(predY, predU, predV, bx4, by4, w4, h4,
                              refs[i], mvx, mvy)
        else:
            # P_8x8 (3) / P_8x8ref0 (4)
            sub_types = [r.ue() for _ in range(4)]
            if any(st > 3 for st in sub_types):
                raise EOFError_(f"bad sub_mb_type {sub_types}")
            if mb_type == 3:
                refs = [self._read_te(r, n0 - 1) for _ in range(4)]
            else:
                refs = [0, 0, 0, 0]
            for b in range(4):
                bx0, by0 = (b & 1) * 2, (b >> 1) * 2
                for (sx, sy, w4, h4) in self._SUB_PARTS[sub_types[b]]:
                    bx4, by4 = bx0 + sx, by0 + sy
                    mvdx, mvdy = r.se(), r.se()
                    self._cur_z = _XY_TO_Z[(bx4, by4)]
                    px, py = self._mv_pred(bx4, by4, w4, h4, refs[b])
                    mvx, mvy = px + mvdx, py + mvdy
                    self._store_part_mv(bx4, by4, w4, h4, refs[b],
                                        self.ref_l0[refs[b]], mvx, mvy)
                    self._mc_part(predY, predU, predV, bx4, by4, w4, h4,
                                  refs[b], mvx, mvy)
        self._cur_z = 16
        tf8_ok = mb_type in (0, 1, 2) or all(st == 0 for st in sub_types)
        self._inter_residual(r, mbx, mby, predY, predU, predV, tf8_ok)

    def _inter_residual(self, r: BitReader, mbx: int, mby: int,
                        predY, predU, predV, tf8_ok: bool = False) -> None:
        """CBP + residual parse and reconstruction over inter prediction."""
        pic = self.pic
        cbp = T.GOLOMB_TO_INTER_CBP[r.ue()]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        tf8 = 0
        if cbp_luma and tf8_ok and self.pps.transform_8x8_mode:
            tf8 = r.read(1)
        pic.mb_tf8[mby, mbx] = tf8
        if cbp:
            self.qp = (self.qp + r.se() + 52) % 52
        pic.mb_qp[mby, mbx] = self.qp
        pic.mb_cbp[mby, mbx] = cbp
        gx0, gy0 = mbx * 4, mby * 4
        Y = pic.Y
        if tf8:
            for b in range(4):
                bx, by = (b & 1) * 2, (b >> 1) * 2
                px, py = mbx * 16 + bx * 4, mby * 16 + by * 4
                if not (cbp_luma & (1 << b)):
                    for yy in range(8):
                        Y[py + yy, px : px + 8] = predY[by * 4 + yy,
                                                        bx * 4 : bx * 4 + 8]
                    continue
                scan64 = self._parse_luma8x8_cavlc(r, b)
                res = self._residual8x8(scan64, self.qp, 1)
                for yy in range(8):
                    row = Y[py + yy]
                    base = 8 * yy
                    for xx in range(8):
                        row[px + xx] = _clip1(
                            int(predY[by * 4 + yy, bx * 4 + xx])
                            + res[base + xx])
            self._pred_chroma = (predU, predV)
            self._decode_chroma_cavlc(r, mbx, mby, 0, cbp_chroma, intra=False)
            return
        dq = self._dq4(self.qp, 3)
        for k in range(16):
            x4, y4 = _Z_TO_XY[k]
            px, py = mbx * 16 + x4 * 4, mby * 16 + y4 * 4
            if not (cbp_luma & (1 << (k >> 2))):
                for yy in range(4):
                    Y[py + yy, px : px + 4] = predY[y4 * 4 + yy,
                                                    x4 * 4 : x4 * 4 + 4]
                continue
            gx, gy = gx0 + x4, gy0 + y4
            nc = self._combine_nc(self._nnz_luma(gx - 1, gy),
                                  self._nnz_luma(gx, gy - 1))
            blk, tc = _cavlc_block(r, nc, 16)
            pic.nnz_y[gy, gx] = tc
            d = [0] * 16
            for s in range(16):
                c = blk[s]
                if c:
                    pos = self.scan4[s]
                    d[pos] = _dequant4_apply(c, dq[pos], self.qp)
            res = _idct4x4(d)
            for yy in range(4):
                row = Y[py + yy]
                base = 4 * yy
                for xx in range(4):
                    row[px + xx] = _clip1(
                        int(predY[y4 * 4 + yy, x4 * 4 + xx]) + res[base + xx])
        self._pred_chroma = (predU, predV)
        self._decode_chroma_cavlc(r, mbx, mby, 0, cbp_chroma, intra=False)

    # -- B slices: direct modes + bi-prediction (8.4.1.2) ------------------

    _B_TYPES = {
        1: ("16x16", (0,)), 2: ("16x16", (1,)), 3: ("16x16", (2,)),
        4: ("16x8", (0, 0)), 5: ("8x16", (0, 0)),
        6: ("16x8", (1, 1)), 7: ("8x16", (1, 1)),
        8: ("16x8", (0, 1)), 9: ("8x16", (0, 1)),
        10: ("16x8", (1, 0)), 11: ("8x16", (1, 0)),
        12: ("16x8", (0, 2)), 13: ("8x16", (0, 2)),
        14: ("16x8", (1, 2)), 15: ("8x16", (1, 2)),
        16: ("16x8", (2, 0)), 17: ("8x16", (2, 0)),
        18: ("16x8", (2, 1)), 19: ("8x16", (2, 1)),
        20: ("16x8", (2, 2)), 21: ("8x16", (2, 2)),
    }
    _PART_GEOM = {
        "16x16": ((0, 0, 4, 4),),
        "16x8": ((0, 0, 4, 2), (0, 2, 4, 2)),
        "8x16": ((0, 0, 2, 4), (2, 0, 2, 4)),
    }
    # B sub_mb_type: (pred, parts) with pred -1 = direct
    _B_SUB = {
        0: (-1, None),
        1: (0, ((0, 0, 2, 2),)), 2: (1, ((0, 0, 2, 2),)),
        3: (2, ((0, 0, 2, 2),)),
        4: (0, ((0, 0, 2, 1), (0, 1, 2, 1))),
        5: (0, ((0, 0, 1, 2), (1, 0, 1, 2))),
        6: (1, ((0, 0, 2, 1), (0, 1, 2, 1))),
        7: (1, ((0, 0, 1, 2), (1, 0, 1, 2))),
        8: (2, ((0, 0, 2, 1), (0, 1, 2, 1))),
        9: (2, ((0, 0, 1, 2), (1, 0, 1, 2))),
        10: (0, ((0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1))),
        11: (1, ((0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1))),
        12: (2, ((0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1))),
    }

    def _col_motion(self, gx: int, gy: int):
        """(list, ref_idx, ref_pic_id, (mvx, mvy)) of the colocated 4x4 in
        RefPicList1[0], preferring its L0 motion; None when intra."""
        col = self.ref_l1[0]
        for l in (0, 1):
            if int(col.ref_idx[l, gy, gx]) >= 0:
                return (l, int(col.ref_idx[l, gy, gx]),
                        int(col.ref_id[l, gy, gx]),
                        (int(col.mv[l, gy, gx, 0]), int(col.mv[l, gy, gx, 1])))
        return None

    def _direct_spatial_cache(self):
        """MB-level spatial-direct state (refs, mvps, zero-pred flag);
        must be computed with _cur_z == 0 (only outside-MB neighbours)."""
        if self._direct_cache is not None:
            return self._direct_cache
        gx0, gy0 = self._cur_mbx * 4, self._cur_mby * 4
        refs = [-1, -1]
        for l in (0, 1):
            A = self._mv_ref_at(gx0 - 1, gy0, l)
            B = self._mv_ref_at(gx0, gy0 - 1, l)
            C = self._mv_ref_at(gx0 + 4, gy0 - 1, l)
            if not C[0]:
                C = self._mv_ref_at(gx0 - 1, gy0 - 1, l)
            cand = [x[1] for x in (A, B, C) if x[1] >= 0]
            refs[l] = min(cand) if cand else -1
        dzp = refs[0] < 0 and refs[1] < 0
        if dzp:
            refs = [0, 0]
        mvps = [(0, 0), (0, 0)]
        for l in (0, 1):
            if refs[l] >= 0 and not dzp:
                mvps[l] = self._mv_pred(0, 0, 4, 4, refs[l], l=l)
        self._direct_cache = (refs, mvps, dzp)
        return self._direct_cache

    def _direct_mvs_8x8(self, b: int):
        """[(ref_idx, (mvx, mvy)) for l0, l1] for 8x8 block b in direct mode
        (direct_8x8_inference: colocated corner 4x4)."""
        gx = self._cur_mbx * 4 + 3 * (b & 1)
        gy = self._cur_mby * 4 + 3 * (b >> 1)
        if self.h.direct_spatial_mv_pred:
            refs, mvps, dzp = self._direct_spatial_cache()
            col = self.ref_l1[0]
            cz = False
            if not col.long_term:
                cm = self._col_motion(gx, gy)
                if cm is not None:
                    _, ridx, _, (mx, my) = cm
                    cz = ridx == 0 and abs(mx) <= 1 and abs(my) <= 1
            out = []
            for l in (0, 1):
                if refs[l] < 0:
                    out.append((-1, (0, 0)))
                elif dzp or (cz and refs[l] == 0):
                    out.append((refs[l], (0, 0)))
                else:
                    out.append((refs[l], mvps[l]))
            return out
        # temporal direct (8.4.1.2.3)
        cm = self._col_motion(gx, gy)
        if cm is None:
            ref0, mvcol = 0, (0, 0)
        else:
            _, _, rid, mvcol = cm
            ref0 = 0
            for i, p in enumerate(self.ref_l0):
                if p.pic_id == rid:
                    ref0 = i
                    break
        refpic = self.ref_l0[ref0]
        colpic = self.ref_l1[0]
        tb = min(127, max(-128, self.pic.poc - refpic.poc))
        td = min(127, max(-128, colpic.poc - refpic.poc))
        if refpic.long_term or td == 0:
            return [(ref0, mvcol), (0, (0, 0))]
        q = 16384 + abs(td) // 2
        tx = (q // abs(td)) * (1 if td > 0 else -1)
        dsf = min(1023, max(-1024, (tb * tx + 32) >> 6))
        mv0 = ((dsf * mvcol[0] + 128) >> 8, (dsf * mvcol[1] + 128) >> 8)
        mv1 = (mv0[0] - mvcol[0], mv0[1] - mvcol[1])
        return [(ref0, mv0), (0, mv1)]

    def _decode_direct_8x8(self, b: int, predY, predU, predV) -> None:
        """Derive, store and motion-compensate one direct 8x8 block."""
        (r0, mv0), (r1, mv1) = self._direct_mvs_8x8(b)
        bx4, by4 = (b & 1) * 2, (b >> 1) * 2
        gx0 = self._cur_mbx * 4 + bx4
        gy0 = self._cur_mby * 4 + by4
        self.pic.cell_direct[gy0 : gy0 + 2, gx0 : gx0 + 2] = 1
        if r0 >= 0:
            self._store_part_mv(bx4, by4, 2, 2, r0, self.ref_l0[r0],
                                mv0[0], mv0[1], 0)
        if r1 >= 0:
            self._store_part_mv(bx4, by4, 2, 2, r1, self.ref_l1[r1],
                                mv1[0], mv1[1], 1)
        p0 = (self._fetch_pred(0, r0, bx4, by4, 2, 2, mv0[0], mv0[1])
              if r0 >= 0 else None)
        p1 = (self._fetch_pred(1, r1, bx4, by4, 2, 2, mv1[0], mv1[1])
              if r1 >= 0 else None)
        self._combine_store(predY, predU, predV, bx4, by4, 2, 2,
                            p0, p1, r0, r1)

    def decode_b_skip_mb(self, mb_idx: int) -> None:
        pic = self.pic
        mbx, mby = mb_idx % pic.mb_w, mb_idx // pic.mb_w
        self._mark_mb(mbx, mby)
        self._cur_mbx, self._cur_mby, self._cur_z = mbx, mby, 0
        self._direct_cache = None
        pic.mb_class[mby, mbx] = MB_B
        pic.mb_qp[mby, mbx] = self.qp
        pic.mb_cbp[mby, mbx] = 0
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        for b in range(4):
            self._decode_direct_8x8(b, predY, predU, predV)
        pic.Y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16] = predY
        pic.U[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8] = predU
        pic.V[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8] = predV

    def _decode_b_mb(self, r: BitReader, mbx: int, mby: int,
                     mb_type: int) -> None:
        pic = self.pic
        self._cur_mbx, self._cur_mby = mbx, mby
        self._cur_z = 0
        self._direct_cache = None
        pic.mb_class[mby, mbx] = MB_B
        n_act = self.h.num_ref_idx
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        if mb_type == 0:  # B_Direct_16x16
            for b in range(4):
                self._decode_direct_8x8(b, predY, predU, predV)
            self._cur_z = 16
            self._inter_residual(r, mbx, mby, predY, predU, predV,
                                 bool(self.sps.direct_8x8_inference))
            return
        tf8_ok = True
        if mb_type < 22:
            kind, preds = self._B_TYPES[mb_type]
            parts = self._PART_GEOM[kind]
            np_ = len(parts)
            refs = [[-1] * np_, [-1] * np_]
            for l in (0, 1):
                for i, pm in enumerate(preds):
                    if pm == 2 or pm == l:
                        refs[l][i] = self._read_te(r, n_act[l] - 1)
            mvds = [[(0, 0)] * np_, [(0, 0)] * np_]
            for l in (0, 1):
                for i, pm in enumerate(preds):
                    if pm == 2 or pm == l:
                        mvds[l][i] = (r.se(), r.se())
            mvs = [[None] * np_, [None] * np_]
            for l in (0, 1):
                for i, (bx4, by4, w4, h4) in enumerate(parts):
                    if refs[l][i] < 0:
                        continue
                    self._cur_z = _XY_TO_Z[(bx4, by4)]
                    px, py = self._mv_pred(bx4, by4, w4, h4, refs[l][i],
                                           kind, i, l)
                    mv = (px + mvds[l][i][0], py + mvds[l][i][1])
                    mvs[l][i] = mv
                    self._store_part_mv(bx4, by4, w4, h4, refs[l][i],
                                        (self.ref_l0, self.ref_l1)[l][refs[l][i]],
                                        mv[0], mv[1], l)
            for i, (bx4, by4, w4, h4) in enumerate(parts):
                p0 = (self._fetch_pred(0, refs[0][i], bx4, by4, w4, h4,
                                       *mvs[0][i]) if refs[0][i] >= 0 else None)
                p1 = (self._fetch_pred(1, refs[1][i], bx4, by4, w4, h4,
                                       *mvs[1][i]) if refs[1][i] >= 0 else None)
                self._combine_store(predY, predU, predV, bx4, by4, w4, h4,
                                    p0, p1, refs[0][i], refs[1][i])
        else:  # B_8x8
            sub_types = [r.ue() for _ in range(4)]
            if any(st > 12 for st in sub_types):
                raise EOFError_(f"bad B sub_mb_type {sub_types}")
            # direct sub-blocks derive/store both lists first, in order
            for b in range(4):
                if self._B_SUB[sub_types[b]][0] == -1:
                    self._cur_z = _XY_TO_Z[((b & 1) * 2, (b >> 1) * 2)]
                    self._decode_direct_8x8(b, predY, predU, predV)
            refs = [[-1] * 4, [-1] * 4]
            for l in (0, 1):
                for b in range(4):
                    pm = self._B_SUB[sub_types[b]][0]
                    if pm == 2 or pm == l:
                        refs[l][b] = self._read_te(r, n_act[l] - 1)
            mvds = [[], []]
            for l in (0, 1):
                for b in range(4):
                    pm, sparts = self._B_SUB[sub_types[b]]
                    if pm == -1 or not (pm == 2 or pm == l):
                        continue
                    for sp in sparts:
                        mvds[l].append((b, sp, (r.se(), r.se())))
            submvs = {}  # (l, b, sp) -> mv
            for l in (0, 1):
                for (b, sp, mvd) in mvds[l]:
                    sx, sy, w4, h4 = sp
                    bx4, by4 = (b & 1) * 2 + sx, (b >> 1) * 2 + sy
                    self._cur_z = _XY_TO_Z[(bx4, by4)]
                    px, py = self._mv_pred(bx4, by4, w4, h4, refs[l][b],
                                           l=l)
                    mv = (px + mvd[0], py + mvd[1])
                    submvs[(l, b, sp)] = mv
                    self._store_part_mv(bx4, by4, w4, h4, refs[l][b],
                                        (self.ref_l0, self.ref_l1)[l][refs[l][b]],
                                        mv[0], mv[1], l)
            for b in range(4):
                pm, sparts = self._B_SUB[sub_types[b]]
                if pm == -1:
                    continue
                for sp in sparts:
                    sx, sy, w4, h4 = sp
                    bx4, by4 = (b & 1) * 2 + sx, (b >> 1) * 2 + sy
                    p0 = p1 = None
                    if refs[0][b] >= 0:
                        p0 = self._fetch_pred(0, refs[0][b], bx4, by4, w4, h4,
                                              *submvs[(0, b, sp)])
                    if refs[1][b] >= 0:
                        p1 = self._fetch_pred(1, refs[1][b], bx4, by4, w4, h4,
                                              *submvs[(1, b, sp)])
                    self._combine_store(predY, predU, predV, bx4, by4, w4, h4,
                                        p0, p1, refs[0][b], refs[1][b])
            tf8_ok = all(
                (st == 0 and self.sps.direct_8x8_inference) or st in (1, 2, 3)
                for st in sub_types)
        self._cur_z = 16
        self._inter_residual(r, mbx, mby, predY, predU, predV, tf8_ok)
