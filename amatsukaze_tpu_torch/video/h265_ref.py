"""H.265/HEVC reference decoder (Python oracle).

In-build pixel decode for HEVC Main-profile streams: the reference
project decodes HEVC through FFmpeg (reference
Amatsukaze/ReaderWriterFFmpeg.hpp:256-483); this module removes that external
dependency for HEVC services the same way mpeg2_ref/h264_ref do for
the 2K broadcast codecs.  Validated bit-exactly against the system
libavcodec on libx265 streams (tests/test_h265_decode.py).

Clause references are ITU-T H.265 (04/2013).  The arithmetic decoding
engine (9.3.4.3) is identical to H.264's and is reused from
h264_cabac.CabacEngine; only context initialisation (9.3.2.2) and the
binarisations differ.

Scope (grown stage by stage like h264_ref):
  - Main profile 8-bit 4:2:0, single tile
  - all slice types, WPP (entropy_coding_sync), multiple slices
  - intra (35 modes, DST/DCT, strong smoothing), transform skip,
    transquant bypass, sign data hiding, cu_qp_delta

The port's copy of amatsukaze_tpu/video/h265_ref.py.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import BitReader
from . import h265_tables as T
from .h264_cabac import CabacEngine
from .h264_ref import split_annexb

# NAL unit types (Table 7-1)
NAL_TRAIL_N, NAL_TRAIL_R = 0, 1
NAL_BLA_W_LP, NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA = 16, 19, 20, 21
NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34

SLICE_B, SLICE_P, SLICE_I = 0, 1, 2

MODE_INTRA, MODE_INTER, MODE_SKIP = 1, 0, 2


def nal_to_rbsp(nal: bytes) -> tuple[bytes, list[int]]:
    """Strip emulation prevention; also return RBSP positions where a
    0x03 byte was removed (needed to translate entry-point offsets,
    which count EBSP bytes, into RBSP offsets)."""
    if b"\x00\x00\x03" not in nal:
        return nal, []
    out = bytearray()
    epb = []
    i, n = 0, len(nal)
    while True:
        j = nal.find(b"\x00\x00\x03", i)
        if j < 0:
            out += nal[i:]
            return bytes(out), epb
        out += nal[i : j + 2]
        epb.append(len(out))  # rbsp length when the 0x03 was dropped
        i = j + 3


def ebsp_off_to_rbsp(off: int, epb: list[int]) -> int:
    """EBSP byte offset (from NAL payload start) -> RBSP offset."""
    r = off
    for p in epb:
        if p <= r:
            r -= 1
        else:
            break
    return r


# ---------------------------------------------------------------------------
# Parameter sets (7.3.2)
# ---------------------------------------------------------------------------


def _ptl(r: BitReader, max_sub_layers_minus1: int) -> None:
    """profile_tier_level (7.3.3), contents skipped."""
    r.skip(8 + 32 + 48 + 8)
    sub = [(r.read(1), r.read(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1 > 0:
        r.skip(2 * (8 - max_sub_layers_minus1))
    for pp, lp in sub:
        if pp:
            r.skip(88)
        if lp:
            r.skip(8)


class ShortTermRPS:
    __slots__ = ("neg", "pos")

    def __init__(self, neg=(), pos=()):
        # neg: [(delta_poc(<0), used)], closest first; pos: (>0), closest first
        self.neg = list(neg)
        self.pos = list(pos)

    @property
    def num_delta_pocs(self) -> int:
        return len(self.neg) + len(self.pos)


def parse_strps(r: BitReader, idx: int, prev: list[ShortTermRPS],
                num_sets: int) -> ShortTermRPS:
    """st_ref_pic_set (7.3.7 + 7.4.8 derivation)."""
    inter = r.read(1) if idx != 0 else 0
    if inter:
        delta_idx = (r.ue() + 1) if idx == num_sets else 1
        ref = prev[idx - delta_idx]
        sign = r.read(1)
        delta_rps = (1 - 2 * sign) * (r.ue() + 1)
        nd = ref.num_delta_pocs
        flags = []
        for _ in range(nd + 1):
            used = r.read(1)
            use_delta = 1 if used else r.read(1)
            flags.append((used, use_delta))
        neg, pos = [], []
        # S0 (7.4.8): ref positives in reverse, deltaRps itself, ref negatives
        for j in range(len(ref.pos) - 1, -1, -1):
            dpoc = ref.pos[j][0] + delta_rps
            u, ud = flags[len(ref.neg) + j]
            if dpoc < 0 and ud:
                neg.append((dpoc, u))
        if delta_rps < 0 and flags[nd][1]:
            neg.append((delta_rps, flags[nd][0]))
        for j in range(len(ref.neg)):
            dpoc = ref.neg[j][0] + delta_rps
            u, ud = flags[j]
            if dpoc < 0 and ud:
                neg.append((dpoc, u))
        # S1: ref negatives in reverse, deltaRps, ref positives
        for j in range(len(ref.neg) - 1, -1, -1):
            dpoc = ref.neg[j][0] + delta_rps
            u, ud = flags[j]
            if dpoc > 0 and ud:
                pos.append((dpoc, u))
        if delta_rps > 0 and flags[nd][1]:
            pos.append((delta_rps, flags[nd][0]))
        for j in range(len(ref.pos)):
            dpoc = ref.pos[j][0] + delta_rps
            u, ud = flags[len(ref.neg) + j]
            if dpoc > 0 and ud:
                pos.append((dpoc, u))
        return ShortTermRPS(neg, pos)
    n_neg = r.ue()
    n_pos = r.ue()
    neg, pos = [], []
    d = 0
    for _ in range(n_neg):
        d -= r.ue() + 1
        neg.append((d, r.read(1)))
    d = 0
    for _ in range(n_pos):
        d += r.ue() + 1
        pos.append((d, r.read(1)))
    return ShortTermRPS(neg, pos)


def parse_scaling_list_data(r: BitReader) -> list:
    """scaling_list_data (7.3.4) -> ScalingFactor matrices per
    (sizeId, matrixId) as numpy arrays (7.4.5), with the DC coefficient
    already substituted for 16x16/32x32."""
    lists = [[None] * 6 for _ in range(4)]  # raw coef lists (diag order)
    dcs = [[16] * 6 for _ in range(4)]
    for size_id in range(4):
        n_mat = 2 if size_id == 3 else 6
        for mid in range(n_mat):
            if not r.read(1):  # scaling_list_pred_mode_flag == 0
                # 7.4.5: refMatrixId = matrixId - delta*(sizeId==3?3:1),
                # and for sizeId 3 the loop's matrixIds are 3*index --
                # so the LIST index steps by the raw delta either way
                delta = r.ue()
                if delta == 0:
                    lists[size_id][mid] = None  # default
                    dcs[size_id][mid] = 16
                else:
                    ref = mid - delta
                    if ref < 0:
                        raise ValueError("bad scaling list pred")
                    lists[size_id][mid] = lists[size_id][ref]
                    dcs[size_id][mid] = dcs[size_id][ref]
            else:
                ncoef = min(64, 1 << (4 + (size_id << 1)))
                dc = 16
                nxt = 8
                if size_id > 1:
                    dc = r.se() + 8
                    dcs[size_id][mid] = dc
                    nxt = dc  # 7.3.4: the delta chain starts at the DC
                coefs = []
                for _ in range(ncoef):
                    nxt = (nxt + r.se() + 256) % 256
                    coefs.append(nxt)
                lists[size_id][mid] = coefs
    return _scaling_factors(lists, dcs)


def default_scaling_factors() -> list:
    return _scaling_factors([[None] * 6 for _ in range(4)],
                            [[16] * 6 for _ in range(4)])


def _default_coefs(size_id: int, mid: int) -> list:
    if size_id == 0:
        return [16] * 16
    n_mat = 2 if size_id == 3 else 6
    intra = mid < (n_mat // 2) if size_id == 3 else mid < 3
    tab = (T.DEFAULT_SCALING_INTRA8 if intra
           else T.DEFAULT_SCALING_INTER8)
    # the default tables are raster 8x8; scaling lists are carried in
    # up-right diagonal order
    return [tab[y * 8 + x] for x, y in T.SCAN[0][3]]


def _scaling_factors(lists: list, dcs: list) -> list:
    out = [[None] * 6 for _ in range(4)]
    for size_id in range(4):
        n_mat = 2 if size_id == 3 else 6
        blk = 4 if size_id == 0 else 8
        scan = T.SCAN[0][2 if size_id == 0 else 3]
        for mid in range(n_mat):
            coefs = lists[size_id][mid]
            if coefs is None:
                coefs = _default_coefs(size_id, mid)
            base = np.zeros((blk, blk), np.int32)
            for i, (x, y) in enumerate(scan):
                base[y, x] = coefs[i]
            if size_id <= 1:
                out[size_id][mid] = base
            else:
                rep = 1 << (size_id - 1)  # 2 for 16x16, 4 for 32x32
                m = np.repeat(np.repeat(base, rep, 0), rep, 1)
                m[0, 0] = dcs[size_id][mid]
                out[size_id][mid] = m
    return out


class SPS:
    pass


def parse_sps(rbsp: bytes) -> SPS:
    r = BitReader(rbsp, 16)  # skip the 2-byte NAL header
    s = SPS()
    r.read(4)  # sps_video_parameter_set_id
    max_sub = r.read(3)
    r.read(1)  # temporal_id_nesting
    _ptl(r, max_sub)
    s.id = r.ue()
    s.chroma_format_idc = r.ue()
    if s.chroma_format_idc == 3:
        r.read(1)
    if s.chroma_format_idc != 1:
        raise NotImplementedError("only 4:2:0 supported")
    s.width = r.ue()
    s.height = r.ue()
    s.conf_win = (0, 0, 0, 0)
    if r.read(1):
        s.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())  # l, r, t, b
    s.bit_depth = r.ue() + 8
    s.bit_depth_c = r.ue() + 8
    if s.bit_depth != s.bit_depth_c or s.bit_depth not in (8, 10):
        raise NotImplementedError("only 8/10-bit 4:2:0 supported")
    s.log2_max_poc_lsb = r.ue() + 4
    sub_ordering = r.read(1)
    s.max_dec_pic_buffering = 0
    s.num_reorder = 0
    for _ in range((max_sub + 1) if sub_ordering else 1):
        s.max_dec_pic_buffering = r.ue() + 1
        s.num_reorder = r.ue()
        r.ue()  # max_latency_increase_plus1
    s.log2_min_cb = r.ue() + 3
    s.log2_ctb = s.log2_min_cb + r.ue()
    s.log2_min_tb = r.ue() + 2
    s.log2_max_tb = s.log2_min_tb + r.ue()
    s.max_trafo_depth_inter = r.ue()
    s.max_trafo_depth_intra = r.ue()
    s.scaling_list_enabled = r.read(1)
    s.scaling_factors = None
    if s.scaling_list_enabled:
        if r.read(1):  # sps_scaling_list_data_present
            s.scaling_factors = parse_scaling_list_data(r)
        else:
            s.scaling_factors = default_scaling_factors()
    s.amp_enabled = r.read(1)
    s.sao_enabled = r.read(1)
    s.pcm_enabled = r.read(1)
    s.pcm_loop_filter_disabled = 0
    if s.pcm_enabled:
        # 7.3.2.2.1: IPCM block geometry + sample bit depths
        s.pcm_bd = r.read(4) + 1
        s.pcm_bd_c = r.read(4) + 1
        s.log2_min_pcm = r.ue() + 3
        s.log2_max_pcm = s.log2_min_pcm + r.ue()
        s.pcm_loop_filter_disabled = r.read(1)
    n_sets = r.ue()
    s.strps = []
    for i in range(n_sets):
        s.strps.append(parse_strps(r, i, s.strps, n_sets))
    s.long_term_present = r.read(1)
    s.lt_poc_lsb, s.lt_used = [], []
    if s.long_term_present:
        for _ in range(r.ue()):
            s.lt_poc_lsb.append(r.read(s.log2_max_poc_lsb))
            s.lt_used.append(r.read(1))
    s.temporal_mvp_enabled = r.read(1)
    s.strong_intra_smoothing = r.read(1)
    # VUI and extensions not needed (timing comes from the TS layer)
    s.ctb_size = 1 << s.log2_ctb
    s.pic_w_ctbs = -(-s.width // s.ctb_size)
    s.pic_h_ctbs = -(-s.height // s.ctb_size)
    s.pic_size_ctbs = s.pic_w_ctbs * s.pic_h_ctbs
    return s


class PPS:
    pass


def parse_pps(rbsp: bytes, sps_map: dict[int, SPS]) -> PPS:
    r = BitReader(rbsp, 16)
    p = PPS()
    p.id = r.ue()
    p.sps_id = r.ue()
    p.sps = sps_map[p.sps_id]
    p.dependent_slices_enabled = r.read(1)
    p.output_flag_present = r.read(1)
    p.num_extra_slice_header_bits = r.read(3)
    p.sign_data_hiding = r.read(1)
    p.cabac_init_present = r.read(1)
    p.num_ref_l0_default = r.ue() + 1
    p.num_ref_l1_default = r.ue() + 1
    p.init_qp = r.se() + 26
    p.constrained_intra_pred = r.read(1)
    p.transform_skip_enabled = r.read(1)
    p.cu_qp_delta_enabled = r.read(1)
    p.diff_cu_qp_delta_depth = r.ue() if p.cu_qp_delta_enabled else 0
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets = r.read(1)
    p.weighted_pred = r.read(1)
    p.weighted_bipred = r.read(1)
    p.transquant_bypass_enabled = r.read(1)
    p.tiles_enabled = r.read(1)
    p.entropy_coding_sync = r.read(1)
    p.loop_filter_across_tiles = 1
    sps = p.sps
    if p.tiles_enabled:
        # 7.3.2.3.1 tile grid; 6.5.1 tile/CTB scan conversion tables
        ncols = r.ue() + 1
        nrows = r.ue() + 1
        if r.read(1):  # uniform_spacing_flag
            col_bd = [(i * sps.pic_w_ctbs) // ncols
                      for i in range(ncols + 1)]
            row_bd = [(i * sps.pic_h_ctbs) // nrows
                      for i in range(nrows + 1)]
        else:
            cw = [r.ue() + 1 for _ in range(ncols - 1)]
            rh = [r.ue() + 1 for _ in range(nrows - 1)]
            cw.append(sps.pic_w_ctbs - sum(cw))
            rh.append(sps.pic_h_ctbs - sum(rh))
            col_bd = [0]
            for v in cw:
                col_bd.append(col_bd[-1] + v)
            row_bd = [0]
            for v in rh:
                row_bd.append(row_bd[-1] + v)
        p.loop_filter_across_tiles = r.read(1)
        p.tile_cols, p.tile_rows = ncols, nrows
        p.col_bd, p.row_bd = col_bd, row_bd
        wc, hc = sps.pic_w_ctbs, sps.pic_h_ctbs
        tile_id = np.zeros(wc * hc, np.int32)
        rs_to_ts = np.zeros(wc * hc, np.int32)
        ts = 0
        for tj in range(nrows):
            for ti in range(ncols):
                tid = tj * ncols + ti
                for y in range(row_bd[tj], row_bd[tj + 1]):
                    for x in range(col_bd[ti], col_bd[ti + 1]):
                        rs = y * wc + x
                        tile_id[rs] = tid
                        rs_to_ts[rs] = ts
                        ts += 1
        ts_to_rs = np.zeros(wc * hc, np.int32)
        ts_to_rs[rs_to_ts] = np.arange(wc * hc)
        p.tile_id, p.rs_to_ts, p.ts_to_rs = tile_id, rs_to_ts, ts_to_rs
    else:
        p.tile_cols = p.tile_rows = 1
        n = sps.pic_size_ctbs
        p.tile_id = np.zeros(n, np.int32)
        p.rs_to_ts = p.ts_to_rs = np.arange(n, dtype=np.int32)
    p.loop_filter_across_slices = r.read(1)
    p.deblocking_override_enabled = 0
    p.deblocking_disabled = 0
    p.beta_offset = 0
    p.tc_offset = 0
    if r.read(1):  # deblocking_filter_control_present
        p.deblocking_override_enabled = r.read(1)
        p.deblocking_disabled = r.read(1)
        if not p.deblocking_disabled:
            p.beta_offset = 2 * r.se()
            p.tc_offset = 2 * r.se()
    p.scaling_factors = p.sps.scaling_factors
    if r.read(1):  # pps_scaling_list_data_present
        p.scaling_factors = parse_scaling_list_data(r)
    p.lists_modification_present = r.read(1)
    p.log2_parallel_merge_level = r.ue() + 2
    p.slice_header_extension = r.read(1)
    return p


# ---------------------------------------------------------------------------
# Slice segment header (7.3.6)
# ---------------------------------------------------------------------------


class SliceHeader:
    pass


def parse_slice_header(rbsp: bytes, nal_type: int,
                       sps_map: dict, pps_map: dict) -> SliceHeader:
    r = BitReader(rbsp, 16)
    h = SliceHeader()
    h.nal_type = nal_type
    h.first_slice = r.read(1)
    if NAL_BLA_W_LP <= nal_type <= 23:  # IRAP
        r.read(1)  # no_output_of_prior_pics_flag
    h.pps = pps_map[r.ue()]
    pps, sps = h.pps, h.pps.sps
    h.sps = sps
    h.dependent = 0
    h.segment_address = 0
    if not h.first_slice:
        if pps.dependent_slices_enabled:
            h.dependent = r.read(1)
        nbits = max(1, (sps.pic_size_ctbs - 1).bit_length())
        h.segment_address = r.read(nbits)
    h.slice_type = SLICE_I
    h.poc_lsb = 0
    h.strps = ShortTermRPS()
    h.lt = []  # [(poc_lsb_or_abs, used, has_msb, delta_msb)]
    h.temporal_mvp = 0
    h.sao_luma = h.sao_chroma = 0
    h.num_ref = [0, 0]
    h.rplm = (None, None)
    h.mvd_l1_zero = 0
    h.cabac_init_flag = 0
    h.collocated_from_l0 = 1
    h.collocated_ref_idx = 0
    h.max_merge = 5
    h.cb_qp_offset = h.cr_qp_offset = 0
    h.deblocking_disabled = pps.deblocking_disabled
    h.beta_offset = pps.beta_offset
    h.tc_offset = pps.tc_offset
    h.loop_filter_across_slices = pps.loop_filter_across_slices
    h.pred_weights = None
    if not h.dependent:
        for _ in range(pps.num_extra_slice_header_bits):
            r.read(1)
        h.slice_type = r.ue()
        if pps.output_flag_present:
            r.read(1)
        idr = nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)
        if not idr:
            h.poc_lsb = r.read(sps.log2_max_poc_lsb)
            if r.read(1):  # short_term_ref_pic_set_sps_flag
                idxbits = max(1, (len(sps.strps) - 1).bit_length())
                idx = r.read(idxbits) if len(sps.strps) > 1 else 0
                h.strps = sps.strps[idx]
            else:
                h.strps = parse_strps(r, len(sps.strps), sps.strps,
                                      len(sps.strps))
            if sps.long_term_present:
                n_sps = r.ue() if sps.lt_poc_lsb else 0
                n_slice = r.ue()
                prev_cum = 0
                for i in range(n_sps + n_slice):
                    if i < n_sps:
                        idxbits = max(1, (len(sps.lt_poc_lsb) - 1)
                                      .bit_length())
                        k = (r.read(idxbits)
                             if len(sps.lt_poc_lsb) > 1 else 0)
                        lsb, used = sps.lt_poc_lsb[k], sps.lt_used[k]
                    else:
                        lsb = r.read(sps.log2_max_poc_lsb)
                        used = r.read(1)
                    has_msb = r.read(1)
                    dmsb = r.ue() if has_msb else 0
                    # DeltaPocMsbCycleLt is cumulative within each of the
                    # SPS-sourced and slice-sourced runs (7.4.7.1)
                    if i in (0, n_sps):
                        cum = dmsb
                    else:
                        cum = dmsb + prev_cum
                    prev_cum = cum
                    h.lt.append((lsb, used, has_msb, cum))
            if sps.temporal_mvp_enabled:
                h.temporal_mvp = r.read(1)
        if sps.sao_enabled:
            h.sao_luma = r.read(1)
            h.sao_chroma = r.read(1)
        if h.slice_type in (SLICE_P, SLICE_B):
            h.num_ref = [pps.num_ref_l0_default, pps.num_ref_l1_default]
            if r.read(1):  # num_ref_idx_active_override
                h.num_ref[0] = r.ue() + 1
                if h.slice_type == SLICE_B:
                    h.num_ref[1] = r.ue() + 1
            npics = (sum(u for _, u in h.strps.neg)
                     + sum(u for _, u in h.strps.pos)
                     + sum(e[1] for e in h.lt))
            h.num_pics_total_curr = npics
            rplm = [None, None]
            if pps.lists_modification_present and npics > 1:
                nb = max(1, (npics - 1).bit_length())
                for lx in range(2 if h.slice_type == SLICE_B else 1):
                    if r.read(1):
                        rplm[lx] = [r.read(nb)
                                    for _ in range(h.num_ref[lx])]
            h.rplm = tuple(rplm)
            if h.slice_type == SLICE_B:
                h.mvd_l1_zero = r.read(1)
            if pps.cabac_init_present:
                h.cabac_init_flag = r.read(1)
            if h.temporal_mvp:
                if h.slice_type == SLICE_B:
                    h.collocated_from_l0 = r.read(1)
                lst = 0 if h.collocated_from_l0 else 1
                if h.num_ref[lst] > 1:
                    h.collocated_ref_idx = r.ue()
            if ((pps.weighted_pred and h.slice_type == SLICE_P)
                    or (pps.weighted_bipred and h.slice_type == SLICE_B)):
                h.pred_weights = _parse_pred_weights(r, h)
            h.max_merge = 5 - r.ue()
        h.slice_qp = pps.init_qp + r.se()
        if pps.slice_chroma_qp_offsets:
            h.cb_qp_offset = r.se()
            h.cr_qp_offset = r.se()
        if pps.deblocking_override_enabled and r.read(1):
            h.deblocking_disabled = r.read(1)
            if not h.deblocking_disabled:
                h.beta_offset = 2 * r.se()
                h.tc_offset = 2 * r.se()
        if pps.loop_filter_across_slices and (
                h.sao_luma or h.sao_chroma or not h.deblocking_disabled):
            h.loop_filter_across_slices = r.read(1)
    h.entry_points = []
    if pps.tiles_enabled or pps.entropy_coding_sync:
        n = r.ue()
        if n:
            ob = r.ue() + 1
            h.entry_points = [r.read(ob) + 1 for _ in range(n)]
    if pps.slice_header_extension:
        for _ in range(r.ue()):
            r.read(8)
    # byte_alignment(): alignment_bit_equal_to_one + zeros
    assert r.read(1) == 1
    while not r.is_byte_aligned():
        r.read(1)
    h.data_byte_pos = r.byte_pos()
    return h


def _parse_pred_weights(r: BitReader, h: SliceHeader):
    """pred_weight_table (7.3.6.3) -> per-list [(wY,oY,(wCb,oCb),(wCr,oCr))]."""
    luma_log2 = r.ue()
    chroma_log2 = luma_log2 + r.se()
    out = []
    for lx in range(2 if h.slice_type == SLICE_B else 1):
        n = h.num_ref[lx]
        lflags = [r.read(1) for _ in range(n)]
        cflags = [r.read(1) for _ in range(n)]
        ent = []
        for i in range(n):
            wy, oy = 1 << luma_log2, 0
            wcb = wcr = 1 << chroma_log2
            ocb = ocr = 0
            if lflags[i]:
                wy = (1 << luma_log2) + r.se()
                oy = r.se()
            if cflags[i]:
                dw = r.se()
                do = r.se()
                wcb = (1 << chroma_log2) + dw
                ocb = _clip3(-128, 127,
                             do + 128 - ((128 * wcb) >> chroma_log2))
                dw = r.se()
                do = r.se()
                wcr = (1 << chroma_log2) + dw
                ocr = _clip3(-128, 127,
                             do + 128 - ((128 * wcr) >> chroma_log2))
            ent.append((wy, oy, (wcb, ocb), (wcr, ocr)))
        out.append(ent)
    return luma_log2, chroma_log2, out


def _clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


# ---------------------------------------------------------------------------
# CABAC contexts (9.3.2.2)
# ---------------------------------------------------------------------------

CTX_OFFSETS: dict[str, int] = {}
_n = 0
for _k, _rows in T.CTX_INIT.items():
    CTX_OFFSETS[_k] = _n
    _n += len(_rows[0])
N_CONTEXTS = _n


def init_hevc_contexts(init_type: int, qp: int):
    q = _clip3(0, 51, qp)
    states = []
    for rows in T.CTX_INIT.values():
        for iv in rows[init_type]:
            m = (iv >> 4) * 5 - 45
            n = ((iv & 15) << 3) - 16
            pre = _clip3(1, 126, ((m * q) >> 4) + n)
            if pre <= 63:
                states.append([63 - pre, 0])
            else:
                states.append([pre - 64, 1])
    return states


class Cabac:
    """HEVC syntax-element layer over the shared arithmetic engine."""

    def __init__(self, rbsp: bytes, byte_pos: int, init_type: int, qp: int):
        self.e = CabacEngine(rbsp, byte_pos * 8,
                             init_hevc_contexts(init_type, qp))

    def decision(self, name: str, inc: int = 0) -> int:
        return self.e.decision(CTX_OFFSETS[name] + inc)

    def bypass(self) -> int:
        return self.e.bypass()

    def bypass_bits(self, n: int) -> int:
        v = 0
        e = self.e
        for _ in range(n):
            v = (v << 1) | e.bypass()
        return v

    def terminate(self) -> int:
        return self.e.terminate()

    def tr_bypass(self, cmax: int) -> int:
        """Truncated-rice prefix with cRiceParam=0, bypass bins."""
        v = 0
        while v < cmax and self.e.bypass():
            v += 1
        return v

    def eg_bypass(self, k: int) -> int:
        """k-th order Exp-Golomb, bypass bins (9.3.3.3-ish helper)."""
        n = 0
        while self.e.bypass():
            n += 1
        v = (1 << n) - 1
        return (v << k) + self.bypass_bits(n + k)

    def snapshot(self):
        return [st.copy() for st in self.e.ctx]

    def restore(self, snap):
        self.e.ctx = [st.copy() for st in snap]

    # -- PCM raw payload (7.3.8.7 / 9.3.1) --------------------------------
    # pcm_flag==1 (terminate bin, no renorm) leaves the engine's bit
    # position exact; pcm_alignment_zero_bit skips to the byte boundary,
    # samples are f(v) reads, then the arithmetic engine is re-initialised
    # with its context models preserved.

    def pcm_begin(self) -> None:
        e = self.e
        if e.pos & 7:
            e.pos += 8 - (e.pos & 7)

    def pcm_bits(self, n: int) -> int:
        e = self.e
        v = 0
        for _ in range(n):
            v = (v << 1) | e._bit()
        return v

    def pcm_plane(self, count: int, width: int, bd: int) -> "np.ndarray":
        e = self.e
        if bd == 8 and (e.pos & 7) == 0:  # byte-aligned fast path
            b0 = e.pos >> 3
            arr = np.frombuffer(e.data[b0:b0 + count],
                                np.uint8).astype(np.int32)
            e.pos += 8 * count
        else:
            arr = np.array([self.pcm_bits(bd) for _ in range(count)],
                           np.int32)
        return arr.reshape(-1, width)

    def pcm_end(self) -> None:
        e = self.e
        e.range_ = 510
        off = 0
        for _ in range(9):
            off = (off << 1) | e._bit()
        e.offset = off


# ---------------------------------------------------------------------------
# Transforms + dequant (8.6.3 / 8.6.4)
# ---------------------------------------------------------------------------

_DCT = {2: T.DCT4, 3: T.DCT8, 4: T.DCT16, 5: T.DCT32}


def dequant_block(coef: np.ndarray, qp: int, log2: int,
                  bd: int = 8, m=None) -> np.ndarray:
    """8.6.3 with flat (m=16) scaling lists, 8-bit."""
    shift = bd + log2 - 5
    if m is None:
        scale = 16 * T.LEVEL_SCALE[qp % 6] << (qp // 6)
        d = (coef.astype(np.int64) * scale + (1 << (shift - 1))) >> shift
    else:
        # 8.6.3 with scaling lists: the flat 16 becomes m[x][y]
        scale = np.asarray(m, np.int64) * T.LEVEL_SCALE[qp % 6] \
            << (qp // 6)
        d = (coef.astype(np.int64) * scale + (1 << (shift - 1))) >> shift
    return np.clip(d, -32768, 32767)


def inv_transform(d: np.ndarray, log2: int, dst: bool,
                  bd: int = 8) -> np.ndarray:
    """8.6.4.2: vertical then horizontal inverse, 16-bit intermediate
    clip, second-stage shift 20-BitDepth."""
    m = (T.DST4 if dst else _DCT[log2]).astype(np.int64)
    tmp = np.clip((m.T @ d.astype(np.int64) + 64) >> 7, -32768, 32767)
    return (tmp @ m + (1 << (19 - bd))) >> (20 - bd)


def residual_from_coeffs(coef: np.ndarray, qp: int, log2: int,
                         dst: bool, ts: bool, bypass: bool,
                         bd: int = 8, m=None) -> np.ndarray:
    if bypass:
        return coef.astype(np.int64)
    d = dequant_block(coef, qp, log2, bd, m)
    if ts:
        return ((d << 7) + (1 << (19 - bd))) >> (20 - bd)
    return inv_transform(d, log2, dst, bd)


# ---------------------------------------------------------------------------
# Intra prediction (8.4.4.2)
# ---------------------------------------------------------------------------


def _intra_refs(plane: np.ndarray, px: int, py: int, nT: int,
                avail_fn, bd: int = 8
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Reference sample gather + substitution (8.4.4.2.2).
    Returns (left[0..2nT-1], top[0..2nT-1], topleft)."""
    n2 = 2 * nT
    left = np.zeros(n2, np.int32)
    top = np.zeros(n2, np.int32)
    la = np.zeros(n2, bool)
    ta = np.zeros(n2, bool)
    hh, ww = plane.shape
    for i in range(n2):
        y = py + i
        if px > 0 and y < hh and avail_fn(px - 1, y):
            left[i] = plane[y, px - 1]
            la[i] = True
        x = px + i
        if py > 0 and x < ww and avail_fn(x, py - 1):
            top[i] = plane[py - 1, x]
            ta[i] = True
    tl, tla = 0, False
    if px > 0 and py > 0 and avail_fn(px - 1, py - 1):
        tl = int(plane[py - 1, px - 1])
        tla = True
    if not (tla or la.any() or ta.any()):
        half = 1 << (bd - 1)
        return (np.full(n2, half, np.int32),
                np.full(n2, half, np.int32), half)
    # substitution scan: left bottom-up, topleft, top left-to-right
    if not la[n2 - 1]:
        # first available in scan order
        v = None
        for i in range(n2 - 1, -1, -1):
            if la[i]:
                v = left[i]
                break
        if v is None:
            v = tl if tla else top[ta.argmax()]
        left[n2 - 1] = v
        la[n2 - 1] = True
    for i in range(n2 - 2, -1, -1):
        if not la[i]:
            left[i] = left[i + 1]
    if not tla:
        tl = int(left[0])
    for i in range(n2):
        if not ta[i]:
            top[i] = top[i - 1] if i > 0 else tl
    return left, top, tl


def _filter_refs(left, top, tl, nT: int, mode: int,
                 strong: bool, bd: int = 8
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """8.4.4.2.3 (luma only; caller gates on cIdx/size/mode)."""
    n2 = 2 * nT
    thr = 1 << (bd - 5)
    if strong and nT == 32 and (
            abs(tl + top[n2 - 1] - 2 * top[nT - 1]) < thr
            and abs(tl + left[n2 - 1] - 2 * left[nT - 1]) < thr):
        ftop = np.empty(n2, np.int32)
        fleft = np.empty(n2, np.int32)
        for x in range(n2 - 1):
            ftop[x] = ((63 - x) * tl + (x + 1) * top[n2 - 1] + 32) >> 6
            fleft[x] = ((63 - x) * tl + (x + 1) * left[n2 - 1] + 32) >> 6
        ftop[n2 - 1] = top[n2 - 1]
        fleft[n2 - 1] = left[n2 - 1]
        return fleft, ftop, tl
    ftl = (left[0] + 2 * tl + top[0] + 2) >> 2
    ftop = np.empty(n2, np.int32)
    fleft = np.empty(n2, np.int32)
    ftop[0] = (tl + 2 * top[0] + top[1] + 2) >> 2
    fleft[0] = (tl + 2 * left[0] + left[1] + 2) >> 2
    for i in range(1, n2 - 1):
        ftop[i] = (top[i - 1] + 2 * top[i] + top[i + 1] + 2) >> 2
        fleft[i] = (left[i - 1] + 2 * left[i] + left[i + 1] + 2) >> 2
    ftop[n2 - 1] = top[n2 - 1]
    fleft[n2 - 1] = left[n2 - 1]
    return fleft, ftop, int(ftl)


def intra_predict(plane: np.ndarray, px: int, py: int, nT: int, mode: int,
                  cIdx: int, avail_fn, strong_smoothing: bool,
                  bd: int = 8) -> np.ndarray:
    """8.4.4.2.4-6 -> predicted block (nT x nT int32)."""
    left, top, tl = _intra_refs(plane, px, py, nT, avail_fn, bd)
    if cIdx == 0 and mode != 1 and nT > 4:
        mindist = min(abs(mode - 26), abs(mode - 10))
        thr = {8: 7, 16: 1, 32: 0}[nT]
        if mindist > thr:
            left, top, tl = _filter_refs(left, top, tl, nT, mode,
                                         strong_smoothing, bd)
    pred = np.empty((nT, nT), np.int32)
    if mode == 0:  # planar (8.4.4.2.4)
        xs = np.arange(nT)
        tr = int(top[nT])
        bl = int(left[nT])
        for y in range(nT):
            pred[y] = ((nT - 1 - xs) * left[y] + (xs + 1) * tr
                       + (nT - 1 - y) * top[:nT] + (y + 1) * bl
                       + nT) >> (nT.bit_length())  # log2(nT)+1
        return pred
    if mode == 1:  # DC (8.4.4.2.5)
        dc = (int(top[:nT].sum()) + int(left[:nT].sum()) + nT) >> (
            nT.bit_length())
        pred[:] = dc
        if cIdx == 0 and nT < 32:
            pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            pred[0, 1:] = (top[1:nT] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:nT] + 3 * dc + 2) >> 2
        return pred
    # angular (8.4.4.2.6)
    ang = T.INTRA_PRED_ANGLE[mode - 2]
    if mode >= 18:  # near-vertical: main = top
        ref = np.zeros(3 * nT + 1, np.int32)  # index bias nT: ref[nT+i]=p[i-1][-1]
        ref[nT] = tl
        ref[nT + 1:nT + 1 + 2 * nT] = top
        if ang < 0:
            inv = T.INV_ANGLE[ang]
            lo = (nT * ang) >> 5
            for x in range(-1, lo, -1):  # ref[lo] is never read
                idx = ((x * inv + 128) >> 8) - 1
                ref[nT + x] = tl if idx < 0 else left[idx]
        for y in range(nT):
            ii = ((y + 1) * ang) >> 5
            fact = ((y + 1) * ang) & 31
            base = nT + 1 + ii
            if fact:
                pred[y] = ((32 - fact) * ref[base:base + nT]
                           + fact * ref[base + 1:base + 1 + nT] + 16) >> 5
            else:
                pred[y] = ref[base:base + nT]
        if mode == 26 and cIdx == 0 and nT < 32:
            col = top[0] + ((left[:nT] - tl) >> 1)
            pred[:, 0] = np.clip(col, 0, (1 << bd) - 1)
        return pred
    # near-horizontal: main = left (transpose of the vertical case)
    ref = np.zeros(3 * nT + 1, np.int32)
    ref[nT] = tl
    ref[nT + 1:nT + 1 + 2 * nT] = left
    if ang < 0:
        inv = T.INV_ANGLE[ang]
        lo = (nT * ang) >> 5
        for x in range(-1, lo, -1):  # ref[lo] is never read
            idx = ((x * inv + 128) >> 8) - 1
            ref[nT + x] = tl if idx < 0 else top[idx]
    for x in range(nT):
        ii = ((x + 1) * ang) >> 5
        fact = ((x + 1) * ang) & 31
        base = nT + 1 + ii
        if fact:
            pred[:, x] = ((32 - fact) * ref[base:base + nT]
                          + fact * ref[base + 1:base + 1 + nT] + 16) >> 5
        else:
            pred[:, x] = ref[base:base + nT]
    if mode == 10 and cIdx == 0 and nT < 32:
        row = left[0] + ((top[:nT] - tl) >> 1)
        pred[0] = np.clip(row, 0, (1 << bd) - 1)
    return pred


# ---------------------------------------------------------------------------
# Picture state
# ---------------------------------------------------------------------------


class _Picture:
    def __init__(self, sps: SPS, pps: PPS):
        self.sps, self.pps = sps, pps
        wp = sps.pic_w_ctbs << sps.log2_ctb
        hp = sps.pic_h_ctbs << sps.log2_ctb
        dt = np.uint16 if sps.bit_depth > 8 else np.uint8
        self.Y = np.zeros((hp, wp), dt)
        self.U = np.zeros((hp >> 1, wp >> 1), dt)
        self.V = np.zeros((hp >> 1, wp >> 1), dt)
        g = (hp >> 2, wp >> 2)
        self.avail = np.zeros(g, bool)        # samples reconstructed
        self.decided = np.zeros(g, bool)      # mode info parsed (z-scan)
        self.slice_id = np.full(g, -1, np.int32)
        self.ctdepth = np.zeros(g, np.uint8)
        self.intra_mode = np.ones(g, np.uint8)
        self.is_intra = np.zeros(g, bool)
        self.skip = np.zeros(g, bool)
        self.qp = np.zeros(g, np.int16)
        self.bypass = np.zeros(g, bool)       # cu_transquant_bypass
        self.nnz = np.zeros(g, bool)          # TU had cbf_luma
        self.tu_edge_v = np.zeros(g, bool)    # TU/PU left edge at this col
        self.tu_edge_h = np.zeros(g, bool)    # TU/PU top edge at this row
        cg = (sps.pic_h_ctbs, sps.pic_w_ctbs)
        self.sao_type = np.zeros(cg + (3,), np.int8)
        self.sao_offsets = np.zeros(cg + (3, 4), np.int16)
        self.sao_band_pos = np.zeros(cg + (3,), np.int8)
        self.sao_eo_class = np.zeros(cg + (3,), np.int8)
        # motion field (per 4x4): quarter-pel MVs, per-list use, ref POC
        self.mv = np.zeros(g + (2, 2), np.int16)
        self.mv_used = np.zeros(g + (2,), bool)
        self.ref_poc = np.zeros(g + (2,), np.int32)
        self.ref_idx = np.zeros(g + (2,), np.int8)
        self.ref_lt = np.zeros(g + (2,), bool)  # ref was long-term
        self.pu_edge_v = np.zeros(g, bool)
        self.pu_edge_h = np.zeros(g, bool)
        self.poc = 0
        self.nal_type = 0
        self.referenced = True

    def output(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        s = self.sps
        cl, cr, ct, cb = s.conf_win
        w = s.width - 2 * (cl + cr)
        h = s.height - 2 * (ct + cb)
        y = self.Y[2 * ct:2 * ct + h, 2 * cl:2 * cl + w].copy()
        u = self.U[ct:ct + h // 2, cl:cl + w // 2].copy()
        v = self.V[ct:ct + h // 2, cl:cl + w // 2].copy()
        return y, u, v


# PU partition modes (Table 7-10)
(PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN,
 PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N) = range(8)


def _pu_geometry(part: int, s: int) -> list[tuple[int, int, int, int]]:
    h2, q = s >> 1, s >> 2
    return {
        PART_2Nx2N: [(0, 0, s, s)],
        PART_2NxN: [(0, 0, s, h2), (0, h2, s, h2)],
        PART_Nx2N: [(0, 0, h2, s), (h2, 0, h2, s)],
        PART_NxN: [(0, 0, h2, h2), (h2, 0, h2, h2),
                   (0, h2, h2, h2), (h2, h2, h2, h2)],
        PART_2NxnU: [(0, 0, s, q), (0, q, s, s - q)],
        PART_2NxnD: [(0, 0, s, s - q), (0, s - q, s, q)],
        PART_nLx2N: [(0, 0, q, s), (q, 0, s - q, s)],
        PART_nRx2N: [(0, 0, s - q, s), (s - q, 0, q, s)],
    }[part]


def _wrap16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def _mv_scale(mv: int, tb: int, td: int) -> int:
    """8.5.3.2.8 POC-distance MV scaling."""
    td = _clip3(-128, 127, td)
    tb = _clip3(-128, 127, tb)
    q = (16384 + (abs(td) >> 1)) // abs(td)
    tx = q if td > 0 else -q
    dsf = _clip3(-4096, 4095, (tb * tx + 32) >> 6)
    v = dsf * mv
    s = -1 if v < 0 else 1
    return _clip3(-32768, 32767, s * ((abs(v) + 127) >> 8))


# scan-position lookup: (scanIdx, log2size) -> {(x,y): index}
_SCAN_POS = {
    (si, k): {xy: i for i, xy in enumerate(tab)}
    for si, sub in T.SCAN.items() for k, tab in sub.items()
}
_SB_ORIGIN = [((0, 0),)]  # 1x1 sub-block grid


def _sb_scan(scan_idx: int, log2sb: int):
    if log2sb == 0:
        return _SB_ORIGIN[0]
    return T.SCAN[scan_idx][log2sb]


# ---------------------------------------------------------------------------
# Slice decoding
# ---------------------------------------------------------------------------


class _SliceDec:
    def __init__(self, dec: "H265RefDecoder", pic: _Picture, h: SliceHeader,
                 rbsp: bytes, epb: list[int], slice_id: int):
        self.dec = dec
        self.pic = pic
        self.h = h
        self.sps: SPS = h.sps
        self.pps: PPS = h.pps
        self.slice_id = slice_id
        self.rbsp = rbsp
        if h.slice_type == SLICE_I:
            self.init_type = 0
        elif h.slice_type == SLICE_P:
            self.init_type = 2 if h.cabac_init_flag else 1
        else:
            self.init_type = 1 if h.cabac_init_flag else 2
        # substream RBSP byte offsets (entry points count EBSP bytes)
        ebsp_data = h.data_byte_pos + sum(
            1 for p in epb if p <= h.data_byte_pos)
        starts = [h.data_byte_pos]
        off = ebsp_data
        for ep in h.entry_points:
            off += ep
            starts.append(ebsp_off_to_rbsp(off, epb))
        self.substreams = starts
        self.sub_idx = 0
        self.c = Cabac(rbsp, starts[0], self.init_type, h.slice_qp)
        self.wpp_snap: dict[int, list] = {}
        self.qp_prev = h.slice_qp
        self.last_cu_qp = h.slice_qp
        self.is_delta_coded = False
        self.delta_val = 0
        self.qg_x = self.qg_y = 0
        self.log2_min_qg = (self.sps.log2_ctb
                            - self.pps.diff_cu_qp_delta_depth)
        self.refs: tuple[list, list] = ([], [])
        self.refs_lt: tuple[list, list] = ([], [])
        self.col_pic: _Picture | None = None
        self.no_backward = True
        self.cur_tile = 0  # tile id of the CTU being decoded

    # -- availability ------------------------------------------------------

    def _zavail(self, x: int, y: int, parse: bool) -> bool:
        """6.4.1 z-scan availability of the block covering luma (x,y).
        parse=True checks parse-order (mode info); False checks
        reconstructed samples. Blocks in a different slice or a
        different tile are unavailable."""
        if x < 0 or y < 0 or x >= self.sps.width or y >= self.sps.height:
            return False
        p = self.pic
        i = (y >> 2, x >> 2)
        grid = p.decided if parse else p.avail
        if not grid[i] or p.slice_id[i] != self.slice_id:
            return False
        if self.pps.tiles_enabled:
            sps = self.sps
            rs = ((y >> sps.log2_ctb) * sps.pic_w_ctbs
                  + (x >> sps.log2_ctb))
            if self.pps.tile_id[rs] != self.cur_tile:
                return False
        return True

    def _sample_avail_luma(self, x: int, y: int) -> bool:
        if not self._zavail(x, y, parse=False):
            return False
        if self.pps.constrained_intra_pred:
            return bool(self.pic.is_intra[y >> 2, x >> 2])
        return True

    def _sample_avail_chroma(self, xc: int, yc: int) -> bool:
        return self._sample_avail_luma(xc << 1, yc << 1)

    # -- QP ------------------------------------------------------------------

    def _qg_reset(self, x0: int, y0: int) -> None:
        self.is_delta_coded = False
        self.delta_val = 0
        self.qg_x, self.qg_y = x0, y0
        self.qp_prev = self.last_cu_qp

    def _cu_qp(self) -> int:
        if self.cur_cu_qp is None:
            xq, yq = self.qg_x, self.qg_y
            ctb = 1 << self.sps.log2_ctb
            qa = qb = self.qp_prev
            if (xq % ctb) and self._zavail(xq - 1, yq, parse=True):
                qa = int(self.pic.qp[yq >> 2, (xq - 1) >> 2])
            if (yq % ctb) and self._zavail(xq, yq - 1, parse=True):
                qb = int(self.pic.qp[(yq - 1) >> 2, xq >> 2])
            pred = (qa + qb + 1) >> 1
            qbd = 6 * (self.sps.bit_depth - 8)
            self.cur_cu_qp = ((pred + self.delta_val + 52 + 2 * qbd)
                              % (52 + qbd)) - qbd
        return self.cur_cu_qp

    # -- slice data loop -----------------------------------------------------

    def run(self) -> None:
        sps = self.sps
        pps = self.pps
        wctb = sps.pic_w_ctbs
        sync = pps.entropy_coding_sync
        tiles = pps.tiles_enabled
        ts_to_rs = pps.ts_to_rs
        # slice_segment_address is in raster scan; decode order is tile
        # scan (6.5.1)
        ctb_ts = int(pps.rs_to_ts[self.h.segment_address])
        while True:
            ctb_addr = int(ts_to_rs[ctb_ts])
            self.cur_tile = int(pps.tile_id[ctb_addr])
            cx = (ctb_addr % wctb) << sps.log2_ctb
            cy = (ctb_addr // wctb) << sps.log2_ctb
            self._decode_ctu(cx, cy)
            if sync and ((ctb_addr % wctb == 1)
                         or (wctb == 1 and ctb_addr % wctb == 0)):
                self.wpp_snap[ctb_addr // wctb] = self.c.snapshot()
            end = self.c.terminate()
            ctb_ts += 1
            if end or ctb_ts >= sps.pic_size_ctbs:
                break
            nxt_rs = int(ts_to_rs[ctb_ts])
            new_tile = tiles and \
                pps.tile_id[nxt_rs] != pps.tile_id[ctb_addr]
            new_row = sync and nxt_rs % wctb == 0
            if new_tile or new_row:
                # end_of_subset_one_bit + byte alignment -> next substream
                one = self.c.terminate()
                assert one == 1
                self.sub_idx += 1
                self.c = Cabac(self.rbsp, self.substreams[self.sub_idx],
                               self.init_type, self.h.slice_qp)
                if new_row:
                    snap = self.wpp_snap.get(nxt_rs // wctb - 1)
                    if snap is not None:
                        self.c.restore(snap)
                # a new tile re-initialises contexts (9.3.1); both reset
                # the QP predictor (8.6.1)
                self.qp_prev = self.h.slice_qp
                self.last_cu_qp = self.h.slice_qp

    def _decode_ctu(self, x0: int, y0: int) -> None:
        if self.h.sao_luma or self.h.sao_chroma:
            self._parse_sao(x0, y0)
        self._coding_quadtree(x0, y0, self.sps.log2_ctb, 0)

    def _parse_sao(self, x0: int, y0: int) -> None:
        """sao(rx, ry) syntax (7.3.8.3)."""
        c = self.c
        pic = self.pic
        rx = x0 >> self.sps.log2_ctb
        ry = y0 >> self.sps.log2_ctb
        # merge candidates must share the slice AND the tile (7.4.9.3)
        wc = self.sps.pic_w_ctbs
        tid = self.pps.tile_id

        def same_tile(nrx, nry):
            return (not self.pps.tiles_enabled
                    or tid[nry * wc + nrx] == tid[ry * wc + rx])

        if rx > 0 and same_tile(rx - 1, ry) and \
                self.pic.slice_id[y0 >> 2, (x0 - 1) >> 2] == \
                self.slice_id and c.decision("sao_merge_flag"):
            src = (ry, rx - 1)
            pic.sao_type[ry, rx] = pic.sao_type[src]
            pic.sao_offsets[ry, rx] = pic.sao_offsets[src]
            pic.sao_band_pos[ry, rx] = pic.sao_band_pos[src]
            pic.sao_eo_class[ry, rx] = pic.sao_eo_class[src]
            return
        if ry > 0 and same_tile(rx, ry - 1) and \
                self.pic.slice_id[(y0 - 1) >> 2, x0 >> 2] == \
                self.slice_id and c.decision("sao_merge_flag"):
            src = (ry - 1, rx)
            pic.sao_type[ry, rx] = pic.sao_type[src]
            pic.sao_offsets[ry, rx] = pic.sao_offsets[src]
            pic.sao_band_pos[ry, rx] = pic.sao_band_pos[src]
            pic.sao_eo_class[ry, rx] = pic.sao_eo_class[src]
            return
        for ci in range(3):
            if ci == 0 and not self.h.sao_luma:
                continue
            if ci > 0 and not self.h.sao_chroma:
                continue
            if ci == 2:
                # Cr shares type/eo-class with Cb, own offsets/band pos
                typ = int(pic.sao_type[ry, rx, 1])
            else:
                typ = 0
                if c.decision("sao_type_idx"):
                    typ = 2 if c.bypass() else 1
            pic.sao_type[ry, rx, ci] = typ
            if typ == 0:
                continue
            cmax = (1 << (min(self.sps.bit_depth, 10) - 5)) - 1
            offs = [c.tr_bypass(cmax) for _ in range(4)]
            if typ == 1:  # band
                for i in range(4):
                    if offs[i] and c.bypass():
                        offs[i] = -offs[i]
                pic.sao_band_pos[ry, rx, ci] = c.bypass_bits(5)
            else:  # edge: offsets 0,1 positive; 2,3 negative
                offs[2] = -offs[2]
                offs[3] = -offs[3]
                if ci == 2:
                    pic.sao_eo_class[ry, rx, 2] = pic.sao_eo_class[ry, rx, 1]
                else:
                    pic.sao_eo_class[ry, rx, ci] = c.bypass_bits(2)
            pic.sao_offsets[ry, rx, ci] = offs

    # -- quadtree ------------------------------------------------------------

    def _coding_quadtree(self, x0: int, y0: int, log2: int,
                         depth: int) -> None:
        sps = self.sps
        size = 1 << log2
        inside = (x0 + size <= sps.width) and (y0 + size <= sps.height)
        if inside and log2 > sps.log2_min_cb:
            inc = 0
            if self._zavail(x0 - 1, y0, parse=True) and \
                    self.pic.ctdepth[y0 >> 2, (x0 - 1) >> 2] > depth:
                inc += 1
            if self._zavail(x0, y0 - 1, parse=True) and \
                    self.pic.ctdepth[(y0 - 1) >> 2, x0 >> 2] > depth:
                inc += 1
            split = self.c.decision("split_cu_flag", inc)
        else:
            split = 1 if log2 > sps.log2_min_cb else 0
        if self.pps.cu_qp_delta_enabled and log2 >= self.log2_min_qg:
            self._qg_reset(x0, y0)
        if split:
            half = size >> 1
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < sps.width and y1 < sps.height:
                    self._coding_quadtree(x1, y1, log2 - 1, depth + 1)
        else:
            self._coding_unit(x0, y0, log2, depth)

    # -- coding unit (intra) ---------------------------------------------------

    def _coding_unit(self, x0: int, y0: int, log2: int, depth: int) -> None:
        c = self.c
        pic = self.pic
        pps = self.pps
        size = 1 << log2
        self.cur_cu = (x0, y0, log2)
        self.cur_cu_qp = None
        self.cu_bypass = False
        self.cu_depth = depth
        g = (slice(y0 >> 2, (y0 + size) >> 2),
             slice(x0 >> 2, (x0 + size) >> 2))
        pic.ctdepth[g] = depth
        pic.slice_id[g] = self.slice_id
        skip = False
        if self.h.slice_type != SLICE_I:
            inc = 0
            if self._zavail(x0 - 1, y0, parse=True) and \
                    pic.skip[y0 >> 2, (x0 - 1) >> 2]:
                inc += 1
            if self._zavail(x0, y0 - 1, parse=True) and \
                    pic.skip[(y0 - 1) >> 2, x0 >> 2]:
                inc += 1
            skip = bool(c.decision("cu_skip_flag", inc))
        if skip:
            pic.skip[g] = True
            pic.is_intra[g] = False
            self._prediction_unit(x0, y0, size, size, 0, PART_2Nx2N,
                                  skip_cu=True)
            self._mark_pu_edges(x0, y0, size, size)
            self._finish_cu(x0, y0, size, g)
            return
        pic.skip[g] = False
        if pps.transquant_bypass_enabled:
            self.cu_bypass = bool(c.decision("cu_transquant_bypass_flag"))
        pic.bypass[g] = self.cu_bypass
        intra = True
        if self.h.slice_type != SLICE_I:
            intra = bool(c.decision("pred_mode_flag"))
        if intra:
            self._cu_intra(x0, y0, log2, depth, g)
        else:
            self._cu_inter(x0, y0, log2, depth, g)

    def _finish_cu(self, x0: int, y0: int, size: int, g) -> None:
        pic = self.pic
        # CU boundaries are transform-block edges for deblocking even when
        # no residual is coded (skip / rqt_root_cbf=0), 8.7.2.
        pic.tu_edge_v[g[0], x0 >> 2] = True
        pic.tu_edge_h[y0 >> 2, g[1]] = True
        pic.qp[g] = self._cu_qp()
        self.last_cu_qp = self.cur_cu_qp
        pic.avail[g] = True
        pic.decided[g] = True

    def _mark_pu_edges(self, xp: int, yp: int, w: int, h: int) -> None:
        pic = self.pic
        pic.pu_edge_v[yp >> 2:(yp + h) >> 2, xp >> 2] = True
        pic.pu_edge_h[yp >> 2, xp >> 2:(xp + w) >> 2] = True

    def _cu_intra(self, x0: int, y0: int, log2: int, depth: int, g) -> None:
        c = self.c
        pic = self.pic
        sps = self.sps
        size = 1 << log2
        pic.is_intra[g] = True
        part_nxn = False
        if log2 == sps.log2_min_cb:
            if not c.decision("part_mode"):
                part_nxn = True
        if (sps.pcm_enabled and not part_nxn
                and sps.log2_min_pcm <= log2 <= sps.log2_max_pcm
                and c.terminate()):  # pcm_flag (9.3.3.6 terminate bin)
            self._pcm_cu(x0, y0, log2, g)
            return
        n_pu = 4 if part_nxn else 1
        pbs = size >> (1 if part_nxn else 0)
        prev_flags = [c.decision("prev_intra_luma_pred_flag")
                      for _ in range(n_pu)]
        raw = []
        for i in range(n_pu):
            if prev_flags[i]:
                idx = 0
                if c.bypass():
                    idx = 1 + c.bypass()
                raw.append(("mpm", idx))
            else:
                raw.append(("rem", c.bypass_bits(5)))
        modes = []
        for i in range(n_pu):
            xp = x0 + (i & 1) * pbs
            yp = y0 + (i >> 1) * pbs
            cand_a = cand_b = 1  # DC
            if self._zavail(xp - 1, yp, parse=True):
                gi = (yp >> 2, (xp - 1) >> 2)
                if pic.is_intra[gi]:
                    cand_a = int(pic.intra_mode[gi])
            if (yp % (1 << sps.log2_ctb)) and \
                    self._zavail(xp, yp - 1, parse=True):
                gi = ((yp - 1) >> 2, xp >> 2)
                if pic.is_intra[gi]:
                    cand_b = int(pic.intra_mode[gi])
            if cand_a == cand_b:
                if cand_a < 2:
                    mpm = [0, 1, 26]
                else:
                    mpm = [cand_a, 2 + ((cand_a + 29) % 32),
                           2 + ((cand_a - 2 + 1) % 32)]
            else:
                third = 0 if 0 not in (cand_a, cand_b) else (
                    1 if 1 not in (cand_a, cand_b) else 26)
                mpm = [cand_a, cand_b, third]
            kind, v = raw[i]
            if kind == "mpm":
                mode = mpm[v]
            else:
                mode = v
                for m in sorted(mpm):
                    if mode >= m:
                        mode += 1
            modes.append(mode)
            gp = (slice(yp >> 2, (yp + pbs) >> 2),
                  slice(xp >> 2, (xp + pbs) >> 2))
            pic.intra_mode[gp] = mode
            pic.decided[gp] = True
        if not c.decision("intra_chroma_pred_mode"):
            chroma_mode = modes[0]
        else:
            idx = c.bypass_bits(2)
            cand = (0, 26, 10, 1)[idx]
            chroma_mode = 34 if cand == modes[0] else cand
        self.cu_modes = modes
        self.cu_pbs = pbs
        self.cu_chroma_mode = chroma_mode
        self.cu_intra_split = part_nxn
        self.cu_is_intra = True
        self._transform_tree(x0, y0, x0, y0, log2, 0, 0, 1, 1)
        self._finish_cu(x0, y0, size, g)

    def _pcm_cu(self, x0: int, y0: int, log2: int, g) -> None:
        """pcm_sample (7.3.8.7): raw luma + chroma at the PCM bit depths,
        left-shifted to the picture depth (8.4.4.1)."""
        sps, pic, c = self.sps, self.pic, self.c
        size = 1 << log2
        c.pcm_begin()
        ylum = c.pcm_plane(size * size, size, sps.pcm_bd) \
            << (sps.bit_depth - sps.pcm_bd)
        half = size >> 1
        sh_c = sps.bit_depth - sps.pcm_bd_c
        cbs = c.pcm_plane(half * half, half, sps.pcm_bd_c) << sh_c
        crs = c.pcm_plane(half * half, half, sps.pcm_bd_c) << sh_c
        c.pcm_end()
        dt = pic.Y.dtype
        pic.Y[y0:y0 + size, x0:x0 + size] = ylum.astype(dt)
        pic.U[y0 >> 1:(y0 >> 1) + half,
              x0 >> 1:(x0 >> 1) + half] = cbs.astype(dt)
        pic.V[y0 >> 1:(y0 >> 1) + half,
              x0 >> 1:(x0 >> 1) + half] = crs.astype(dt)
        pic.intra_mode[g] = 1  # PCM counts as DC for neighbour MPM (8.4.2)
        pic.skip[g] = False
        pic.nnz[g] = False
        if sps.pcm_loop_filter_disabled:
            pic.bypass[g] = True  # samples exempt from deblock/SAO (8.7)
        self._finish_cu(x0, y0, size, g)

    # -- transform tree --------------------------------------------------------

    def _transform_tree(self, x0, y0, x_base, y_base, log2, depth, blk_idx,
                        pcb, pcr) -> None:
        c = self.c
        sps = self.sps
        intra_split = self.cu_is_intra and self.cu_intra_split
        inter_split = (not self.cu_is_intra and depth == 0
                       and self.cu_inter_split)
        if self.cu_is_intra:
            max_depth = sps.max_trafo_depth_intra + (1 if intra_split
                                                     else 0)
        else:
            max_depth = sps.max_trafo_depth_inter
        if (log2 <= sps.log2_max_tb and log2 > sps.log2_min_tb
                and depth < max_depth and not (intra_split and depth == 0)):
            split = c.decision("split_transform_flag", 5 - log2)
        else:
            split = 1 if (log2 > sps.log2_max_tb
                          or (intra_split and depth == 0)
                          or inter_split) else 0
        cbf_cb, cbf_cr = pcb, pcr
        if log2 > 2:
            if depth == 0 or pcb:
                cbf_cb = c.decision("cbf_chroma", depth)
            if depth == 0 or pcr:
                cbf_cr = c.decision("cbf_chroma", depth)
        if split:
            half = 1 << (log2 - 1)
            for i, (dx, dy) in enumerate(
                    ((0, 0), (half, 0), (0, half), (half, half))):
                self._transform_tree(x0 + dx, y0 + dy, x0, y0, log2 - 1,
                                     depth + 1, i, cbf_cb, cbf_cr)
            return
        if self.cu_is_intra or depth != 0 or cbf_cb or cbf_cr:
            cbf_luma = c.decision("cbf_luma", 1 if depth == 0 else 0)
        else:
            cbf_luma = 1  # inter root with no chroma cbf: inferred
        self._transform_unit(x0, y0, x_base, y_base, log2, depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

    # -- transform unit (intra recon) ------------------------------------------

    def _transform_unit(self, x0, y0, x_base, y_base, log2, depth, blk_idx,
                        cbf_l, cbf_cb, cbf_cr) -> None:
        c = self.c
        pic = self.pic
        pps = self.pps
        size = 1 << log2
        if (cbf_l or cbf_cb or cbf_cr) and pps.cu_qp_delta_enabled \
                and not self.is_delta_coded:
            pre = c.decision("cu_qp_delta_abs", 0)
            val = pre
            if pre:
                while val < 5 and c.decision("cu_qp_delta_abs", 1):
                    val += 1
                if val == 5:
                    val = 5 + c.eg_bypass(0)
                if c.bypass():
                    val = -val
            self.delta_val = val
            self.is_delta_coded = True
            self.cur_cu_qp = None
        intra = self.cu_is_intra
        bd = self.sps.bit_depth
        qbd = 6 * (bd - 8)
        # luma: predict (intra) or take the MC output, add residual
        if intra:
            mode = self._pu_mode(x0, y0)
            pred = intra_predict(pic.Y, x0, y0, size, mode, 0,
                                 self._sample_avail_luma,
                                 bool(self.sps.strong_intra_smoothing), bd)
        else:
            mode = None
            pred = pic.Y[y0:y0 + size, x0:x0 + size].astype(np.int32)
        if cbf_l:
            coef, ts = self._residual_coding(log2, 0, mode)
            res = residual_from_coeffs(coef, self._cu_qp() + qbd, log2,
                                       dst=(intra and log2 == 2), ts=ts,
                                       bypass=self.cu_bypass, bd=bd,
                                       m=self._scaling_m(log2, 0, intra))
            pred = pred + res
        pic.Y[y0:y0 + size, x0:x0 + size] = np.clip(pred, 0, (1 << bd) - 1)
        g = (slice(y0 >> 2, (y0 + size) >> 2),
             slice(x0 >> 2, (x0 + size) >> 2))
        if intra:
            pic.avail[g] = True
        pic.nnz[g] = bool(cbf_l)
        pic.tu_edge_v[g[0], x0 >> 2] = True
        pic.tu_edge_h[y0 >> 2, g[1]] = True
        # chroma at this node (size>4) or at the last 4x4 luma (blk_idx 3)
        if log2 > 2:
            cx, cy, clog2 = x0 >> 1, y0 >> 1, log2 - 1
        elif blk_idx == 3:
            cx, cy, clog2 = x_base >> 1, y_base >> 1, 2
        else:
            return
        csize = 1 << clog2
        qpy = self._cu_qp()
        for c_idx, plane, cbf, off in (
                (1, pic.U, cbf_cb, pps.cb_qp_offset + self.h.cb_qp_offset),
                (2, pic.V, cbf_cr, pps.cr_qp_offset + self.h.cr_qp_offset)):
            if intra:
                cmode = self.cu_chroma_mode
                predc = intra_predict(plane, cx, cy, csize, cmode, c_idx,
                                      self._sample_avail_chroma, False, bd)
            else:
                cmode = None
                predc = plane[cy:cy + csize,
                              cx:cx + csize].astype(np.int32)
            if cbf:
                coef, ts = self._residual_coding(clog2, c_idx, cmode)
                qpi = _clip3(-qbd, 57, qpy + off)
                qpc = T.chroma_qp_from_luma(qpi)
                res = residual_from_coeffs(
                    coef, qpc + qbd, clog2, dst=False, ts=ts,
                    bypass=self.cu_bypass, bd=bd,
                    m=self._scaling_m(clog2, c_idx, intra))
                predc = predc + res
            if cbf or intra:
                plane[cy:cy + csize, cx:cx + csize] = \
                    np.clip(predc, 0, (1 << bd) - 1)

    # -- inter CUs ---------------------------------------------------------

    def _cu_inter(self, x0: int, y0: int, log2: int, depth: int, g) -> None:
        c = self.c
        pic = self.pic
        size = 1 << log2
        pic.is_intra[g] = False
        part = self._part_mode_inter(log2)
        merged_2n = False
        for i, (dx, dy, pw, ph) in enumerate(_pu_geometry(part, size)):
            merged = self._prediction_unit(x0 + dx, y0 + dy, pw, ph, i,
                                           part)
            self._mark_pu_edges(x0 + dx, y0 + dy, pw, ph)
            if part == PART_2Nx2N:
                merged_2n = merged
        root_cbf = 1
        if not (part == PART_2Nx2N and merged_2n):
            root_cbf = c.decision("rqt_root_cbf")
        if root_cbf:
            self.cu_is_intra = False
            self.cu_intra_split = False
            self.cu_inter_split = (self.sps.max_trafo_depth_inter == 0
                                   and part != PART_2Nx2N)
            self._transform_tree(x0, y0, x0, y0, log2, 0, 0, 1, 1)
        self._finish_cu(x0, y0, size, g)

    def _part_mode_inter(self, log2: int) -> int:
        """part_mode binarisation for inter CUs (9.3.3.7 Table 9-34)."""
        c = self.c
        if c.decision("part_mode", 0):
            return PART_2Nx2N
        at_min = log2 == self.sps.log2_min_cb
        b1 = c.decision("part_mode", 1)
        if not at_min:
            if self.sps.amp_enabled:
                if c.decision("part_mode", 3):
                    return PART_2NxN if b1 else PART_Nx2N
                if b1:
                    return PART_2NxnD if c.bypass() else PART_2NxnU
                return PART_nRx2N if c.bypass() else PART_nLx2N
            return PART_2NxN if b1 else PART_Nx2N
        if b1:
            return PART_2NxN
        if log2 == 3:
            return PART_Nx2N
        return PART_Nx2N if c.decision("part_mode", 2) else PART_NxN

    def _prediction_unit(self, xp: int, yp: int, w: int, h: int,
                         part_idx: int, part: int,
                         skip_cu: bool = False) -> bool:
        """prediction_unit (7.3.8.6) + motion derivation + MC.
        Returns the merge flag."""
        c = self.c
        hh = self.h
        merge = True
        if not skip_cu:
            merge = bool(c.decision("merge_flag"))
        if merge:
            idx = 0
            if hh.max_merge > 1 and c.decision("merge_idx"):
                idx = 1
                while idx < hh.max_merge - 1 and c.bypass():
                    idx += 1
            used, mvs, ridx = self._merge_list(xp, yp, w, h,
                                               part_idx, part)[idx]
            # 8.5.3.2.2: 8x4/4x8 PUs convert bi-predictive merge
            # candidates to uni-L0 (bi-prediction is barred at that size)
            if w + h == 12 and used[0] and used[1]:
                used = [True, False]
        else:
            if hh.slice_type == SLICE_B:
                idc = self._inter_pred_idc(w, h)
            else:
                idc = 0  # PRED_L0
            used = [idc in (0, 2), idc in (1, 2)]
            mvs = [[0, 0], [0, 0]]
            ridx = [0, 0]
            for lx in (0, 1):
                if not used[lx]:
                    continue
                n = hh.num_ref[lx]
                if n > 1:
                    r = 0
                    if c.decision("ref_idx", 0):
                        r = 1
                        if n > 2 and c.decision("ref_idx", 1):
                            r = 2
                            while r < n - 1 and c.bypass():
                                r += 1
                    ridx[lx] = r
                if lx == 1 and hh.mvd_l1_zero and idc == 2:
                    mvd = (0, 0)
                else:
                    mvd = self._mvd_coding()
                mvp_flag = c.decision("mvp_flag")
                mvp = self._amvp(xp, yp, w, h, lx, ridx[lx], mvp_flag,
                                 part_idx, part)
                mvs[lx] = [_wrap16(mvp[0] + mvd[0]),
                           _wrap16(mvp[1] + mvd[1])]
        self._store_motion(xp, yp, w, h, used, mvs, ridx)
        self._mc_pu(xp, yp, w, h, used, mvs, ridx)
        return merge

    def _inter_pred_idc(self, w: int, h: int) -> int:
        """9.3.3: 2=BI, 0=L0, 1=L1."""
        c = self.c
        if w + h != 12:
            if c.decision("inter_pred_idc", self.cu_depth):
                return 2
        return 1 if c.decision("inter_pred_idc", 4) else 0

    def _mvd_coding(self) -> tuple[int, int]:
        c = self.c
        g0 = [c.decision("abs_mvd_greater0_flag"),
              c.decision("abs_mvd_greater0_flag")]
        g1 = [0, 0]
        for k in (0, 1):
            if g0[k]:
                g1[k] = c.decision("abs_mvd_greater1_flag")
        out = [0, 0]
        for k in (0, 1):
            if g0[k]:
                v = 1
                if g1[k]:
                    v = 2 + c.eg_bypass(1)
                if c.bypass():
                    v = -v
                out[k] = v
        return out[0], out[1]

    def _store_motion(self, xp, yp, w, h, used, mvs, ridx) -> None:
        pic = self.pic
        r = (slice(yp >> 2, (yp + h) >> 2), slice(xp >> 2, (xp + w) >> 2))
        for lx in (0, 1):
            pic.mv_used[r + (lx,)] = used[lx]
            if used[lx]:
                pic.mv[r + (lx, 0)] = mvs[lx][0]
                pic.mv[r + (lx, 1)] = mvs[lx][1]
                pic.ref_idx[r + (lx,)] = ridx[lx]
                pic.ref_poc[r + (lx,)] = self.refs[lx][ridx[lx]].poc
                pic.ref_lt[r + (lx,)] = self.refs_lt[lx][ridx[lx]]
        pic.is_intra[r] = False
        pic.decided[r] = True

    def _mc_pu(self, xp, yp, w, h, used, mvs, ridx) -> None:
        pic = self.pic
        sps = self.sps
        bd = sps.bit_depth
        obd = bd - 8  # WpOffsetBdShift: offsets are coded in 8-bit range
        pw = self.h.pred_weights
        preds = {}
        wps = {}
        for lx in (0, 1):
            if not used[lx]:
                continue
            ref = self.refs[lx][ridx[lx]]
            mx, my = mvs[lx]
            preds[lx] = (
                _mc_luma_14bit(ref.Y, sps.width, sps.height,
                               xp, yp, w, h, mx, my, bd),
                _mc_chroma_14bit(ref.U, sps.width >> 1, sps.height >> 1,
                                 xp >> 1, yp >> 1, w >> 1, h >> 1,
                                 mx, my, bd),
                _mc_chroma_14bit(ref.V, sps.width >> 1, sps.height >> 1,
                                 xp >> 1, yp >> 1, w >> 1, h >> 1,
                                 mx, my, bd))
            if pw is not None:
                llog2, clog2, tab = pw
                wy, oy, (wcb, ocb), (wcr, ocr) = tab[lx][ridx[lx]]
                wps[lx] = ((wy, oy << obd, llog2 + 14 - bd),
                           (wcb, ocb << obd, clog2 + 14 - bd),
                           (wcr, ocr << obd, clog2 + 14 - bd))
            else:
                wps[lx] = (None, None, None)
        planes = (pic.Y, pic.U, pic.V)
        for pi in range(3):
            sh = 0 if pi == 0 else 1
            xx, yy = xp >> sh, yp >> sh
            ww, hh2 = w >> sh, h >> sh
            if len(preds) == 1:
                lx = next(iter(preds))
                out = _weighted_uni(preds[lx][pi], wps[lx][pi], bd)
            else:
                out = _weighted_bi(preds[0][pi], preds[1][pi],
                                   wps[0][pi], wps[1][pi], bd)
            planes[pi][yy:yy + hh2, xx:xx + ww] = out

    # -- motion candidate derivation ----------------------------------------

    def _mot_at(self, x: int, y: int):
        """Motion of the block covering luma (x,y), or None if
        unavailable / intra (6.4.2 + 8.5.3)."""
        if not self._zavail(x, y, parse=True):
            return None
        pic = self.pic
        gi = (y >> 2, x >> 2)
        if pic.is_intra[gi]:
            return None
        u = pic.mv_used[gi]
        return ([bool(u[0]), bool(u[1])],
                [[int(pic.mv[gi][0][0]), int(pic.mv[gi][0][1])],
                 [int(pic.mv[gi][1][0]), int(pic.mv[gi][1][1])]],
                [int(pic.ref_idx[gi][0]), int(pic.ref_idx[gi][1])])

    def _merge_list(self, xp, yp, w, h, part_idx, part):
        """8.5.3.2.3 merge candidate list (always MaxNumMergeCand long)."""
        plevel = self.pps.log2_parallel_merge_level

        def fetch(nx, ny):
            if nx < 0 or ny < 0:
                return None
            if (xp >> plevel) == (nx >> plevel) and \
                    (yp >> plevel) == (ny >> plevel):
                return None
            return self._mot_at(nx, ny)

        # pruning compares against the *fetched* neighbour motion, even
        # when that neighbour itself was pruned from the list (8.5.3.2.3)
        a1 = b1 = None
        if not (part_idx == 1 and part in (PART_Nx2N, PART_nLx2N,
                                           PART_nRx2N)):
            a1 = fetch(xp - 1, yp + h - 1)
        if not (part_idx == 1 and part in (PART_2NxN, PART_2NxnU,
                                           PART_2NxnD)):
            b1 = fetch(xp + w - 1, yp - 1)
        b0 = fetch(xp + w, yp - 1)
        a0 = fetch(xp - 1, yp + h)
        cands = []
        if a1:
            cands.append(a1)
        if b1 and b1 != a1:
            cands.append(b1)
        if b0 and b0 != b1:
            cands.append(b0)
        if a0 and a0 != a1:
            cands.append(a0)
        if len(cands) < 4:
            b2 = fetch(xp - 1, yp - 1)
            if b2 and b2 != a1 and b2 != b1:
                cands.append(b2)
        maxm = self.h.max_merge
        if self.h.temporal_mvp and len(cands) < maxm:
            tm = [None, None]
            tu = [False, False]
            for lx in (0, 1) if self.h.slice_type == SLICE_B else (0,):
                mv = self._tmvp(xp, yp, w, h, 0, lx)
                if mv is not None:
                    tm[lx] = mv
                    tu[lx] = True
            if tu[0] or tu[1]:
                cands.append((tu, [tm[0] or [0, 0], tm[1] or [0, 0]],
                              [0, 0]))
        # combined bi-predictive candidates (B slices)
        if self.h.slice_type == SLICE_B and 1 < len(cands) < maxm:
            order = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                     (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
            n = len(cands)
            for i, j in order:
                if len(cands) >= maxm:
                    break
                if i >= n or j >= n:
                    break
                c0, c1 = cands[i], cands[j]
                if not (c0[0][0] and c1[0][1]):
                    continue
                r0 = self.refs[0][c0[2][0]].poc
                r1 = self.refs[1][c1[2][1]].poc
                if r0 == r1 and c0[1][0] == c1[1][1]:
                    continue
                cands.append(([True, True], [list(c0[1][0]),
                                             list(c1[1][1])],
                              [c0[2][0], c1[2][1]]))
        # zero-motion fill
        if self.h.slice_type == SLICE_B:
            nref = min(self.h.num_ref[0], self.h.num_ref[1])
        else:
            nref = self.h.num_ref[0]
        zi = 0
        while len(cands) < maxm:
            r = zi if zi < nref else 0
            if self.h.slice_type == SLICE_B:
                cands.append(([True, True], [[0, 0], [0, 0]], [r, r]))
            else:
                cands.append(([True, False], [[0, 0], [0, 0]], [r, 0]))
            zi += 1
        return cands

    def _tmvp(self, xp, yp, w, h, ref_idx, list_x):
        """8.5.3.2.8 temporal MV candidate, or None."""
        if self.col_pic is None:
            return None
        sps = self.sps
        xbr, ybr = xp + w, yp + h
        mv = None
        if ((ybr >> sps.log2_ctb) == (yp >> sps.log2_ctb)
                and ybr < sps.height and xbr < sps.width):
            mv = self._col_mv((xbr >> 4) << 4, (ybr >> 4) << 4,
                              ref_idx, list_x)
        if mv is None:
            xc, yc = xp + (w >> 1), yp + (h >> 1)
            mv = self._col_mv((xc >> 4) << 4, (yc >> 4) << 4,
                              ref_idx, list_x)
        return mv

    def _col_mv(self, x, y, ref_idx, list_x):
        col = self.col_pic
        gi = (y >> 2, x >> 2)
        if col.is_intra[gi]:
            return None
        u = col.mv_used[gi]
        if not u[0] and not u[1]:
            return None
        if not u[0]:
            n = 1
        elif not u[1]:
            n = 0
        elif self.no_backward:
            n = list_x
        else:
            n = self.h.collocated_from_l0
        # 8.5.3.2.9: the candidate exists only when the collocated ref
        # and the target agree on long-term-ness; long-term MVs are
        # never POC-scaled
        col_lt = bool(col.ref_lt[gi][n])
        targ_lt = bool(self.refs_lt[list_x][ref_idx])
        if col_lt != targ_lt:
            return None
        mvc = [int(col.mv[gi][n][0]), int(col.mv[gi][n][1])]
        if targ_lt:
            return mvc
        col_diff = col.poc - int(col.ref_poc[gi][n])
        cur_diff = self.pic.poc - self.refs[list_x][ref_idx].poc
        if col_diff == cur_diff:
            return mvc
        return [_mv_scale(v, cur_diff, col_diff) for v in mvc]

    def _amvp(self, xp, yp, w, h, list_x, ref_idx, mvp_flag,
              part_idx, part):
        """8.5.3.2.5/6 AMVP predictor selection."""
        target = self.refs[list_x][ref_idx]
        target_lt = bool(self.refs_lt[list_x][ref_idx])
        a0p, a1p = (xp - 1, yp + h), (xp - 1, yp + h - 1)
        b0p, b1p, b2p = ((xp + w, yp - 1), (xp + w - 1, yp - 1),
                         (xp - 1, yp - 1))
        a_cands = [self._mot_at(*p) for p in (a0p, a1p)]
        is_scaled = any(c is not None for c in a_cands)
        mva = self._amvp_noscale(a_cands, list_x, target)
        if mva is None and is_scaled:
            mva = self._amvp_scaled(a_cands, list_x, target, target_lt)
        b_cands = [self._mot_at(*p) for p in (b0p, b1p, b2p)]
        mvb = self._amvp_noscale(b_cands, list_x, target)
        if not is_scaled:
            if mva is None and mvb is not None:
                mva = mvb
                mvb = None
            if mvb is None:
                mvb = self._amvp_scaled(b_cands, list_x, target,
                                        target_lt)
                if mvb is not None and mva is not None and mvb == mva:
                    mvb = None
        cands = [m for m in (mva, mvb if mvb != mva else None)
                 if m is not None]
        if len(cands) < 2 and self.h.temporal_mvp:
            t = self._tmvp(xp, yp, w, h, ref_idx, list_x)
            if t is not None:
                cands.append(t)
        while len(cands) < 2:
            cands.append([0, 0])
        return cands[mvp_flag]

    def _amvp_noscale(self, cands, list_x, target):
        for c in cands:
            if c is None:
                continue
            for lx in (list_x, 1 - list_x):
                if c[0][lx] and lx < len(self.refs) and \
                        c[2][lx] < len(self.refs[lx]) and \
                        self.refs[lx][c[2][lx]].poc == target.poc:
                    return list(c[1][lx])
        return None

    def _amvp_scaled(self, cands, list_x, target, target_lt=False):
        for c in cands:
            if c is None:
                continue
            for lx in (list_x, 1 - list_x):
                if c[0][lx]:
                    # 8.5.3.2.6: usable only when candidate ref and
                    # target agree on long-term-ness; long-term MVs are
                    # copied unscaled
                    if bool(self.refs_lt[lx][c[2][lx]]) != target_lt:
                        continue
                    if target_lt:
                        return list(c[1][lx])
                    cand_diff = self.pic.poc - \
                        self.refs[lx][c[2][lx]].poc
                    cur_diff = self.pic.poc - target.poc
                    if cand_diff == cur_diff:
                        return list(c[1][lx])
                    return [_mv_scale(v, cur_diff, cand_diff)
                            for v in c[1][lx]]
        return None

    def _scaling_m(self, log2: int, c_idx: int, intra: bool):
        """ScalingFactor matrix for this TB, or None when lists are off
        (8.6.3 m[x][y]; Table 7-4 matrixId)."""
        sf = self.pps.scaling_factors
        if sf is None:
            return None
        size_id = log2 - 2
        if size_id == 3:
            mid = 0 if intra else 1
        else:
            mid = (0 if intra else 3) + c_idx
        return sf[size_id][mid]

    def _pu_mode(self, x: int, y: int) -> int:
        if not self.cu_intra_split:
            return self.cu_modes[0]
        x0, y0, _ = self.cur_cu
        pbs = self.cu_pbs
        i = ((1 if y >= y0 + pbs else 0) << 1) | (1 if x >= x0 + pbs else 0)
        return self.cu_modes[i]

    # -- residual coding (7.3.8.11) --------------------------------------------

    def _residual_coding(self, log2: int, c_idx: int,
                         pred_mode: int) -> tuple[np.ndarray, bool]:
        c = self.c
        size = 1 << log2
        ts = False
        if (self.pps.transform_skip_enabled and not self.cu_bypass
                and log2 == 2):
            ts = bool(c.decision("transform_skip_flag",
                                 0 if c_idx == 0 else 1))
        # scan selection (mode-dependent for small intra TBs)
        scan_idx = 0
        if pred_mode is not None and (log2 == 2
                                      or (log2 == 3 and c_idx == 0)):
            if 6 <= pred_mode <= 14:
                scan_idx = 2
            elif 22 <= pred_mode <= 30:
                scan_idx = 1
        # last significant coefficient position
        cmax = (log2 << 1) - 1
        if c_idx == 0:
            coff = 3 * (log2 - 2) + ((log2 - 1) >> 2)
            cshift = (log2 + 1) >> 2
        else:
            coff = 15
            cshift = log2 - 2
        lx = 0
        while lx < cmax and c.decision("last_sig_coeff_x_prefix",
                                       coff + (lx >> cshift)):
            lx += 1
        ly = 0
        while ly < cmax and c.decision("last_sig_coeff_y_prefix",
                                       coff + (ly >> cshift)):
            ly += 1
        if lx > 3:
            nbits = (lx >> 1) - 1
            lx = (1 << nbits) * (2 + (lx & 1)) + c.bypass_bits(nbits)
        if ly > 3:
            nbits = (ly >> 1) - 1
            ly = (1 << nbits) * (2 + (ly & 1)) + c.bypass_bits(nbits)
        if scan_idx == 2:
            lx, ly = ly, lx
        log2sb = log2 - 2
        sb_scan = _sb_scan(scan_idx, log2sb)
        in_scan = T.SCAN[scan_idx][2]
        sb_pos = _SCAN_POS[(scan_idx, log2sb)] if log2sb else {(0, 0): 0}
        in_pos = _SCAN_POS[(scan_idx, 2)]
        last_sb = sb_pos[(lx >> 2, ly >> 2)]
        last_pos = in_pos[(lx & 3, ly & 3)]
        nsb = 1 << (2 * log2sb)
        csbf = np.zeros((nsb and (1 << log2sb) or 1,) * 2, bool)
        coef = np.zeros((size, size), np.int32)
        sdh = (self.pps.sign_data_hiding and not self.cu_bypass)
        prev_c1_zero = False
        for i in range(last_sb, -1, -1):
            xs, ys = sb_scan[i]
            if i == last_sb or i == 0:
                sb_coded = 1
                infer_dc = False
            else:
                inc = int(bool(
                    (xs + 1 < csbf.shape[1] and csbf[ys, xs + 1])
                    or (ys + 1 < csbf.shape[0] and csbf[ys + 1, xs])))
                sb_coded = c.decision("coded_sub_block_flag",
                                      inc + (2 if c_idx else 0))
                infer_dc = True
            csbf[ys, xs] = bool(sb_coded)
            if not sb_coded:
                continue
            # significance flags
            sig_pos = []  # scan positions n with sig==1, parse order
            start_n = last_pos - 1 if i == last_sb else 15
            if i == last_sb:
                sig_pos.append(last_pos)
            for n in range(start_n, -1, -1):
                if n == 0 and infer_dc:
                    sig_pos.append(0)
                    break
                xp, yp = in_scan[n]
                xc, yc = (xs << 2) + xp, (ys << 2) + yp
                if log2 == 2:
                    sctx = T.SIG_CTX_MAP_4x4[(yc << 2) + xc]
                elif xc + yc == 0:
                    sctx = 0
                else:
                    right = xs + 1 < csbf.shape[1] and csbf[ys, xs + 1]
                    below = ys + 1 < csbf.shape[0] and csbf[ys + 1, xs]
                    prev = (1 if right else 0) | (2 if below else 0)
                    if prev == 0:
                        sctx = 2 if xp + yp == 0 else (
                            1 if xp + yp < 3 else 0)
                    elif prev == 1:
                        sctx = 2 if yp == 0 else (1 if yp == 1 else 0)
                    elif prev == 2:
                        sctx = 2 if xp == 0 else (1 if xp == 1 else 0)
                    else:
                        sctx = 2
                    if c_idx == 0:
                        if xs or ys:
                            sctx += 3
                        sctx += (9 if scan_idx == 0 else 15) \
                            if log2 == 3 else 21
                    else:
                        sctx += 9 if log2 == 3 else 12
                inc = sctx if c_idx == 0 else 27 + sctx
                if c.decision("sig_coeff_flag", inc):
                    sig_pos.append(n)
                    infer_dc = False
            if not sig_pos:
                continue
            # greater1 / greater2
            ctx_set = 0 if (i == 0 or c_idx > 0) else 2
            if prev_c1_zero:
                ctx_set += 1
            base1 = (0 if c_idx == 0 else 16) + 4 * ctx_set
            c1 = 1
            gt1 = {}
            for j, n in enumerate(sig_pos[:8]):
                b = c.decision("coeff_abs_level_greater1_flag",
                               base1 + min(c1, 3))
                gt1[n] = b
                if b:
                    c1 = 0
                elif 0 < c1 < 3:
                    c1 += 1
            prev_c1_zero = (c1 == 0)
            gt2 = {}
            first_g1 = next((n for n in sig_pos[:8] if gt1[n]), None)
            if first_g1 is not None:
                gt2[first_g1] = c.decision(
                    "coeff_abs_level_greater2_flag",
                    (0 if c_idx == 0 else 4) + ctx_set)
            # signs (parse order, last one maybe hidden)
            first_scan = sig_pos[-1]
            last_scan = sig_pos[0]
            hidden = sdh and (last_scan - first_scan) > 3
            signs = {}
            for n in sig_pos[:-1] if hidden else sig_pos:
                signs[n] = c.bypass()
            # remaining levels
            rice = 0
            levels = {}
            for j, n in enumerate(sig_pos):
                base = 1 + (gt1.get(n, 0) if j < 8 else 0) + gt2.get(n, 0)
                cap = 1 if j >= 8 else (3 if n in gt2 else 2)
                lvl = base
                if base == cap:
                    rem = self._coeff_remaining(rice)
                    lvl = base + rem
                    if lvl > (3 << rice):
                        rice = min(rice + 1, 4)
                levels[n] = lvl
            if hidden:
                total = sum(levels.values())
                signs[first_scan] = 1 if (total & 1) else 0
            for n, lvl in levels.items():
                xp, yp = in_scan[n]
                v = -lvl if signs[n] else lvl
                coef[(ys << 2) + yp, (xs << 2) + xp] = v
        return coef, ts

    def _coeff_remaining(self, rice: int) -> int:
        """coeff_abs_level_remaining (9.3.3.9), bypass bins."""
        c = self.c
        prefix = 0
        while prefix < 32 and c.bypass():
            prefix += 1
        if prefix <= 3:
            return (prefix << rice) + c.bypass_bits(rice)
        return (((1 << (prefix - 3)) + 3 - 1) << rice) \
            + c.bypass_bits(prefix - 3 + rice)


# ---------------------------------------------------------------------------
# Inter prediction: fractional-sample interpolation (8.5.4.2.2).
# Returns 14-bit-scale predictions (before the weighted-sample stage).
# ---------------------------------------------------------------------------


def _mc_luma_14bit(plane: np.ndarray, pw: int, ph: int, x0: int, y0: int,
                   w: int, h: int, mvx: int, mvy: int,
                   bd: int = 8) -> np.ndarray:
    """8.5.4.2.2.1: 14-bit intermediates; first filter stage shifted by
    BitDepth-8, second by 6, full-pel samples by 14-BitDepth."""
    xi = x0 + (mvx >> 2)
    yi = y0 + (mvy >> 2)
    fx, fy = mvx & 3, mvy & 3
    s1 = bd - 8
    if fx == 0 and fy == 0:
        xs = np.clip(np.arange(xi, xi + w), 0, pw - 1)
        ys = np.clip(np.arange(yi, yi + h), 0, ph - 1)
        return plane[np.ix_(ys, xs)].astype(np.int32) << (14 - bd)
    xs = np.clip(np.arange(xi - 3, xi + w + 4), 0, pw - 1)
    ys = np.clip(np.arange(yi - 3, yi + h + 4), 0, ph - 1)
    win = plane[np.ix_(ys, xs)].astype(np.int32)
    if fx:
        ftab = T.LUMA_FILTER[fx]
        win = sum(ftab[i] * win[:, i:i + w] for i in range(8)) >> s1
    else:
        win = win[:, 3:3 + w]
    if fy:
        ftab = T.LUMA_FILTER[fy]
        win = sum(ftab[i] * win[i:i + h, :] for i in range(8))
        win >>= 6 if fx else s1
        return win
    return win[3:3 + h, :]


def _mc_chroma_14bit(plane: np.ndarray, pw: int, ph: int, x0: int, y0: int,
                     w: int, h: int, mvx: int, mvy: int,
                     bd: int = 8) -> np.ndarray:
    """mv in eighth-chroma units (== the luma quarter-pel value)."""
    xi = x0 + (mvx >> 3)
    yi = y0 + (mvy >> 3)
    fx, fy = mvx & 7, mvy & 7
    s1 = bd - 8
    if fx == 0 and fy == 0:
        xs = np.clip(np.arange(xi, xi + w), 0, pw - 1)
        ys = np.clip(np.arange(yi, yi + h), 0, ph - 1)
        return plane[np.ix_(ys, xs)].astype(np.int32) << (14 - bd)
    xs = np.clip(np.arange(xi - 1, xi + w + 2), 0, pw - 1)
    ys = np.clip(np.arange(yi - 1, yi + h + 2), 0, ph - 1)
    win = plane[np.ix_(ys, xs)].astype(np.int32)
    if fx:
        ftab = T.CHROMA_FILTER[fx]
        win = sum(ftab[i] * win[:, i:i + w] for i in range(4)) >> s1
    else:
        win = win[:, 1:1 + w]
    if fy:
        ftab = T.CHROMA_FILTER[fy]
        win = sum(ftab[i] * win[i:i + h, :] for i in range(4))
        win >>= 6 if fx else s1
        return win
    return win[1:1 + h, :]


def _weighted_uni(pred: np.ndarray, wp, bd: int = 8) -> np.ndarray:
    """8.5.4.2.2 default / 8.5.4.2.3 explicit, uni-directional."""
    mx = (1 << bd) - 1
    s1 = 14 - bd
    if wp is None:
        return np.clip((pred + (1 << (s1 - 1))) >> s1, 0, mx)
    w0, o0, log2wd = wp
    return np.clip(((pred * w0 + (1 << (log2wd - 1))) >> log2wd) + o0,
                   0, mx)


def _weighted_bi(p0: np.ndarray, p1: np.ndarray, wp0, wp1,
                 bd: int = 8) -> np.ndarray:
    mx = (1 << bd) - 1
    s1 = 14 - bd
    if wp0 is None:
        return np.clip((p0 + p1 + (1 << s1)) >> (s1 + 1), 0, mx)
    w0, o0, log2wd = wp0
    w1, o1, _ = wp1
    return np.clip((p0 * w0 + p1 * w1
                    + ((o0 + o1 + 1) << log2wd)) >> (log2wd + 1), 0, mx)


# ---------------------------------------------------------------------------
# Deblocking filter (8.7.2): all vertical edges of the picture, then all
# horizontal edges, on the 8x8 luma grid (16x16 for chroma).
# ---------------------------------------------------------------------------


def _clip1(v: int, mx: int = 255) -> int:
    return 0 if v < 0 else mx if v > mx else v


def _bs_for_edge(pic: _Picture, gp: tuple, gq: tuple, tu_edge: bool) -> int:
    """8.7.2.4 boundary strength from the two 4x4 blocks."""
    if pic.is_intra[gp] or pic.is_intra[gq]:
        return 2
    if tu_edge and (pic.nnz[gp] or pic.nnz[gq]):
        return 1
    return _bs_inter(pic, gp, gq)


def _bs_inter(pic: _Picture, gp: tuple, gq: tuple) -> int:
    """Motion-based bS (inter pictures; grown with the inter stage)."""
    mp, mq = pic.mv[gp], pic.mv[gq]
    up, uq = pic.mv_used[gp], pic.mv_used[gq]
    rp = (pic.ref_poc[gp][0] if up[0] else None,
          pic.ref_poc[gp][1] if up[1] else None)
    rq = (pic.ref_poc[gq][0] if uq[0] else None,
          pic.ref_poc[gq][1] if uq[1] else None)
    np_, nq = int(up[0]) + int(up[1]), int(uq[0]) + int(uq[1])
    if np_ != nq:
        return 1
    def far(a, b):
        return abs(int(a[0]) - int(b[0])) >= 4 or \
            abs(int(a[1]) - int(b[1])) >= 4
    if np_ == 1:
        lp = 0 if up[0] else 1
        lq = 0 if uq[0] else 1
        if rp[lp] != rq[lq]:
            return 1
        return 1 if far(mp[lp], mq[lq]) else 0
    # two MVs each: compare as unordered reference sets
    if sorted(map(str, [rp[0], rp[1]])) != sorted(map(str, [rq[0], rq[1]])):
        return 1
    if rp[0] == rp[1]:
        # same picture both lists: both orderings must exceed to get bS 1
        a = far(mp[0], mq[0]) or far(mp[1], mq[1])
        b = far(mp[0], mq[1]) or far(mp[1], mq[0])
        return 1 if (a and b) else 0
    if rp[0] == rq[0]:
        return 1 if (far(mp[0], mq[0]) or far(mp[1], mq[1])) else 0
    return 1 if (far(mp[0], mq[1]) or far(mp[1], mq[0])) else 0


def _deblock_luma_segment(Y, x, y, dx, dy, bs, qp_p, qp_q, h: SliceHeader,
                          nofilt_p: bool, nofilt_q: bool,
                          bd: int = 8) -> None:
    """One 4-sample luma edge segment; (dx,dy) = unit vector across the
    edge (P side at -1). 8.7.2.5.3/8.7.2.5.7."""
    qavg = (qp_p + qp_q + 1) >> 1
    beta = T.BETA_TABLE[_clip3(0, 51, qavg + h.beta_offset)] << (bd - 8)
    tc = T.TC_TABLE[_clip3(0, 53, qavg + 2 * (bs - 1)
                           + h.tc_offset)] << (bd - 8)
    mx = (1 << bd) - 1
    if beta == 0 and tc == 0:
        return
    # tangential unit vector
    tx, ty = dy, dx

    def s(i, k):  # line i (0..3), offset k across edge (-4..3; -1=p0, 0=q0)
        return int(Y[y + i * ty + k * dy, x + i * tx + k * dx])

    dp0 = abs(s(0, -3) - 2 * s(0, -2) + s(0, -1))
    dp3 = abs(s(3, -3) - 2 * s(3, -2) + s(3, -1))
    dq0 = abs(s(0, 2) - 2 * s(0, 1) + s(0, 0))
    dq3 = abs(s(3, 2) - 2 * s(3, 1) + s(3, 0))
    d = dp0 + dp3 + dq0 + dq3
    if d >= beta:
        return
    strong = True
    for i in (0, 3):
        dpq = (dp0 + dq0) if i == 0 else (dp3 + dq3)
        if not (2 * dpq < (beta >> 2)
                and abs(s(i, -4) - s(i, -1)) + abs(s(i, 0) - s(i, 3))
                < (beta >> 3)
                and abs(s(i, -1) - s(i, 0)) < ((5 * tc + 1) >> 1)):
            strong = False
            break
    dep1 = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3)
    deq1 = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3)
    for i in range(4):
        px = [s(i, -1 - k) for k in range(4)]  # p0..p3
        qx = [s(i, k) for k in range(4)]       # q0..q3
        if strong:
            np0 = _clip3(px[0] - 2 * tc, px[0] + 2 * tc,
                         (px[2] + 2 * px[1] + 2 * px[0] + 2 * qx[0]
                          + qx[1] + 4) >> 3)
            np1 = _clip3(px[1] - 2 * tc, px[1] + 2 * tc,
                         (px[2] + px[1] + px[0] + qx[0] + 2) >> 2)
            np2 = _clip3(px[2] - 2 * tc, px[2] + 2 * tc,
                         (2 * px[3] + 3 * px[2] + px[1] + px[0]
                          + qx[0] + 4) >> 3)
            nq0 = _clip3(qx[0] - 2 * tc, qx[0] + 2 * tc,
                         (px[1] + 2 * px[0] + 2 * qx[0] + 2 * qx[1]
                          + qx[2] + 4) >> 3)
            nq1 = _clip3(qx[1] - 2 * tc, qx[1] + 2 * tc,
                         (px[0] + qx[0] + qx[1] + qx[2] + 2) >> 2)
            nq2 = _clip3(qx[2] - 2 * tc, qx[2] + 2 * tc,
                         (px[0] + qx[0] + qx[1] + 3 * qx[2]
                          + 2 * qx[3] + 4) >> 3)
            if not nofilt_p:
                for k, v in enumerate((np0, np1, np2)):
                    Y[y + i * ty + (-1 - k) * dy,
                      x + i * tx + (-1 - k) * dx] = v
            if not nofilt_q:
                for k, v in enumerate((nq0, nq1, nq2)):
                    Y[y + i * ty + k * dy, x + i * tx + k * dx] = v
        else:
            delta = (9 * (qx[0] - px[0]) - 3 * (qx[1] - px[1]) + 8) >> 4
            if abs(delta) >= tc * 10:
                continue
            delta = _clip3(-tc, tc, delta)
            if not nofilt_p:
                Y[y + i * ty - dy, x + i * tx - dx] = _clip1(px[0] + delta,
                                                             mx)
                if dep1:
                    dp = _clip3(-(tc >> 1), tc >> 1,
                                (((px[2] + px[0] + 1) >> 1)
                                 - px[1] + delta) >> 1)
                    Y[y + i * ty - 2 * dy, x + i * tx - 2 * dx] = \
                        _clip1(px[1] + dp, mx)
            if not nofilt_q:
                Y[y + i * ty, x + i * tx] = _clip1(qx[0] - delta, mx)
                if deq1:
                    dq = _clip3(-(tc >> 1), tc >> 1,
                                (((qx[2] + qx[0] + 1) >> 1)
                                 - qx[1] - delta) >> 1)
                    Y[y + i * ty + dy, x + i * tx + dx] = \
                        _clip1(qx[1] + dq, mx)


def _deblock_chroma_segment(C, cx, cy, dx, dy, qp_p, qp_q, off: int,
                            h: SliceHeader, nofilt_p: bool,
                            nofilt_q: bool, bd: int = 8) -> None:
    """One 4-sample chroma edge segment (bS==2 only), 8.7.2.5.5."""
    qpi = _clip3(0, 57, ((qp_p + qp_q + 1) >> 1) + off)
    qpc = T.chroma_qp_from_luma(qpi)
    tc = T.TC_TABLE[_clip3(0, 53, qpc + 2 + h.tc_offset)] << (bd - 8)
    mx = (1 << bd) - 1
    if tc == 0:
        return
    tx, ty = dy, dx
    for i in range(4):
        p1 = int(C[cy + i * ty - 2 * dy, cx + i * tx - 2 * dx])
        p0 = int(C[cy + i * ty - dy, cx + i * tx - dx])
        q0 = int(C[cy + i * ty, cx + i * tx])
        q1 = int(C[cy + i * ty + dy, cx + i * tx + dx])
        delta = _clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
        if not nofilt_p:
            C[cy + i * ty - dy, cx + i * tx - dx] = _clip1(p0 + delta, mx)
        if not nofilt_q:
            C[cy + i * ty, cx + i * tx] = _clip1(q0 - delta, mx)


def _tile_of_g(pic: _Picture, g: tuple) -> int:
    """Tile id of the 4x4-grid cell g=(y4, x4)."""
    sps = pic.sps
    rs = (((g[0] << 2) >> sps.log2_ctb) * sps.pic_w_ctbs
          + ((g[1] << 2) >> sps.log2_ctb))
    return int(pic.pps.tile_id[rs])


def deblock_picture(pic: _Picture, headers: dict[int, SliceHeader]) -> None:
    sps = pic.sps
    w, hgt = sps.width, sps.height
    tile_gate = pic.pps.tiles_enabled and \
        not pic.pps.loop_filter_across_tiles
    for vertical in (True, False):
        tu_grid = pic.tu_edge_v if vertical else pic.tu_edge_h
        pu_grid = pic.pu_edge_v if vertical else pic.pu_edge_h
        dx, dy = (1, 0) if vertical else (0, 1)
        for ex in (range(8, w, 8) if vertical else range(0, w - 3, 4)):
            for ey in (range(0, hgt - 3, 4) if vertical
                       else range(8, hgt, 8)):
                gq = (ey >> 2, ex >> 2)
                tu_edge = bool(tu_grid[gq])
                if not (tu_edge or pu_grid[gq]):
                    continue
                gp = (ey >> 2, (ex - 1) >> 2) if vertical else \
                    ((ey - 1) >> 2, ex >> 2)
                sq = int(pic.slice_id[gq])
                h = headers[sq]
                if h.deblocking_disabled:
                    continue
                if pic.slice_id[gp] != sq and \
                        not h.loop_filter_across_slices:
                    continue
                if tile_gate and _tile_of_g(pic, gp) != \
                        _tile_of_g(pic, gq):
                    continue
                bs = _bs_for_edge(pic, gp, gq, tu_edge)
                if bs == 0:
                    continue
                qp_p = int(pic.qp[gp])
                qp_q = int(pic.qp[gq])
                nofp = bool(pic.bypass[gp])
                nofq = bool(pic.bypass[gq])
                _deblock_luma_segment(pic.Y, ex, ey, dx, dy, bs,
                                      qp_p, qp_q, h, nofp, nofq,
                                      sps.bit_depth)
                if bs == 2 and (ex % 16 == 0 if vertical
                                else ey % 16 == 0) and (
                        ey % 8 == 0 if vertical else ex % 8 == 0):
                    _deblock_chroma_segment(pic.U, ex >> 1, ey >> 1,
                                            dx, dy, qp_p, qp_q,
                                            pic.pps.cb_qp_offset, h,
                                            nofp, nofq, sps.bit_depth)
                    _deblock_chroma_segment(pic.V, ex >> 1, ey >> 1,
                                            dx, dy, qp_p, qp_q,
                                            pic.pps.cr_qp_offset, h,
                                            nofp, nofq, sps.bit_depth)


# ---------------------------------------------------------------------------
# Sample adaptive offset (8.7.3): applied after deblocking, reading the
# deblocked picture and writing a fresh copy (EO comparisons must see
# pre-SAO neighbours).
# ---------------------------------------------------------------------------

_EO_NBR = ((( -1, 0), (1, 0)), ((0, -1), (0, 1)),
           ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))


def apply_sao(pic: _Picture, headers: dict[int, SliceHeader]) -> None:
    sps = pic.sps
    bd = sps.bit_depth
    mx = (1 << bd) - 1
    bshift = bd - 5
    ctb = 1 << sps.log2_ctb
    srcs = (pic.Y.copy(), pic.U.copy(), pic.V.copy())
    outs = (pic.Y, pic.U, pic.V)
    for ry in range(sps.pic_h_ctbs):
        for rx in range(sps.pic_w_ctbs):
            for ci in range(3):
                typ = int(pic.sao_type[ry, rx, ci])
                if typ == 0:
                    continue
                sh = 0 if ci == 0 else 1
                src = srcs[ci]
                out = outs[ci]
                w = sps.width >> sh
                h = sps.height >> sh
                x0 = (rx * ctb) >> sh
                y0 = (ry * ctb) >> sh
                x1 = min(x0 + (ctb >> sh), w)
                y1 = min(y0 + (ctb >> sh), h)
                offs = pic.sao_offsets[ry, rx, ci]
                if typ == 1:  # band offset
                    bpos = int(pic.sao_band_pos[ry, rx, ci])
                    lut = np.zeros(32, np.int16)
                    for k in range(4):
                        lut[(bpos + k) & 31] = offs[k]
                    for y in range(y0, y1):
                        for x in range(x0, x1):
                            if pic.bypass[(y << sh) >> 2, (x << sh) >> 2]:
                                continue
                            p = int(src[y, x])
                            out[y, x] = _clip1(p + int(lut[p >> bshift]),
                                               mx)
                    continue
                # edge offset
                eo = int(pic.sao_eo_class[ry, rx, ci])
                (ax, ay), (bx, by) = _EO_NBR[eo]
                g0 = ((y0 << sh) >> 2, (x0 << sh) >> 2)
                sid = pic.slice_id[g0]
                across = headers[int(sid)].loop_filter_across_slices
                tile_gate = pic.pps.tiles_enabled and \
                    not pic.pps.loop_filter_across_tiles
                tid = _tile_of_g(pic, g0) if tile_gate else 0
                for y in range(y0, y1):
                    for x in range(x0, x1):
                        na = (x + ax, y + ay)
                        nb = (x + bx, y + by)
                        if not (0 <= na[0] < w and 0 <= na[1] < h
                                and 0 <= nb[0] < w and 0 <= nb[1] < h):
                            continue
                        if pic.bypass[(y << sh) >> 2, (x << sh) >> 2]:
                            continue
                        ga = (((na[1] << sh) >> 2), ((na[0] << sh) >> 2))
                        gb = (((nb[1] << sh) >> 2), ((nb[0] << sh) >> 2))
                        if not across:
                            if pic.slice_id[ga] != sid or \
                                    pic.slice_id[gb] != sid:
                                continue
                        if tile_gate:
                            if _tile_of_g(pic, ga) != tid or \
                                    _tile_of_g(pic, gb) != tid:
                                continue
                        p = int(src[y, x])
                        da = p - int(src[na[1], na[0]])
                        db = p - int(src[nb[1], nb[0]])
                        ei = 2 + (0 if da == 0 else (1 if da > 0 else -1)) \
                            + (0 if db == 0 else (1 if db > 0 else -1))
                        if ei == 2:
                            continue
                        if ei < 2:
                            ei += 1
                        # ei now 1..4 -> offsets[0..3]
                        out[y, x] = _clip1(p + int(offs[ei - 1]), mx)


# ---------------------------------------------------------------------------
# Top-level decoder
# ---------------------------------------------------------------------------


class H265RefDecoder:
    """Drop-in HEVC twin of h264_ref.H264RefDecoder: feed Annex B
    bytes, get (Y, U, V) uint8 planes in display order."""

    def __init__(self):
        self.sps_map: dict[int, SPS] = {}
        self.pps_map: dict[int, PPS] = {}
        self.cur_pic: _Picture | None = None
        self.dpb: list[_Picture] = []
        self.cur_poc = 0
        self.slice_counter = 0
        self.slice_headers: dict[int, SliceHeader] = {}
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0
        self.waiting: list[tuple[int, tuple]] = []
        self.out: list[tuple] = []
        self.first_pic_after_irap_noout = False
        self.prev_indep: SliceHeader | None = None
        self.seg_carry = None  # (cabac ctx, last QP, wpp snaps)
        # NoRaslOutputFlag state (8.1.3): RASL pictures associated with
        # a CRA that starts decoding (mid-stream join) or any BLA
        # reference pictures that precede the join and must be dropped
        self.skip_rasl = False
        self.decoded_any = False

    def decode(self, es: bytes) -> list[tuple]:
        for nal in split_annexb(es):
            self._nal(nal)
        out, self.out = self.out, []
        return out

    def flush(self) -> list[tuple]:
        self._finish_picture()
        self.waiting.sort(key=lambda e: e[0])
        out = self.out + [f for _, f in self.waiting]
        self.out = []
        self.waiting = []
        return out

    def _nal(self, nal: bytes) -> None:
        if len(nal) < 2:
            return
        t = (nal[0] >> 1) & 0x3F
        if t == NAL_SPS:
            rbsp, _ = nal_to_rbsp(nal)
            s = parse_sps(rbsp)
            self.sps_map[s.id] = s
        elif t == NAL_PPS:
            rbsp, _ = nal_to_rbsp(nal)
            p = parse_pps(rbsp, self.sps_map)
            self.pps_map[p.id] = p
        elif t < 32:
            self._slice(nal, t)

    def _slice(self, nal: bytes, t: int) -> None:
        if t in (8, 9):  # RASL_N / RASL_R
            if self.skip_rasl:
                return
        elif t < 32:
            if t in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
                self.skip_rasl = False
            elif t in (NAL_CRA, NAL_BLA_W_LP, 17, 18):
                # NoRaslOutputFlag = 1 for BLA or a CRA that starts
                # decoding; its RASL pictures reference lost history
                self.skip_rasl = (t != NAL_CRA) or not self.decoded_any
            self.decoded_any = True
        rbsp, epb = nal_to_rbsp(nal)
        h = parse_slice_header(rbsp, t, self.sps_map, self.pps_map)
        if h.first_slice:
            self._finish_picture()
            if t in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
                self.dpb = []
            self.cur_pic = _Picture(h.sps, h.pps)
            self.cur_pic.nal_type = t
            self.cur_poc = self._compute_poc(h, t)
            self.cur_pic.poc = self.cur_poc
            # RPS: drop DPB pictures not referenced by this picture
            # (short-term deltas or resolved long-term entries, 8.3.2)
            if t not in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
                keep = {self.cur_poc + d
                        for d, _ in h.strps.neg + h.strps.pos}
                lt_keep = {id(p) for p, _ in self._resolve_lt(h)}
                self.dpb = [p for p in self.dpb
                            if p.poc in keep or id(p) in lt_keep]
        if h.dependent:
            # 7.4.7.1: a dependent segment inherits every slice-header
            # value of the preceding independent segment except its own
            # address/entry points; it continues the same slice.
            ph = self.prev_indep
            if ph is None:
                return
            own = {k: getattr(h, k) for k in
                   ("segment_address", "data_byte_pos", "entry_points",
                    "dependent", "first_slice")}
            h.__dict__.update({**vars(ph), **own})
        else:
            self.prev_indep = h
            self.slice_counter += 1
            self.slice_headers[self.slice_counter] = h
        sd = _SliceDec(self, self.cur_pic, h, rbsp, epb,
                       self.slice_counter)
        if h.dependent and self.seg_carry is not None:
            # 9.3.1: CABAC contexts + QP predictor continue across
            # dependent slice segment boundaries — unless the segment's
            # first CTU starts a new tile, where fresh initialisation
            # takes precedence (and the QP predictor resets, 8.6.1).
            # (entropy_coding_sync row-start sync is handled by the
            # carried wpp_snap inside run().)
            pps = h.pps
            ts0 = int(pps.rs_to_ts[h.segment_address])
            tile_start = pps.tiles_enabled and (
                ts0 == 0 or pps.tile_id[int(pps.ts_to_rs[ts0 - 1])]
                != pps.tile_id[h.segment_address])
            ctx, last_qp, wpp = self.seg_carry
            sd.wpp_snap = wpp
            if not tile_start:
                sd.c.restore(ctx)
                sd.last_cu_qp = last_qp
                sd.qp_prev = last_qp
        if h.slice_type != SLICE_I:
            sd.refs, sd.refs_lt = self._build_ref_lists(h)
            sd.no_backward = all(p.poc <= self.cur_poc
                                 for lst in sd.refs for p in lst)
            if h.temporal_mvp:
                lst = sd.refs[0 if h.collocated_from_l0 else 1]
                sd.col_pic = lst[h.collocated_ref_idx]
        sd.run()
        self.seg_carry = (sd.c.snapshot(), sd.last_cu_qp, sd.wpp_snap)

    def _resolve_lt(self, h: SliceHeader) -> list:
        """Match the slice's long-term entries against the DPB
        (8.3.2 PocLtCurr): full-POC match when the MSB cycle is sent,
        else POC-LSB match. Returns [(picture, used_by_curr)]."""
        out = []
        max_lsb = 1 << h.sps.log2_max_poc_lsb
        for lsb, used, has_msb, dmsb in h.lt:
            if has_msb:
                target = (lsb + self.cur_poc - dmsb * max_lsb
                          - (self.cur_poc & (max_lsb - 1)))
                match = [p for p in self.dpb if p.poc == target]
            else:
                match = [p for p in self.dpb
                         if (p.poc & (max_lsb - 1)) == lsb]
            if match:
                out.append((match[-1], used))
        return out

    def _build_ref_lists(self, h: SliceHeader) -> tuple[tuple, tuple]:
        """RefPicList0/1 from the short-term RPS + long-term set
        (8.3.2-8.3.4). Returns ((list0, list1), (lt0, lt1)) where ltN
        flags each entry as long-term (MV scaling is disabled against
        long-term references, 8.5.3.2.8)."""
        poc = self.cur_poc
        by_poc = {p.poc: p for p in self.dpb}
        before = [by_poc[poc + d] for d, u in h.strps.neg if u]
        after = [by_poc[poc + d] for d, u in h.strps.pos if u]
        lt_curr = [p for p, used in self._resolve_lt(h) if used]
        lists = []
        lt_flags = []
        for order in ((before + after), (after + before)):
            is_lt = [False] * len(order) + [True] * len(lt_curr)
            order = order + lt_curr
            n = h.num_ref[len(lists)]
            if not order:
                lists.append([])
                lt_flags.append([])
                continue
            tmp, tmp_lt = [], []
            while len(tmp) < n:
                tmp += order
                tmp_lt += is_lt
            mods = h.rplm[len(lists)]
            if mods is not None:
                lists.append([tmp[m] for m in mods])
                lt_flags.append([tmp_lt[m] for m in mods])
            else:
                lists.append(tmp[:n])
                lt_flags.append(tmp_lt[:n])
        if h.slice_type == SLICE_P:
            lists[1] = []
            lt_flags[1] = []
        return (lists[0], lists[1]), (lt_flags[0], lt_flags[1])

    def _compute_poc(self, h: SliceHeader, t: int) -> int:
        sps = h.sps
        if t in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
            msb = lsb = 0
        else:
            max_lsb = 1 << sps.log2_max_poc_lsb
            lsb = h.poc_lsb
            pm, pl = self.prev_poc_msb, self.prev_poc_lsb
            if t in (NAL_CRA, NAL_BLA_W_LP, 17, 18) and \
                    not self.prev_poc_valid():
                msb = 0
            elif lsb < pl and (pl - lsb) >= (max_lsb >> 1):
                msb = pm + max_lsb
            elif lsb > pl and (lsb - pl) > (max_lsb >> 1):
                msb = pm - max_lsb
            else:
                msb = pm
        # RASL/RADL and sub-layer non-ref pics don't update prevTid0
        if t not in (8, 9, 6, 7):
            self.prev_poc_msb, self.prev_poc_lsb = msb, lsb
        return msb + lsb

    def prev_poc_valid(self) -> bool:
        return self.waiting or self.prev_poc_lsb or self.prev_poc_msb

    def _finish_picture(self) -> None:
        pic = self.cur_pic
        if pic is None:
            return
        self.cur_pic = None
        if any(not h.deblocking_disabled
               for h in self.slice_headers.values()):
            deblock_picture(pic, self.slice_headers)
        if any(h.sao_luma or h.sao_chroma
               for h in self.slice_headers.values()):
            apply_sao(pic, self.slice_headers)
        self.slice_headers = {}
        self.dpb.append(pic)
        if pic.nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
            self.waiting.sort(key=lambda e: e[0])
            self.out.extend(f for _, f in self.waiting)
            self.waiting = []
        self.waiting.append((pic.poc, pic.output()))
        self.waiting.sort(key=lambda e: e[0])
        while len(self.waiting) > pic.sps.num_reorder:
            self.out.append(self.waiting.pop(0)[1])
