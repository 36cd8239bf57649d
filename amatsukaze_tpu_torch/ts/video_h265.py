"""H.265/HEVC elementary-stream parser.

The reference's TS layer recognises stream_type 0x24 only for display
(Mpeg2TsParser.hpp:1420 comments it out of isVideo, :1454 names it), so
HEVC TS input is beyond-parity here: this parser gives the splitter the
same VideoFrameInfo surface the MPEG2/H.264 parsers provide (format from
the SPS incl. VUI SAR/colour/timing, per-AU PTS/DTS, GOP starts at IRAP,
frame type from the first slice header), enabling in-build HEVC ingest.
Structure mirrors video_h264.py (ref H264VideoParser.hpp:620-843).

The port's copy of amatsukaze_tpu/ts/video_h265.py.
"""

from __future__ import annotations

from ..types import (
    FrameType,
    PictureType,
    VideoFormat,
    VideoFrameInfo,
    VideoStreamFormat,
)
from ..utils.bits import BitReader, EOFError_
from .video_h264 import _SAR_FROM_IDC, _EXTENDED_SAR, split_nal_units

# NAL unit types (Table 7-1)
_NAL_VCL_MAX = 31
_NAL_IRAP_MIN, _NAL_IRAP_MAX = 16, 23  # BLA_W_LP .. RSV_IRAP_VCL23
NAL_VPS, NAL_SPS, NAL_PPS, NAL_AUD = 32, 33, 34, 35


def _skip_ptl(r: BitReader, max_sub_layers_minus1: int) -> tuple[int, int]:
    """profile_tier_level (7.3.3); returns (progressive_source_flag,
    interlaced_source_flag)."""
    r.skip(8 + 32)  # space/tier/profile_idc + compat flags
    prog = r.read(1)
    ilace = r.read(1)
    r.skip(46)  # non_packed, frame_only, reserved 44
    r.skip(8)  # general_level_idc
    sub = [(r.read(1), r.read(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1 > 0:
        r.skip(2 * (8 - max_sub_layers_minus1))
    for pp, lp in sub:
        if pp:
            r.skip(88)
        if lp:
            r.skip(8)
    return prog, ilace


def _skip_scaling_list_data(r: BitReader) -> None:
    for size_id in range(4):
        for _ in range(6 if size_id != 3 else 2):
            if not r.read(1):  # scaling_list_pred_mode_flag
                r.ue()  # pred_matrix_id_delta
            else:
                if size_id > 1:
                    r.se()  # dc_coef_minus8
                for _ in range(min(64, 1 << (4 + (size_id << 1)))):
                    r.se()  # delta_coef


def _skip_strps(r: BitReader, idx: int, num_delta_pocs: list[int],
                num_sets: int) -> None:
    """st_ref_pic_set (7.3.7), contents skipped; appends NumDeltaPocs."""
    inter = r.read(1) if idx != 0 else 0
    if inter:
        delta_idx = (r.ue() + 1) if idx == num_sets else 1
        r.read(1)  # delta_rps_sign
        r.ue()  # abs_delta_rps_minus1
        nd = num_delta_pocs[idx - delta_idx]
        n = 0
        for _ in range(nd + 1):
            used = r.read(1)
            use_delta = 1 if used else r.read(1)
            if used or use_delta:
                n += 1
        # upper bound: actual NumDeltaPocs needs the full derivation, but
        # the TS layer only needs a bound for subsequent inter-RPS skips,
        # and inter-coded sets never grow (7.4.8)
        num_delta_pocs.append(n)
    else:
        n_neg = r.ue()
        n_pos = r.ue()
        for _ in range(n_neg + n_pos):
            r.ue()  # delta_poc_minus1
            r.read(1)  # used_by_curr_pic
        num_delta_pocs.append(n_neg + n_pos)


class H265SPS:
    """TS-layer SPS view: tolerant of tools the pixel decoder rejects
    (10-bit, scaling lists, PCM) -- format reporting must never crash."""

    def parse(self, payload: bytes) -> bool:
        r = BitReader(payload, 16)  # 2-byte NAL header
        self.aspect_ratio_info_present_flag = 0
        self.colour_description_present_flag = 0
        self.timing_info_present_flag = 0
        self.field_seq_flag = 0
        try:
            r.read(4)  # sps_video_parameter_set_id
            max_sub = r.read(3)
            r.read(1)  # temporal_id_nesting
            self.ptl_progressive, self.ptl_interlaced = _skip_ptl(r, max_sub)
            self.id = r.ue()
            self.chroma_format_idc = r.ue()
            if self.chroma_format_idc == 3:
                r.read(1)
            self.width = r.ue()
            self.height = r.ue()
            self.conf_win = (0, 0, 0, 0)
            if r.read(1):
                self.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
            self.bit_depth = r.ue() + 8
            self.bit_depth_c = r.ue() + 8
            self.log2_max_poc_lsb = r.ue() + 4
            sub_ordering = r.read(1)
            for _ in range((max_sub + 1) if sub_ordering else 1):
                r.ue()  # max_dec_pic_buffering_minus1
                r.ue()  # num_reorder_pics
                r.ue()  # max_latency_increase_plus1
            log2_min_cb = r.ue() + 3
            self.log2_ctb = log2_min_cb + r.ue()
            r.ue()  # log2_min_tb
            r.ue()  # log2_diff_max_min_tb
            r.ue()  # max_transform_hierarchy_depth_inter
            r.ue()  # ... intra
            if r.read(1):  # scaling_list_enabled
                if r.read(1):  # sps_scaling_list_data_present
                    _skip_scaling_list_data(r)
            r.read(1)  # amp_enabled
            r.read(1)  # sao_enabled
            if r.read(1):  # pcm_enabled
                r.skip(8)  # sample bit depths
                r.ue()  # log2_min_pcm_cb
                r.ue()  # log2_diff_max_min_pcm_cb
                r.read(1)  # pcm_loop_filter_disabled
            n_sets = r.ue()
            ndp: list[int] = []
            for i in range(n_sets):
                _skip_strps(r, i, ndp, n_sets)
            if r.read(1):  # long_term_ref_pics_present
                for _ in range(r.ue()):
                    r.read(self.log2_max_poc_lsb)
                    r.read(1)
            r.read(1)  # temporal_mvp
            r.read(1)  # strong_intra_smoothing
            if r.read(1):  # vui_parameters_present
                self._vui(r)
        except (EOFError_, IndexError):
            return False
        return True

    def _vui(self, r: BitReader) -> None:
        """vui_parameters (E.2.1) through timing_info."""
        self.aspect_ratio_info_present_flag = r.read(1)
        if self.aspect_ratio_info_present_flag:
            self.aspect_ratio_idc = r.read(8)
            if self.aspect_ratio_idc == _EXTENDED_SAR:
                self.sar_width = r.read(16)
                self.sar_height = r.read(16)
        if r.read(1):  # overscan_info_present
            r.read(1)
        if r.read(1):  # video_signal_type_present
            r.read(4)  # video_format + full_range
            self.colour_description_present_flag = r.read(1)
            if self.colour_description_present_flag:
                self.colour_primaries = r.read(8)
                self.transfer_characteristics = r.read(8)
                self.matrix_coeffs = r.read(8)
        if r.read(1):  # chroma_loc_info_present
            r.ue()
            r.ue()
        r.read(1)  # neutral_chroma_indication
        self.field_seq_flag = r.read(1)
        r.read(1)  # frame_field_info_present
        if r.read(1):  # default_display_window
            r.ue(), r.ue(), r.ue(), r.ue()
        self.timing_info_present_flag = r.read(1)
        if self.timing_info_present_flag:
            self.num_units_in_tick = r.read(32)
            self.time_scale = r.read(32)

    def picture_size(self) -> tuple[int, int]:
        sub = 2 if self.chroma_format_idc == 1 else 1
        subh = 2 if self.chroma_format_idc in (1, 2) else 1
        cl, cr, ct, cb = self.conf_win
        return (self.width - subh * (cl + cr), self.height - sub * (ct + cb))

    def get_sar(self) -> tuple[int, int]:
        if not self.aspect_ratio_info_present_flag:
            return 1, 1
        if self.aspect_ratio_idc == _EXTENDED_SAR:
            return self.sar_width, self.sar_height
        return _SAR_FROM_IDC.get(self.aspect_ratio_idc, (1, 1))

    def frame_rate(self) -> tuple[int, int] | None:
        if not self.timing_info_present_flag or not self.num_units_in_tick:
            return None
        return self.time_scale, self.num_units_in_tick

    def color_desc(self) -> tuple[int, int, int]:
        if self.colour_description_present_flag:
            return (self.colour_primaries, self.transfer_characteristics,
                    self.matrix_coeffs)
        return 2, 2, 2


class H265VideoParser:
    """Per-PES-payload frame extraction.

    One VideoFrameInfo per access unit, keyed on the first-slice flag of
    VCL NALs; frame type from the first slice header's slice_type."""

    def __init__(self, ctx):
        self.ctx = ctx
        self._sps = H265SPS()
        self._format = VideoFormat()
        # pps_id -> (dependent_slices_enabled, num_extra_slice_header_bits)
        self._pps: dict[int, tuple[int, int]] = {}
        self.reset()

    def reset(self) -> None:
        pass

    def _slice_type(self, payload: bytes, nal_type: int) -> int | None:
        """slice_type of a first-slice segment header (7.3.6.1), or None."""
        r = BitReader(payload, 16)
        try:
            if not r.read(1):  # first_slice_segment_in_pic_flag
                return None
            if _NAL_IRAP_MIN <= nal_type <= _NAL_IRAP_MAX:
                r.read(1)  # no_output_of_prior_pics_flag
            pps_id = r.ue()
            extra = self._pps.get(pps_id, (0, 0))[1]
            r.skip(extra)
            return r.ue()  # slice_type: 0=B 1=P 2=I
        except (EOFError_, IndexError):
            return None

    def input_frame(self, frame, pts: int, dts: int) -> list[VideoFrameInfo] | None:
        data = bytes(frame)
        if len(data) < 5:
            return None
        info: list[VideoFrameInfo] = []
        nals = split_nal_units(data)
        is_gop_start = False
        coded_size = sum(len(n) for n in nals)

        for nal in nals:
            if len(nal) < 2:
                continue
            nal_type = (nal[0] >> 1) & 0x3F

            if nal_type == NAL_SPS:
                if self._sps.parse(nal):
                    sps = self._sps
                    w, h = sps.picture_size()
                    sar = sps.get_sar()
                    cp, tc, cs = sps.color_desc()
                    fr = sps.frame_rate()
                    progressive = not (sps.field_seq_flag
                                       or (sps.ptl_interlaced
                                           and not sps.ptl_progressive))
                    self._format = VideoFormat(
                        format=VideoStreamFormat.H265,
                        width=w,
                        height=h,
                        display_width=w,
                        display_height=h,
                        sar_width=sar[0],
                        sar_height=sar[1],
                        frame_rate_num=fr[0] if fr else 0,
                        frame_rate_denom=fr[1] if fr else 1,
                        color_primaries=cp,
                        transfer_characteristics=tc,
                        color_space=cs,
                        progressive=progressive,
                        fixed_frame_rate=True,
                    )

            elif nal_type == NAL_PPS:
                r = BitReader(nal, 16)
                try:
                    pid = r.ue()
                    r.ue()  # sps id
                    dep = r.read(1)
                    r.read(1)  # output_flag_present
                    extra = r.read(3)
                    self._pps[pid] = (dep, extra)
                except (EOFError_, IndexError):
                    pass

            elif nal_type <= _NAL_VCL_MAX:
                if self._format.is_empty():
                    continue  # need SPS first
                st = self._slice_type(nal, nal_type)
                if st is None:
                    continue  # continuation slice segment
                irap = _NAL_IRAP_MIN <= nal_type <= _NAL_IRAP_MAX
                ftype = (FrameType.I if irap or st == 2
                         else FrameType.P if st == 1 else FrameType.B)
                info.append(VideoFrameInfo(
                    pts=pts,
                    dts=dts if dts != -1 else pts,
                    is_gop_start=is_gop_start or irap,
                    progressive=self._format.progressive,
                    pic=PictureType.FRAME,
                    type=ftype,
                    coded_data_size=coded_size,
                    format=self._format,
                ))
                is_gop_start = False
                coded_size = 0
                pts = dts = -1  # only the first AU gets the PES stamps

        if self._format.is_empty():
            return []  # no SPS yet: tolerated at stream start
        return info if info else None
