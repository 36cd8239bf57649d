"""H.264/AVC elementary-stream parser.

Parity: H264VideoParser in the reference (Amatsukaze/H264VideoParser.hpp):
NAL splitting with emulation-prevention removal and rbsp-stop-bit trim
(:894-927), SPS (picture size/crop, SAR, VUI timing, HRD), SEI
buffering_period / pic_timing / pan_scan_rect (:441-618), PTS/DTS
reconstruction from SEI cpb/dpb delays when the PES lacks them (:694-714),
pic_struct -> PictureType (:717-758), GOP start = SPS (:799-815).

The port's copy of amatsukaze_tpu/ts/video_h264.py.
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
from ..utils.context import ErrorCounter

_SAR_FROM_IDC = {
    1: (1, 1), 2: (12, 11), 3: (10, 11), 4: (16, 11), 5: (40, 33),
    6: (24, 11), 7: (20, 11), 8: (32, 11), 9: (80, 33), 10: (18, 11),
    11: (15, 11), 12: (64, 33), 13: (160, 99), 14: (4, 3), 15: (3, 2),
    16: (2, 1),
}
_EXTENDED_SAR = 255

_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86}


class H264HRDParameters:
    def read(self, r: BitReader) -> None:
        self.cpb_cnt_minus1 = r.ue()
        r.skip(8)  # bit_rate_scale + cpb_size_scale
        for _ in range(self.cpb_cnt_minus1 + 1):
            r.ue()  # bit_rate_value_minus1
            r.ue()  # cpb_size_value_minus1
            r.read(1)  # cbr_flag
        self.initial_cpb_removal_delay_length_minus1 = r.read(5)
        self.cpb_removal_delay_length_minus1 = r.read(5)
        self.dpb_output_delay_length_minus1 = r.read(5)
        self.time_offset_length = r.read(5)


class H264SPS:
    def parse(self, data) -> bool:
        self.chroma_format_idc = 1
        self.separate_colour_plane_flag = 0
        self.vui_parameters_present_flag = 0
        self.aspect_ratio_info_present_flag = 0
        self.colour_description_present_flag = 0
        self.timing_info_present_flag = 0
        self.nal_hrd_parameters_present_flag = 0
        self.vcl_hrd_parameters_present_flag = 0
        self.pic_struct_present_flag = 0
        self.nal_hrd_parameters = None
        r = BitReader(data)
        try:
            self.profile_idc = r.read(8)
            r.skip(8)  # constraint flags + reserved
            self.level_idc = r.read(8)
            r.ue()  # seq_parameter_set_id
            if self.profile_idc in _HIGH_PROFILES:
                self.chroma_format_idc = r.ue()
                if self.chroma_format_idc == 3:
                    self.separate_colour_plane_flag = r.read(1)
                r.ue()  # bit_depth_luma_minus8
                r.ue()  # bit_depth_chroma_minus8
                r.read(1)  # qpprime_y_zero_transform_bypass_flag
                if r.read(1):  # seq_scaling_matrix_present_flag
                    n = 8 if self.chroma_format_idc != 3 else 12
                    for i in range(n):
                        if r.read(1):
                            self._scaling_list(r, 16 if i < 6 else 64)
            r.ue()  # log2_max_frame_num_minus4
            poc_type = r.ue()
            if poc_type == 0:
                r.ue()
            elif poc_type == 1:
                r.read(1)
                r.se()
                r.se()
                for _ in range(r.ue()):
                    r.se()
            r.ue()  # max_num_ref_frames
            r.read(1)  # gaps_in_frame_num_value_allowed_flag
            self.pic_width_in_mbs_minus1 = r.ue()
            self.pic_height_in_map_units_minus1 = r.ue()
            self.frame_mbs_only_flag = r.read(1)
            if not self.frame_mbs_only_flag:
                r.read(1)  # mb_adaptive_frame_field_flag
            r.read(1)  # direct_8x8_inference_flag
            self.frame_cropping_flag = r.read(1)
            self.crop = (0, 0, 0, 0)
            if self.frame_cropping_flag:
                self.crop = (r.ue(), r.ue(), r.ue(), r.ue())  # l, r, t, b
            self.vui_parameters_present_flag = r.read(1)
            if self.vui_parameters_present_flag:
                self._vui(r)
        except EOFError_:
            return False
        return True

    def _scaling_list(self, r: BitReader, size: int) -> None:
        last, nxt = 8, 8
        for _ in range(size):
            if nxt != 0:
                nxt = (last + r.se() + 256) % 256
            last = last if nxt == 0 else nxt

    def _vui(self, r: BitReader) -> None:
        self.aspect_ratio_info_present_flag = r.read(1)
        if self.aspect_ratio_info_present_flag:
            self.aspect_ratio_idc = r.read(8)
            if self.aspect_ratio_idc == _EXTENDED_SAR:
                self.sar_width = r.read(16)
                self.sar_height = r.read(16)
        if r.read(1):  # overscan_info_present_flag
            r.read(1)
        if r.read(1):  # video_signal_type_present_flag
            r.read(3)  # video_format
            r.read(1)  # video_full_range_flag
            self.colour_description_present_flag = r.read(1)
            if self.colour_description_present_flag:
                self.colour_primaries = r.read(8)
                self.transfer_characteristics = r.read(8)
                self.matrix_coefficients = r.read(8)
        if r.read(1):  # chroma_loc_info_present_flag
            r.ue()
            r.ue()
        self.timing_info_present_flag = r.read(1)
        if self.timing_info_present_flag:
            self.num_units_in_tick = r.read(32)
            self.time_scale = r.read(32)
            self.fixed_frame_rate_flag = r.read(1)
        self.nal_hrd_parameters_present_flag = r.read(1)
        if self.nal_hrd_parameters_present_flag:
            self.nal_hrd_parameters = H264HRDParameters()
            self.nal_hrd_parameters.read(r)
        self.vcl_hrd_parameters_present_flag = r.read(1)
        if self.vcl_hrd_parameters_present_flag:
            hrd = H264HRDParameters()
            hrd.read(r)
        if self.nal_hrd_parameters_present_flag or self.vcl_hrd_parameters_present_flag:
            r.read(1)  # low_delay_hrd_flag
        self.pic_struct_present_flag = r.read(1)
        # bitstream_restriction not needed

    # -- derived ---------------------------------------------------------------
    def picture_size(self) -> tuple[int, int]:
        w = (self.pic_width_in_mbs_minus1 + 1) * 16
        h = (2 - self.frame_mbs_only_flag) * (self.pic_height_in_map_units_minus1 + 1) * 16
        if self.frame_cropping_flag:
            sub_w, sub_h = {2: (2, 1), 3: (1, 1)}.get(self.chroma_format_idc, (2, 2))
            chroma_array_type = 0 if self.separate_colour_plane_flag else self.chroma_format_idc
            if chroma_array_type == 0:
                ux, uy = 1, 2 - self.frame_mbs_only_flag
            else:
                ux, uy = sub_w, sub_h * (2 - self.frame_mbs_only_flag)
            l, rr, t, b = self.crop
            w -= (l + rr) * ux
            h -= (t + b) * uy
        return w, h

    def get_sar(self) -> tuple[int, int]:
        if not self.vui_parameters_present_flag or not self.aspect_ratio_info_present_flag:
            return 0, 1  # unspecified (matches ffmpeg / ref :251-255)
        if self.aspect_ratio_idc == _EXTENDED_SAR:
            return self.sar_width, self.sar_height
        return _SAR_FROM_IDC.get(self.aspect_ratio_idc, (1, 1))

    def frame_rate(self) -> tuple[int, int, bool] | None:
        if self.vui_parameters_present_flag and self.timing_info_present_flag:
            return self.time_scale // 2, self.num_units_in_tick, bool(self.fixed_frame_rate_flag)
        return None

    def color_desc(self) -> tuple[int, int, int]:
        if not self.vui_parameters_present_flag or not self.colour_description_present_flag:
            return 2, 2, 2
        return self.colour_primaries, self.transfer_characteristics, self.matrix_coefficients

    def clock_tick(self) -> float:
        if not self.timing_info_present_flag:
            raise ValueError("no VUI timing info")
        return self.num_units_in_tick / self.time_scale


class H264SEI:
    """buffering_period / pic_timing / pan_scan_rect decode (ref :441-618)."""

    def __init__(self):
        self.nal_hrd_parameters_present_flag = 0
        self.vcl_hrd_parameters_present_flag = 0
        self.pic_struct_present_flag = 0
        self.cpb_removal_delay_length_minus1 = 23
        self.dpb_output_delay_length_minus1 = 23
        self.initial_cpb_removal_delay_length_minus1 = 23

    def update_sps(self, sps: H264SPS) -> None:
        self.nal_hrd_parameters_present_flag = sps.nal_hrd_parameters_present_flag
        self.vcl_hrd_parameters_present_flag = sps.vcl_hrd_parameters_present_flag
        self.pic_struct_present_flag = sps.pic_struct_present_flag
        if sps.nal_hrd_parameters_present_flag and sps.nal_hrd_parameters:
            hrd = sps.nal_hrd_parameters
            self.initial_cpb_removal_delay_length_minus1 = (
                hrd.initial_cpb_removal_delay_length_minus1
            )
            self.cpb_removal_delay_length_minus1 = hrd.cpb_removal_delay_length_minus1
            self.dpb_output_delay_length_minus1 = hrd.dpb_output_delay_length_minus1

    def parse(self, data) -> bool:
        self.has_buffering_period = False
        self.has_pic_timing = False
        self.has_pan_scan_rect = False
        self.pan_scan_rect_offset: list[tuple[int, int, int, int]] = []
        r = BitReader(data)
        n = len(bytes(data))
        try:
            while r.byte_pos() < n:
                ptype = self._payload_int(r)
                psize = self._payload_int(r)
                sub = BitReader(bytes(data), r.pos)
                if ptype == 0:
                    self.has_buffering_period = True
                elif ptype == 1:
                    self.has_pic_timing = True
                    if (
                        self.nal_hrd_parameters_present_flag
                        or self.vcl_hrd_parameters_present_flag
                    ):
                        self.cpb_removal_delay = sub.read(
                            self.cpb_removal_delay_length_minus1 + 1
                        )
                        self.dpb_output_delay = sub.read(
                            self.dpb_output_delay_length_minus1 + 1
                        )
                    if self.pic_struct_present_flag:
                        self.pic_struct = sub.read(4)
                elif ptype == 2:
                    self.has_pan_scan_rect = True
                    sub.ue()  # pan_scan_rect_id
                    if not sub.read(1):  # !cancel
                        cnt = sub.ue() + 1
                        for _ in range(cnt):
                            self.pan_scan_rect_offset.append(
                                (sub.ue(), sub.ue(), sub.ue(), sub.ue())
                            )
                r.skip(psize * 8)
        except EOFError_:
            return False
        return True

    @staticmethod
    def _payload_int(r: BitReader) -> int:
        v = 0
        while True:
            b = r.read(8)
            if b != 0xFF:
                return v + b
            v += 255


def split_nal_units(data: bytes) -> list[bytes]:
    """Split an annex-B byte stream into de-emulated NAL payloads.

    Matches the reference storeBuffer (:894-927): start codes detected on the
    raw stream, 0x000003 emulation bytes removed, trailing zeros and the
    rbsp_stop_one_bit trimmed per NAL.
    """
    out = []
    pos = data.find(b"\x00\x00\x01")
    while pos >= 0:
        start = pos + 3
        nxt = data.find(b"\x00\x00\x01", start)
        raw = data[start : nxt if nxt >= 0 else len(data)]
        payload = raw.replace(b"\x00\x00\x03", b"\x00\x00").rstrip(b"\x00")
        if payload:
            last = payload[-1]
            if last == 0x80:
                payload = payload[:-1]
            else:
                payload = payload[:-1] + bytes([last & (last - 1)])
            if payload:
                out.append(payload)
        pos = nxt
    return out


class H264VideoParser:
    """Per-PES-payload frame extraction (ref H264VideoParser.hpp:620-843)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self._sps = H264SPS()
        self._sei = H264SEI()
        self._format = VideoFormat()
        self.reset()

    def reset(self) -> None:
        self._bp_dts = -1  # DTS of the last buffering-period AU

    def input_frame(self, frame, pts: int, dts: int) -> list[VideoFrameInfo] | None:
        data = bytes(frame)
        if len(data) < 4:
            return None
        info: list[VideoFrameInfo] = []
        nals = split_nal_units(data)

        received_field = 0
        is_gop_start = False
        pic_type = PictureType.FRAME
        ftype = FrameType.NO_INFO
        dts_from_sei = -1
        pts_from_sei = -1
        next_bp_dts = self._bp_dts
        coded_size = sum(len(n) for n in nals)

        for nal in nals:
            nal_unit_type = nal[0] & 0x1F
            payload = nal[1:]

            if nal_unit_type == 6:  # SEI
                if self._format.is_empty():
                    continue  # need SPS first
                if not self._sei.parse(payload):
                    continue
                sei = self._sei
                if sei.has_buffering_period and dts != -1:
                    next_bp_dts = dts
                if sei.has_pic_timing:
                    if received_field == 0 and self._bp_dts != -1 and hasattr(sei, "cpb_removal_delay"):
                        tick = self._sps.clock_tick()
                        dts_delay = sei.cpb_removal_delay * tick
                        pts_delay = sei.dpb_output_delay * tick
                        dts_from_sei = (self._bp_dts + round(dts_delay * 90000)) & ((1 << 33) - 1)
                        pts_from_sei = (
                            self._bp_dts + round((dts_delay + pts_delay) * 90000)
                        ) & ((1 << 33) - 1)
                        if pts != -1 and abs(pts - pts_from_sei) > 1:
                            self.ctx.incr(ErrorCounter.H264_PTS_MISMATCH)
                            self.ctx.warn("[h264] PTS mismatch vs SEI")
                    if sei.pic_struct_present_flag and hasattr(sei, "pic_struct"):
                        ps = sei.pic_struct
                        if ps == 0:
                            pic_type = PictureType.FRAME
                            received_field += 2
                        elif ps == 7:
                            pic_type = PictureType.FRAME_DOUBLING
                            received_field += 2
                        elif ps == 8:
                            pic_type = PictureType.FRAME_TRIPLING
                            received_field += 2
                        elif ps == 1:
                            if received_field == 0:
                                pic_type = PictureType.TFF
                            received_field += 1
                        elif ps == 2:
                            if received_field == 0:
                                pic_type = PictureType.BFF
                            received_field += 1
                        elif ps == 3:
                            pic_type = PictureType.TFF
                            received_field += 2
                        elif ps == 4:
                            pic_type = PictureType.BFF
                            received_field += 2
                        elif ps == 5:
                            pic_type = PictureType.TFF_RFF
                            received_field += 2
                        elif ps == 6:
                            pic_type = PictureType.BFF_RFF
                            received_field += 2
                if sei.has_pan_scan_rect and sei.pan_scan_rect_offset:
                    l, rr, t, b = sei.pan_scan_rect_offset[0]
                    self._format.display_width = (16 * self._format.width - l + rr) >> 4
                    self._format.display_height = (16 * self._format.height - t + b) >> 4
                if received_field > 2:
                    self.ctx.incr(ErrorCounter.H264_UNEXPECTED_FIELD)
                    self.ctx.warn("[h264] unexpected field layout")
                    continue
                if received_field == 2:
                    info.append(
                        VideoFrameInfo(
                            pts=pts if pts != -1 else pts_from_sei,
                            dts=dts if dts != -1 else dts_from_sei,
                            is_gop_start=is_gop_start,
                            progressive=bool(self._sps.frame_mbs_only_flag),
                            pic=pic_type,
                            type=ftype,
                            coded_data_size=coded_size,
                            format=self._format,
                        )
                    )
                    received_field = 0
                    is_gop_start = False
                    pic_type = PictureType.FRAME
                    ftype = FrameType.NO_INFO
                    pts_from_sei = -1
                    coded_size = 0
                    dts = pts = -1  # only the first frame gets the PES stamps

            elif nal_unit_type == 7:  # SPS
                if self._sps.parse(payload):
                    sps = self._sps
                    self._sei.update_sps(sps)
                    is_gop_start = True
                    w, h = sps.picture_size()
                    sar = sps.get_sar()
                    cp, tc, cs = sps.color_desc()
                    fr = sps.frame_rate()
                    self._format = VideoFormat(
                        format=VideoStreamFormat.H264,
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
                        progressive=bool(sps.frame_mbs_only_flag),
                        fixed_frame_rate=fr[2] if fr else True,
                    )

            elif nal_unit_type == 9:  # AU delimiter
                primary_pic_type = (payload[0] >> 5) & 0x7 if payload else 7
                ftype = {
                    0: FrameType.I, 3: FrameType.I, 5: FrameType.I,
                    1: FrameType.P, 4: FrameType.P, 6: FrameType.P,
                    2: FrameType.B, 7: FrameType.B,
                }.get(primary_pic_type, FrameType.NO_INFO)
                self._bp_dts = next_bp_dts

        if self._format.is_empty():
            # no SPS yet: tolerated at stream start (ref :836-839)
            return []
        return info if info else None
