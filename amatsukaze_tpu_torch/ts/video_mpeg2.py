"""MPEG2 video elementary-stream parser.

Parity: MPEG2VideoParser in the reference (Amatsukaze/Mpeg2VideoParser.hpp):
sequence header/extension/display-extension (size, SAR derived from DAR,
frame-rate code, colour description), picture header + coding extension, and
the picture_structure/TFF/RFF -> PictureType mapping including field-pair
assembly (two field pictures = one frame).

The port's copy of amatsukaze_tpu/ts/video_mpeg2.py.
"""

from __future__ import annotations

import math

from ..types import (
    FrameType,
    PictureType,
    VideoFormat,
    VideoFrameInfo,
    VideoStreamFormat,
)
from ..utils.bits import BitReader, EOFError_
from ..utils.context import ErrorCounter

SEQ_HEADER_START_CODE = 0x000001B3
PICTURE_START_CODE = 0x00000100
EXTENSION_START_CODE = 0x000001B5

_FRAME_RATES = {
    1: (24000, 1001),
    2: (24, 1),
    3: (25, 1),
    4: (30000, 1001),
    5: (30, 1),
    6: (50, 1),
    7: (60000, 1001),
    8: (60, 1),
}


def _next_start_code(r: BitReader) -> bool:
    r.byte_align()
    while r.peek(24) != 1:
        if r.read(8) != 0:
            return False
    return True


class Mpeg2SequenceHeader:
    def parse(self, data) -> bool:
        r = BitReader(data)
        try:
            if r.read(32) != SEQ_HEADER_START_CODE:
                return False
            self.horizontal_size_value = r.read(12)
            self.vertical_size_value = r.read(12)
            self.aspect_ratio_info = r.read(4)
            self.frame_rate_code = r.read(4)
            if self.frame_rate_code not in _FRAME_RATES:
                # reserved code: a corrupted start-code mimic, not a
                # sequence header — reject so the parser resyncs instead
                # of raising out of the demux (stream-soak finding; the
                # reference's table lookup tolerates the same way,
                # Mpeg2VideoParser.hpp:202-215)
                return False
            self.bit_rate_value = r.read(18)
            if not r.read(1):
                return False  # marker
            self.vbv_buffer_size_value = r.read(10)
            self.constrained_parameters_flag = r.read(1)
            if r.read(1):
                r.skip(8 * 64)  # intra quantiser matrix
            if r.read(1):
                r.skip(8 * 64)  # non-intra quantiser matrix
            if not _next_start_code(r):
                return False

            # sequence extension (mandatory for MPEG2)
            if r.read(32) != EXTENSION_START_CODE:
                return False
            if r.read(4) != 0x1:
                return False
            self.profile_and_level_indication = r.read(8)
            self.progressive_sequence = r.read(1)
            self.chroma_format = r.read(2)
            self.horizontal_size_extension = r.read(2)
            self.vertical_size_extension = r.read(2)
            self.bit_rate_extension = r.read(12)
            if not r.read(1):
                return False
            self.vbv_buffer_size_extension = r.read(8)
            self.low_delay = r.read(1)
            self.frame_rate_extension_n = r.read(2)
            self.frame_rate_extension_d = r.read(5)
            if not _next_start_code(r):
                return False
            self.num_read_bytes = r.byte_pos()

            # optional sequence display extension
            self.has_display_extension = False
            self.colour_description = 0
            if r.bits_left() >= 32 and r.peek(32) == EXTENSION_START_CODE:
                r.read(32)
                if r.read(4) != 0x2:
                    return True
                self.has_display_extension = True
                self.video_format = r.read(3)
                self.colour_description = r.read(1)
                if self.colour_description:
                    self.colour_primaries = r.read(8)
                    self.transfer_characteristics = r.read(8)
                    self.matrix_coefficients = r.read(8)
                self.display_horizontal_size = r.read(14)
                r.read(1)
                self.display_vertical_size = r.read(14)
                if not _next_start_code(r):
                    return False
                self.num_read_bytes = r.byte_pos()
        except EOFError_:
            return False
        return True

    def width(self) -> int:
        return (self.horizontal_size_extension << 12) | self.horizontal_size_value

    def height(self) -> int:
        return (self.vertical_size_extension << 12) | self.vertical_size_value

    def display_width(self) -> int:
        return self.display_horizontal_size if self.has_display_extension else self.width()

    def display_height(self) -> int:
        return self.display_vertical_size if self.has_display_extension else self.height()

    def frame_rate(self) -> tuple[int, int]:
        base = _FRAME_RATES.get(self.frame_rate_code)
        if base is None:
            raise ValueError("unknown frame rate code")
        return (
            base[0] * (self.frame_rate_extension_n + 1),
            base[1] * (self.frame_rate_extension_d + 1),
        )

    def get_sar(self) -> tuple[int, int]:
        """SAR derived from the coded DAR over the display region
        (ref Mpeg2VideoParser.hpp:163-200)."""
        if self.aspect_ratio_info == 1:
            return 1, 1
        dar_w, dar_h = {2: (4, 3), 3: (16, 9), 4: (42, 19)}.get(
            self.aspect_ratio_info, (16, 9)
        )
        dw, dh = self.display_width(), self.display_height()
        sar_w, sar_h = dar_w * dh, dar_h * dw
        g = math.gcd(sar_w, sar_h) or 1
        return sar_w // g, sar_h // g


class Mpeg2PictureHeader:
    def parse(self, data) -> bool:
        r = BitReader(data)
        try:
            if r.read(32) != PICTURE_START_CODE:
                return False
            self.temporal_reference = r.read(10)
            self.picture_coding_type = r.read(3)
            self.vbv_delay = r.read(16)
            if self.picture_coding_type in (2, 3):
                r.skip(4)
            if self.picture_coding_type == 3:
                r.skip(4)
            while r.read(1):
                r.skip(8)  # extra_information_picture
            if not _next_start_code(r):
                return False

            # picture coding extension
            if r.read(32) != EXTENSION_START_CODE:
                return False
            if r.read(4) != 0x8:
                return False
            r.skip(16)  # f_code
            self.intra_dc_precision = r.read(2)
            self.picture_structure = r.read(2)
            self.top_field_first = r.read(1)
            self.frame_pred_frame_dct = r.read(1)
            self.concealment_motion_vectors = r.read(1)
            self.q_scale_type = r.read(1)
            self.intra_vlc_format = r.read(1)
            self.alternate_scan = r.read(1)
            self.repeat_first_field = r.read(1)
            self.chroma_420_type = r.read(1)
            self.progressive_frame = r.read(1)
            self.composite_display_flag = r.read(1)
            self.num_read_bytes = r.byte_pos()
        except EOFError_:
            return False
        return True


class Mpeg2VideoParser:
    """Per-PES-payload frame extraction (ref Mpeg2VideoParser.hpp:310-472)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.reset()

    def reset(self) -> None:
        self._has_seq = False
        self._seq = Mpeg2SequenceHeader()
        self._format = VideoFormat()

    def input_frame(self, frame, pts: int, dts: int) -> list[VideoFrameInfo] | None:
        """Parse one PES payload; returns frames or None on field-layout error."""
        data = bytes(frame)
        info: list[VideoFrameInfo] = []
        received_field = 0
        is_gop_start = False
        progressive = False
        pic_type = PictureType.FRAME
        ftype = FrameType.NO_INFO
        coded_size = len(data)

        b = 0
        n = len(data)
        while True:
            b = data.find(b"\x00\x00\x01", b)
            if b < 0 or b + 4 > n:
                break
            code = data[b + 3]
            if code == 0xB3:  # sequence header
                if self._seq.parse(data[b:]):
                    s = self._seq
                    fr = s.frame_rate()
                    sar = s.get_sar()
                    if s.colour_description:
                        cp, tc, cs = (
                            s.colour_primaries,
                            s.transfer_characteristics,
                            s.matrix_coefficients,
                        )
                    else:
                        cp = tc = cs = 2
                    self._format = VideoFormat(
                        format=VideoStreamFormat.MPEG2,
                        width=s.width(),
                        height=s.height(),
                        display_width=s.display_width(),
                        display_height=s.display_height(),
                        sar_width=sar[0],
                        sar_height=sar[1],
                        frame_rate_num=fr[0],
                        frame_rate_denom=fr[1],
                        color_primaries=cp,
                        transfer_characteristics=tc,
                        color_space=cs,
                        progressive=bool(s.progressive_sequence),
                        fixed_frame_rate=True,
                    )
                    self._has_seq = True
                    is_gop_start = True
                    b += s.num_read_bytes
                    continue
            elif code == 0x00:  # picture start
                pic = Mpeg2PictureHeader()
                received_field += 1
                if pic.parse(data[b:]):
                    if received_field == 1:
                        if pic.picture_structure == 1:
                            pic_type = PictureType.TFF
                        elif pic.picture_structure == 2:
                            pic_type = PictureType.BFF
                        elif pic.picture_structure == 3:
                            if self._has_seq and self._seq.progressive_sequence:
                                if pic.repeat_first_field == 0:
                                    pic_type = PictureType.FRAME
                                elif pic.top_field_first == 0:
                                    pic_type = PictureType.FRAME_DOUBLING
                                else:
                                    pic_type = PictureType.FRAME_TRIPLING
                            elif pic.repeat_first_field == 0:
                                pic_type = (
                                    PictureType.TFF if pic.top_field_first else PictureType.BFF
                                )
                            else:
                                pic_type = (
                                    PictureType.TFF_RFF
                                    if pic.top_field_first
                                    else PictureType.BFF_RFF
                                )
                            received_field += 1
                        ftype = {1: FrameType.I, 2: FrameType.P, 3: FrameType.B}.get(
                            pic.picture_coding_type, FrameType.NO_INFO
                        )
                        progressive = bool(pic.progressive_frame)
                    else:
                        # second field: must complement the first
                        if pic.picture_structure == 3 or (
                            pic_type == PictureType.TFF and pic.picture_structure != 2
                        ) or (
                            pic_type == PictureType.BFF and pic.picture_structure != 1
                        ):
                            self.ctx.incr(ErrorCounter.H264_UNEXPECTED_FIELD)
                            self.ctx.error("unexpected field layout")
                            return None
                    b += pic.num_read_bytes
                else:
                    b += 1  # bad picture header: resume scan at next byte
                if received_field > 2:
                    self.ctx.incr(ErrorCounter.H264_UNEXPECTED_FIELD)
                    self.ctx.error("unexpected field layout")
                    return None
                if received_field == 2:
                    info.append(
                        VideoFrameInfo(
                            pts=pts,
                            dts=dts,
                            is_gop_start=is_gop_start,
                            progressive=progressive,
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
                    coded_size = 0
                continue
            b += 1

        return info if info else None
