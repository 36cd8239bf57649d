"""Core media types shared by every layer.

Parity target: the core enums/structs in the reference
(Amatsukaze/StreamUtils.hpp:520-819): PICTURE_TYPE, FRAME_TYPE,
VIDEO_STREAM_FORMAT, AUDIO_CHANNELS, VideoFormat, AudioFormat,
VideoFrameInfo, AudioFrameInfo, CMType, EncodeFileKey (key packing at
StreamUtils.hpp:546-562). Field names and numeric values preserved so
serialized decisions/reports are comparable.

The port's copy of amatsukaze_tpu/types.py.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field


class VideoStreamFormat(enum.IntEnum):
    UNKNOWN = 0
    MPEG2 = 1
    H264 = 2
    H265 = 3


class PictureType(enum.IntEnum):
    """Frame presentation structure (progressive / field order / RFF pulldown)."""

    FRAME = 0
    FRAME_DOUBLING = 1
    FRAME_TRIPLING = 2
    TFF = 3
    BFF = 4
    TFF_RFF = 5
    BFF_RFF = 6

    def __str__(self) -> str:
        return _PIC_NAMES[self]


_PIC_NAMES = {
    PictureType.FRAME: "FRAME",
    PictureType.FRAME_DOUBLING: "DBL",
    PictureType.FRAME_TRIPLING: "TLP",
    PictureType.TFF: "TFF",
    PictureType.BFF: "BFF",
    PictureType.TFF_RFF: "TFF_RFF",
    PictureType.BFF_RFF: "BFF_RFF",
}


def presenting_time(pic: PictureType, frame_rate: float) -> float:
    """Display duration of one coded picture (ref StreamUtils.hpp:617-631)."""
    mul = {
        PictureType.FRAME_DOUBLING: 2.0,
        PictureType.FRAME_TRIPLING: 3.0,
        PictureType.TFF_RFF: 1.5,
        PictureType.BFF_RFF: 1.5,
    }.get(pic, 1.0)
    return mul / frame_rate


class FrameType(enum.IntEnum):
    NO_INFO = 0
    I = 1
    P = 2
    B = 3
    OTHER = 4


class CMType(enum.IntEnum):
    """Output-file CM classification (ref StreamUtils.hpp:538-543)."""

    BOTH = 0
    NONCM = 1
    CM = 2

    @property
    def suffix(self) -> str:
        # output filename suffixes (ref TranscodeSetting.hpp:999-1030)
        return {CMType.BOTH: "", CMType.NONCM: "-main", CMType.CM: "-cm"}[self]


class AudioChannels(enum.IntEnum):
    """ARIB/AAC channel configurations (ref StreamUtils.hpp:709-729)."""

    NONE = 0
    MONO = 1
    STEREO = 2
    CH_30 = 3
    CH_31 = 4
    CH_32 = 5
    CH_32_LFE = 6  # 5.1ch
    CH_21 = 7
    CH_22 = 8
    CH_2LANG = 9  # dual mono (1/0 + 1/0)
    CH_52_LFE = 10  # 7.1ch
    CH_33_LFE = 11
    CH_2_22_LFE = 12
    CH_322_LFE = 13
    CH_2_32_LFE = 14
    CH_020_32_LFE = 15
    CH_2_323_2LFE = 16
    CH_333_523_3_2LFE = 17  # 22.2ch


NUM_AUDIO_CHANNELS = {
    AudioChannels.MONO: 1,
    AudioChannels.STEREO: 2,
    AudioChannels.CH_30: 3,
    AudioChannels.CH_31: 4,
    AudioChannels.CH_32: 5,
    AudioChannels.CH_32_LFE: 6,
    AudioChannels.CH_21: 3,
    AudioChannels.CH_22: 4,
    AudioChannels.CH_2LANG: 2,
    AudioChannels.CH_52_LFE: 8,
    AudioChannels.CH_33_LFE: 7,
    AudioChannels.CH_2_22_LFE: 7,
    AudioChannels.CH_322_LFE: 8,
    AudioChannels.CH_2_32_LFE: 8,
    AudioChannels.CH_020_32_LFE: 8,
    AudioChannels.CH_2_323_2LFE: 12,
    AudioChannels.CH_333_523_3_2LFE: 24,
}

AUDIO_CHANNEL_NAMES = {
    AudioChannels.MONO: "mono",
    AudioChannels.STEREO: "stereo",
    AudioChannels.CH_30: "3/0",
    AudioChannels.CH_31: "3/1",
    AudioChannels.CH_32: "3/2",
    AudioChannels.CH_32_LFE: "5.1ch",
    AudioChannels.CH_21: "2/1",
    AudioChannels.CH_22: "2/2",
    AudioChannels.CH_2LANG: "dualmono",
    AudioChannels.CH_52_LFE: "7.1ch",
    AudioChannels.CH_33_LFE: "3/3.1",
    AudioChannels.CH_2_22_LFE: "2/0/0-2/0/2-0.1",
    AudioChannels.CH_322_LFE: "3/2/2.1",
    AudioChannels.CH_2_32_LFE: "2/0/0-3/0/2-0.1",
    AudioChannels.CH_020_32_LFE: "0/2/0-3/0/2-0.1",
    AudioChannels.CH_2_323_2LFE: "2/0/0-3/2/3-0.2",
    AudioChannels.CH_333_523_3_2LFE: "22.2ch",
}


@dataclass
class VideoFormat:
    """Coded video format (ref StreamUtils.hpp:633-694)."""

    format: VideoStreamFormat = VideoStreamFormat.UNKNOWN
    width: int = 0
    height: int = 0
    display_width: int = 0
    display_height: int = 0
    sar_width: int = 1
    sar_height: int = 1
    frame_rate_num: int = 0
    frame_rate_denom: int = 1
    color_primaries: int = 2  # unspecified
    transfer_characteristics: int = 2
    color_space: int = 2
    progressive: bool = False
    fixed_frame_rate: bool = True

    def is_empty(self) -> bool:
        return self.width == 0

    @property
    def frame_rate(self) -> float:
        return self.frame_rate_num / self.frame_rate_denom

    def mul_div_fps(self, mul: int, div: int) -> None:
        g = math.gcd(self.frame_rate_num * mul, self.frame_rate_denom * div)
        self.frame_rate_num = self.frame_rate_num * mul // g
        self.frame_rate_denom = self.frame_rate_denom * div // g

    def get_dar(self) -> tuple[int, int]:
        w = self.display_width * self.sar_width
        h = self.display_height * self.sar_height
        g = math.gcd(w, h) or 1
        return w // g, h // g

    def is_basic_equals(self, o: "VideoFormat") -> bool:
        """Equality ignoring aspect ratio (ref StreamUtils.hpp:667-671)."""
        return (
            self.width == o.width
            and self.height == o.height
            and self.frame_rate_num == o.frame_rate_num
            and self.frame_rate_denom == o.frame_rate_denom
            and self.progressive == o.progressive
        )

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, VideoFormat)
            and self.is_basic_equals(o)
            and self.display_width == o.display_width
            and self.display_height == o.display_height
            and self.sar_width == o.sar_width
            and self.sar_height == o.sar_height
        )


@dataclass
class VideoFrameInfo:
    """One coded picture as seen by the ES parsers (ref StreamUtils.hpp:696-705)."""

    pts: int = -1  # 90 kHz, -1 = unknown
    dts: int = -1
    is_gop_start: bool = False  # MPEG2: seq header; H264: SPS
    progressive: bool = False
    pic: PictureType = PictureType.FRAME
    type: FrameType = FrameType.NO_INFO
    coded_data_size: int = 0
    format: VideoFormat = field(default_factory=VideoFormat)


@dataclass(frozen=True)
class AudioFormat:
    channels: AudioChannels = AudioChannels.NONE
    sample_rate: int = 0


@dataclass
class AudioFrameInfo:
    pts: int = -1
    num_samples: int = 0  # per channel
    format: AudioFormat = field(default_factory=AudioFormat)


@dataclass
class AudioFrameData(AudioFrameInfo):
    coded_data: bytes = b""
    decoded_data: bytes = b""  # interleaved s16le PCM


@dataclass(frozen=True, order=True)
class EncodeFileKey:
    """Output-file identity (ref StreamUtils.hpp:546-562).

    video  : intermediate-file index (video format switches)
    format : format index within the video file (audio & misc format changes)
    div    : split index (CM-structure splits)
    cm     : CM classification of this output
    """

    video: int = 0
    format: int = 0
    div: int = 0
    cm: CMType = CMType.BOTH

    def key(self) -> int:
        return (self.video << 24) | (self.format << 14) | (self.div << 4) | int(self.cm)
