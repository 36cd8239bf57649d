"""Video format type of the filter core.

Counterpart of amatsukaze_tpu/types.py, cut to VideoFormat (parity target
Amatsukaze/StreamUtils.hpp:633-694) and what FilterGraph.output_spec
reads and rewrites of it. Field names and numeric values are the JAX
package's.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass


class VideoStreamFormat(enum.IntEnum):
    UNKNOWN = 0
    MPEG2 = 1
    H264 = 2
    H265 = 3


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

    @property
    def frame_rate(self) -> float:
        return self.frame_rate_num / self.frame_rate_denom

    def mul_div_fps(self, mul: int, div: int) -> None:
        g = math.gcd(self.frame_rate_num * mul, self.frame_rate_denom * div)
        self.frame_rate_num = self.frame_rate_num * mul // g
        self.frame_rate_denom = self.frame_rate_denom * div // g
