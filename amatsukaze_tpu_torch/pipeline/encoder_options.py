"""Encoder option introspection.

Parity: ParseEncoderOption (Amatsukaze/EncoderOptionParser.hpp:50-184):
learn from the QSV/NVEnc/VCEEnc option string whether the encoder itself
deinterlaces (24p/30p/60p/VFR), emits an afs timecode, drops frames with
--vpp-select-every, and which codec it outputs - so the muxer can fix
fps/progressive flags. x264/x265 imply their codec with no hw deint.

The port's copy of amatsukaze_tpu/pipeline/encoder_options.py.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass

from ..types import VideoStreamFormat
from .settings import Encoder


class EncoderDeint(enum.Enum):
    NONE = "none"
    D30P = "30p"
    D24P = "24p"
    D60P = "60p"
    VFR = "vfr"


@dataclass
class EncoderOptionInfo:
    format: VideoStreamFormat = VideoStreamFormat.H264
    deint: EncoderDeint = EncoderDeint.NONE
    afs_timecode: bool = False
    select_every: int = 0


def split_options(s: str) -> list[str]:
    """Split a command-line-ish string, honouring double quotes
    (ref SplitOptions :32-48)."""
    out = []
    for m in re.finditer(r'(?:([^" ]+)|"([^"]+)") *', s):
        out.append(m.group(1) if m.group(1) is not None else m.group(2))
    return out


def parse_encoder_option(encoder: Encoder, options: str) -> EncoderOptionInfo:
    info = EncoderOptionInfo()
    if encoder == Encoder.X264:
        info.format = VideoStreamFormat.H264
        return info
    if encoder == Encoder.X265:
        info.format = VideoStreamFormat.H265
        return info

    argv = split_options(options)
    info.format = VideoStreamFormat.H264
    for i, arg in enumerate(argv):
        nxt = argv[i + 1] if i + 1 < len(argv) else ""
        if arg == "--vpp-deinterlace":
            if nxt in ("normal", "adaptive"):
                info.deint = EncoderDeint.D30P
            elif nxt == "it":
                info.deint = EncoderDeint.D24P
            elif nxt == "bob":
                info.deint = EncoderDeint.D60P
        elif arg == "--vpp-afs":
            is24 = timecode = drop = False
            for m in re.finditer(r"([^=,]+)=([^,]+),?", nxt):
                key, val = m.group(1), m.group(2).lower()
                if key == "24fps":
                    is24 = val in ("1", "true")
                elif key == "drop":
                    drop = val in ("1", "true")
                elif key == "timecode":
                    timecode = val in ("1", "true")
                elif key == "preset":
                    is24 = val == "24fps"
                    drop = val in ("double", "anime", "cinema",
                                   "min_afterimg", "24fps")
            if is24 and not drop:
                raise ValueError(
                    "vpp-afs: 24fps requires drop=on"
                )
            if drop and not timecode:
                raise ValueError(
                    "vpp-afs: drop=on requires timecode=true"
                )
            if timecode:
                info.deint = EncoderDeint.VFR
                info.afs_timecode = True
            else:
                info.deint = EncoderDeint.D24P if is24 else EncoderDeint.D30P
        elif arg == "--vpp-select-every":
            for m in re.finditer(r"([^=,]+)(=([^,]+))?,?", nxt):
                key, val = m.group(1), m.group(3)
                if val:
                    if key == "step":
                        info.select_every = int(val)
                else:
                    info.select_every = int(key)
        elif arg in ("-c", "--codec"):
            info.format = {
                "h264": VideoStreamFormat.H264,
                "hevc": VideoStreamFormat.H265,
                "mpeg2": VideoStreamFormat.MPEG2,
            }.get(nxt, VideoStreamFormat.UNKNOWN)
    return info
