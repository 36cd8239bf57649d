"""ARIB caption decoding + subtitle formatting.

Replaces the reference's vendored TVCaptionMod2 Caption.dll + AribString.hpp
with an in-build ARIB STD-B24 decoder, and CaptionFormatter.hpp's ASS/SRT
generators.

The port's copy of amatsukaze_tpu/captions/__init__.py.
"""

from .arib import AribDecoder, decode_arib_string
from .b24 import CaptionDecoder, CaptionItem, CaptionLine, CaptionFormat, DRCSOutInfo

__all__ = [
    "AribDecoder",
    "decode_arib_string",
    "CaptionDecoder",
    "CaptionItem",
    "CaptionLine",
    "CaptionFormat",
    "DRCSOutInfo",
]
