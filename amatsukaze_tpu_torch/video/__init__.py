"""In-build MPEG-2 video decoder.

The reference decodes video through FFmpeg (reference
Amatsukaze/ReaderWriterFFmpeg.hpp, AMTSource.hpp:97-152); this package is
the standalone equivalent: a spec-complete ISO/IEC 13818-2 main-profile
decoder so the pipeline produces real pixels with no external decoder
binary. Two implementations share one defined arithmetic (bit-identical):

- :mod:`.mpeg2_ref` — pure-Python/numpy oracle (tests, fallback)
- :mod:`.native` — ctypes binding to the C++ engine (production path)

The port's copy of amatsukaze_tpu/video/__init__.py.
"""

from .mpeg2_ref import (  # noqa: F401
    DecodedFrame,
    Mpeg2Error,
    Mpeg2RefDecoder,
    decode_es,
    idct8x8,
)
