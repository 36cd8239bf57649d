"""Run context, bit and CRC helpers, batching and device selection."""

from .bits import BitReader, BitWriter
from .context import AMTContext, AMTError, ErrorCounter
from .crc import CRC32_TABLE, crc32_mpeg2

__all__ = [
    "BitReader",
    "BitWriter",
    "crc32_mpeg2",
    "CRC32_TABLE",
    "AMTContext",
    "AMTError",
    "ErrorCounter",
]
