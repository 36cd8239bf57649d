"""CRC32/MPEG-2 used by PSI sections.

Parity target: the table-driven CRC in the reference (Amatsukaze/StreamUtils.hpp:273-305).
Standard MPEG-2 CRC: poly 0x04C11DB7, init 0xFFFFFFFF, MSB-first, no final XOR.
A valid section including its trailing CRC field hashes to 0 (involution
property exercised by the reference's test_crc).

The port's copy of amatsukaze_tpu/utils/crc.py.
"""

from __future__ import annotations

import numpy as np


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if (c & 0x80000000) else (c << 1)
            c &= 0xFFFFFFFF
        table[i] = c
    return table.astype(np.uint32)


CRC32_TABLE = _make_table()
_TABLE_LIST = [int(x) for x in CRC32_TABLE]


def crc32_mpeg2(data: bytes | bytearray | memoryview, init: int = 0xFFFFFFFF) -> int:
    crc = init
    tbl = _TABLE_LIST
    for b in bytes(data):
        crc = ((crc << 8) & 0xFFFFFFFF) ^ tbl[((crc >> 24) ^ b) & 0xFF]
    return crc
