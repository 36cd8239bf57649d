"""RIFF/WAV streaming writer (ref Amatsukaze/WaveWriter.h + AudioEncoder.hpp:36-106).

The reference streams reform-selected audio frames as a WAV into the audio
encoder's stdin; for pipes the data length is unknown upfront, so the header
carries the maximum size (the same trick the reference uses).

The port's copy of amatsukaze_tpu/io/wave.py.
"""

from __future__ import annotations

import struct


def wave_header(num_channels: int, sample_rate: int, bits: int = 16,
                data_size: int | None = None) -> bytes:
    block_align = num_channels * bits // 8
    byte_rate = sample_rate * block_align
    if data_size is None:
        data_size = 0x7FFFFFFF - 44  # unknown: stream to a pipe
    return b"".join([
        b"RIFF",
        struct.pack("<I", data_size + 36),
        b"WAVE",
        b"fmt ",
        struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate, byte_rate,
                    block_align, bits),
        b"data",
        struct.pack("<I", data_size),
    ])


class WaveWriter:
    def __init__(self, out, num_channels: int, sample_rate: int, bits: int = 16,
                 data_size: int | None = None):
        self.out = out
        self.out.write(wave_header(num_channels, sample_rate, bits, data_size))
        self.bytes_written = 0

    def write(self, pcm: bytes) -> None:
        self.out.write(pcm)
        self.bytes_written += len(pcm)


def parse_wave_header(data: bytes):
    """Returns (num_channels, sample_rate, bits, data_offset, data_size)."""
    if data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        if cid == b"fmt ":
            _, ch, sr, _, _, bits = struct.unpack(
                "<HHIIHH", data[pos + 8 : pos + 24]
            )
            fmt = (ch, sr, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt")
            return fmt[0], fmt[1], fmt[2], pos + 8, size
        pos += 8 + size + (size & 1)
    raise ValueError("no data chunk")
