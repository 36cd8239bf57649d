"""YUV4MPEG2 (y4m) reader/writer.

Parity: Y4MWriter / Y4MParser in the reference (Amatsukaze/Encoder.hpp:14-92,
ReaderWriterFFmpeg.hpp:683+). y4m is the frame hand-off format to the
external encoders' stdin.

The port's copy of amatsukaze_tpu/io/y4m.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Y4MFormat:
    width: int = 0
    height: int = 0
    fps_num: int = 30000
    fps_den: int = 1001
    interlaced: bool = False
    tff: bool = True
    sar_num: int = 0
    sar_den: int = 1
    colorspace: str = "420mpeg2"  # C tag

    @property
    def bits(self) -> int:
        if self.colorspace.endswith("p10"):
            return 10
        if self.colorspace.endswith("p12"):
            return 12
        if self.colorspace.endswith("p14"):
            return 14
        if self.colorspace.endswith("p16"):
            return 16
        return 8

    def frame_size_bytes(self) -> int:
        if self.colorspace.startswith("444"):
            pixels = self.width * self.height * 3
        elif self.colorspace.startswith("422"):
            pixels = self.width * self.height * 2
        else:  # 4:2:0
            pixels = self.width * self.height * 3 // 2
        return pixels * (2 if self.bits > 8 else 1)


def format_header(fmt: Y4MFormat) -> bytes:
    interlace = "Ib" if (fmt.interlaced and not fmt.tff) else (
        "It" if fmt.interlaced else "Ip"
    )
    parts = [
        "YUV4MPEG2",
        f"W{fmt.width}",
        f"H{fmt.height}",
        f"F{fmt.fps_num}:{fmt.fps_den}",
        interlace,
        f"A{fmt.sar_num}:{fmt.sar_den}",
        f"C{fmt.colorspace}",
    ]
    return (" ".join(parts) + "\n").encode("ascii")


FRAME_HEADER = b"FRAME\n"


class Y4MWriter:
    """Stream frames into a writable binary file object (encoder stdin)."""

    def __init__(self, out, fmt: Y4MFormat):
        self.out = out
        self.fmt = fmt
        self._wrote_header = False

    def write_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        if not self._wrote_header:
            self.out.write(format_header(self.fmt))
            self._wrote_header = True
        self.out.write(FRAME_HEADER)
        for plane in (y, u, v):
            self.out.write(np.ascontiguousarray(plane).tobytes())

    def flush(self) -> None:
        self.out.flush()


class Y4MReader:
    """Parse a y4m stream (used for tests + fake-encoder verification)."""

    def __init__(self, inp):
        self.inp = inp
        self.fmt = self._parse_header()

    def _parse_header(self) -> Y4MFormat:
        line = self.inp.readline().decode("ascii").strip()
        if not line.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m stream")
        fmt = Y4MFormat()
        for tok in line.split()[1:]:
            tag, val = tok[0], tok[1:]
            if tag == "W":
                fmt.width = int(val)
            elif tag == "H":
                fmt.height = int(val)
            elif tag == "F":
                n, d = val.split(":")
                fmt.fps_num, fmt.fps_den = int(n), int(d)
            elif tag == "I":
                fmt.interlaced = val in ("t", "b")
                fmt.tff = val != "b"
            elif tag == "A":
                n, d = val.split(":")
                fmt.sar_num, fmt.sar_den = int(n), int(d)
            elif tag == "C":
                fmt.colorspace = val
        return fmt

    def read_frame(self):
        """Returns (y, u, v) uint8/uint16 arrays or None at EOF."""
        line = self.inp.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"bad frame header: {line!r}")
        w, h = self.fmt.width, self.fmt.height
        dt = np.uint16 if self.fmt.bits > 8 else np.uint8
        if self.fmt.colorspace.startswith("444"):
            cw, ch = w, h
        elif self.fmt.colorspace.startswith("422"):
            cw, ch = w // 2, h
        else:
            cw, ch = w // 2, h // 2

        def rd(n):
            data = self.inp.read(n * dt().itemsize)
            if len(data) < n * dt().itemsize:
                raise EOFError("truncated y4m frame")
            return np.frombuffer(data, dt)

        y = rd(w * h).reshape(h, w)
        u = rd(cw * ch).reshape(ch, cw)
        v = rd(cw * ch).reshape(ch, cw)
        return y, u, v

    def frames(self):
        while True:
            f = self.read_frame()
            if f is None:
                return
            yield f
