"""Byte-range file cut (parity: FileCutter/FileCutter.cpp:23-74).

The port's copy of amatsukaze_tpu/tools/file_cutter.py.
"""

from __future__ import annotations

_CHUNK = 4 * 1024 * 1024


def cut_file(src: str, dst: str, start: int, end: int | None = None) -> int:
    """Copy bytes [start, end) of src into dst; end=None = to EOF.
    Returns bytes written."""
    if start < 0:
        raise ValueError("start must be >= 0")
    written = 0
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        fi.seek(start)
        remaining = None if end is None else max(0, end - start)
        while remaining is None or remaining > 0:
            n = _CHUNK if remaining is None else min(_CHUNK, remaining)
            buf = fi.read(n)
            if not buf:
                break
            fo.write(buf)
            written += len(buf)
            if remaining is not None:
                remaining -= len(buf)
    return written
