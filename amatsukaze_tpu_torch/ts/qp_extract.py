"""Per-frame macroblock QP maps for the deblock post filter.

Counterpart of the container part of amatsukaze_tpu/ts/qp_extract.py
(`QpMapSource`): display-order [mb_h, mb_w] QP maps of one video file,
restricted to the output file's frame selection and sliced per filter
batch. Parsing them out of the MPEG-2 / H.264 elementary stream (the
native extractor, `from_file`, the decoder bridge) is not ported: here a
source is built from maps the caller has.
"""

from __future__ import annotations

import numpy as np


class QpMapSource:
    """Display-order per-frame QP maps: `maps` is a sequence of
    [mb_h, mb_w] arrays (uint8 quantiser scales)."""

    def __init__(self, maps=()):
        self.results = [np.asarray(m) for m in maps]

    def __len__(self) -> int:
        return len(self.results)

    def select(self, indices) -> "QpMapSource":
        """Restrict to the given display-order frame indices (the output
        file's frame selection), clamping past the end."""
        n = len(self.results)
        return QpMapSource([self.results[min(i, n - 1)] for i in indices]
                           if n else [])

    def maps(self, start: int, count: int) -> np.ndarray | None:
        """[count, mb_h, mb_w] float32 maps of frames [start,
        start + count), the edge frames repeated out of range."""
        return self.maps_for(range(start, start + count))

    def maps_for(self, indices) -> np.ndarray | None:
        """[len(indices), mb_h, mb_w] float32 maps, indices clamped into
        the source. A map whose shape differs from the first selected one
        is replaced by a flat map of its median (8 where that is 0)."""
        if not self.results:
            return None
        n = len(self.results)
        sel = [self.results[min(max(i, 0), n - 1)] for i in indices]
        if not sel:
            return None
        shape = sel[0].shape
        if any(q.shape != shape for q in sel):
            sel = [q if q.shape == shape else
                   np.full(shape, int(np.median(q)) or 8, np.uint8)
                   for q in sel]
        return np.stack(sel).astype(np.float32)
