"""Per-frame logo erasure over decoded YUV batches.

Counterpart of amatsukaze_tpu/models/logo_erase.py (parity: AMTEraseLogo,
Amatsukaze/LogoScan.hpp:1248-1397): subtract each logo with its per-frame
fade (`dst = fade*(A*src + B*maxv) + (1-fade)*src`) on all three planes.
The erase runs in plain PyTorch ops on the device, as the JAX package runs
it in XLA; frames cross to the device as uint8 and widen there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.logo_eval import delogo_full_frame, pad_logo_planes
from ..utils.batching import pad_tail
from ..utils.device import resolve_device, to_device, to_host
from .filter_graph import normalize_u8


class LogoEraser:
    """entries: list of (LogoData, fades) where fades is a per-frame [N]
    float array or None (= erase at fade 1.0 everywhere)."""

    def __init__(self, ctx, entries, width: int, height: int, device=None):
        self.ctx = ctx
        self.width = width
        self.height = height
        self.device = resolve_device(device)
        self.planes = []  # per logo: (y, u, v) of (a_full, b_full)
        self.fades = []
        for logo, fades in entries:
            h = logo.header
            if h.imgw != width or h.imgh != height:
                ctx.warn("logo %s is for %dx%d, not %dx%d — skipped",
                         h.name, h.imgw, h.imgh, width, height)
                continue
            sx, sy = h.log_uv_x, h.log_uv_y
            geoms = (
                (logo.a_y, logo.b_y, height, width, h.imgx, h.imgy),
                (logo.a_u, logo.b_u, height >> sy, width >> sx,
                 h.imgx >> sx, h.imgy >> sy),
                (logo.a_v, logo.b_v, height >> sy, width >> sx,
                 h.imgx >> sx, h.imgy >> sy),
            )
            self.planes.append(tuple(
                tuple(to_device(p, self.device, ctx.trace)
                      for p in pad_logo_planes(*g))
                for g in geoms))
            self.fades.append(None if fades is None
                              else np.asarray(fades, np.float32))

    def __bool__(self) -> bool:
        return bool(self.planes)

    def erase_batch(self, ys, us, vs, start: int):
        """Erase all logos from a batch of frames. ys/us/vs: [B, h, w]
        uint8 numpy arrays; `start` is the batch's first filter-frame index
        (selects the fade slice). Returns uint8 numpy arrays."""
        b = len(ys)
        trace = self.ctx.trace
        planes = [to_device(np.ascontiguousarray(p), self.device, trace)
                  .float() for p in (ys, us, vs)]
        for logo_planes, fades in zip(self.planes, self.fades):
            if fades is None:
                fd = np.ones(b, np.float32)
            elif len(fades):
                fd = fades[np.clip(np.arange(start, start + b), 0,
                                   len(fades) - 1)]
            else:
                fd = np.zeros(b, np.float32)
            fd = to_device(fd, self.device, trace)
            planes = [delogo_full_frame(x, a, bb, 255.0, fd)
                      for x, (a, bb) in zip(planes, logo_planes)]
        # the erase output is integer-valued: cast on device, fetch uint8
        return tuple(to_host(p.to(torch.uint8), trace) for p in planes)

    def erase_iter(self, frames_iter, batch: int = 32):
        """Wrap a (Y, U, V) frame iterator with batched erasure. Tail
        batches are padded to the steady shape (repeat-last); padded
        outputs are dropped."""
        buf = []
        start = 0

        def flush():
            nonlocal start
            if not buf:
                return []
            n = len(buf)
            ys, us, vs = zip(*buf)
            ey, eu, ev = self.erase_batch(pad_tail(list(ys), batch)[0],
                                          pad_tail(list(us), batch)[0],
                                          pad_tail(list(vs), batch)[0], start)
            start += n
            out = list(zip(ey[:n], eu[:n], ev[:n]))
            buf.clear()
            return out

        for planes in frames_iter:
            # logo parameters are 8-bit domain: normalise 10-bit/float
            # decoder output the same way the analysis feeds do
            buf.append(tuple(normalize_u8(p) for p in planes))
            if len(buf) >= batch:
                yield from flush()
        yield from flush()
