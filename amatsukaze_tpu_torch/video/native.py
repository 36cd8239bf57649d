"""ctypes binding for the native MPEG-2 video decoder
(native/mpeg2dec.cpp) — the production decode path; the pure-Python
oracle (:mod:`.mpeg2_ref`) is the always-available fallback and the
differential-test reference.

Usage mirrors the oracle's picture-chunk interface:

    dec = NativeMpeg2Decoder()          # raises if the library is absent
    frames = dec.decode_picture(chunk)  # list[DecodedFrame]
    frames += dec.flush()

The port's copy of amatsukaze_tpu/video/native.py.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from collections import deque

import numpy as np

from ..ts.native import load_native
from .mpeg2_ref import DecodedFrame

_sigs_done = False
# The binders set argtypes on the library's shared function objects, and
# the server's pipelines open decoders from several threads at once: one
# binder at a time, each flag set only once all of its signatures are.
_bind_lock = threading.Lock()


class _PlanePool:
    """Recycle decoded-plane numpy buffers across frames.

    A fresh ``np.empty`` per multi-MB plane costs a page-fault sweep of
    the whole buffer every frame (~1.8 ms for a 1080 luma plane even
    with the heap-threshold fix in ts.native.load_native — the glibc
    heap reuse only kicks in once earlier frames have been freed, which
    a pipelined consumer delays).  The pool keeps references to the last
    ``depth`` emitted planes; a plane is handed out again only when the
    pool holds the sole reference (refcount probe), i.e. every consumer
    has dropped it.  Steady-state decode then rewrites the same warm
    pages: the MPEG-2 wrapper goes ~225 -> ~390 fps at 1440x1080.
    """

    # Per-(shape, dtype) FIFO pairs: `out` holds planes in emission
    # order, `free` holds planes every consumer has released.  The
    # pipeline consumes frames in order, so releases surface at the
    # FRONT of `out` — take() promotes released fronts and reuses one,
    # O(1) amortized with no reordering (an earlier probe-capped scan
    # scrambled the deque and collapsed the hit rate).  DEPTH bounds
    # how many outstanding planes the pool tracks: past it, the oldest
    # is forgotten (its memory returns to the heap when the consumer
    # drops it — never reused, just not recycled).
    DEPTH = 256

    def __init__(self):
        self._pools: dict = {}

    def take(self, shape, dtype) -> np.ndarray:
        key = (shape, np.dtype(dtype).str)
        pair = self._pools.get(key)
        if pair is None:
            pair = self._pools[key] = (deque(), deque())
        out, free = pair
        # 2 = the deque slot + getrefcount's argument: nothing outside
        # the pool references the buffer (views keep their base alive,
        # so sliced frames never recycle under a consumer)
        while out and sys.getrefcount(out[0]) == 2:
            free.append(out.popleft())
        if not free:
            # a long-held head (carry frames survive a whole batch)
            # must not block the planes behind it: peek a few slots in
            for i in range(1, min(len(out), 5)):
                if sys.getrefcount(out[i]) == 2:
                    free.append(out[i])
                    del out[i]
                    break
        arr = free.popleft() if free else np.empty(shape, dtype)
        if len(out) < self.DEPTH:
            out.append(arr)
        return arr


def _bind(lib) -> None:
    global _sigs_done
    if _sigs_done:
        return
    with _bind_lock:
        if _sigs_done:
            return
        lib.M2V_Create.restype = ctypes.c_void_p
        lib.M2V_Destroy.argtypes = [ctypes.c_void_p]
        lib.M2V_DecodePicture.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_longlong]
        lib.M2V_DecodePicture.restype = ctypes.c_int
        lib.M2V_Flush.argtypes = [ctypes.c_void_p]
        lib.M2V_Flush.restype = ctypes.c_int
        lib.M2V_NextInfo.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.M2V_NextInfo.restype = ctypes.c_int
        lib.M2V_PopFrame.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]
        lib.M2V_PopFrame.restype = ctypes.c_int
        lib.M2V_Errors.argtypes = [ctypes.c_void_p]
        lib.M2V_Errors.restype = ctypes.c_longlong
        if hasattr(lib, "M2V_BorrowFrame"):
            lib.M2V_BorrowFrame.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
            lib.M2V_BorrowFrame.restype = ctypes.c_int
            lib.M2V_ReleaseBorrow.argtypes = [ctypes.c_void_p,
                                              ctypes.c_longlong]
        _sigs_done = True


def native_available() -> bool:
    lib = load_native()
    return lib is not None and hasattr(lib, "M2V_Create")


class _M2VBorrow:
    """numpy base object for a zero-copy decoded plane: releasing the
    last array view returns the FrameBuf to the decoder's pool.  Holds
    the decoder wrapper so the C handle outlives every borrowed view."""

    __slots__ = ("_dec", "_id")

    def __init__(self, dec, borrow_id):
        self._dec = dec
        self._id = borrow_id

    def __del__(self):
        h = getattr(self._dec, "_h", None)
        if h:
            self._dec._lib.M2V_ReleaseBorrow(h, self._id)


class _M2VPlane:
    """__array_interface__ shim: a strided read-only uint8 window over a
    borrowed decode plane (padded stride, display crop)."""

    __slots__ = ("base", "__array_interface__")

    def __init__(self, base, addr, h, w, stride):
        self.base = base
        self.__array_interface__ = {
            "shape": (h, w), "typestr": "|u1",
            "data": (addr, True), "strides": (stride, 1), "version": 3}


class NativeMpeg2Decoder:
    """Streaming MPEG-2 picture decoder backed by the C++ engine."""

    def __init__(self):
        lib = load_native()
        if lib is None or not hasattr(lib, "M2V_Create"):
            raise RuntimeError("native MPEG-2 decoder unavailable")
        _bind(lib)
        self._lib = lib
        self._h = lib.M2V_Create()
        self._pool = _PlanePool()
        self._borrow = hasattr(lib, "M2V_BorrowFrame")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.M2V_Destroy(h)
            self._h = None

    @property
    def errors(self) -> int:
        return int(self._lib.M2V_Errors(self._h))

    def _drain(self) -> list[DecodedFrame]:
        out = []
        info = (ctypes.c_int * 10)()
        while self._lib.M2V_NextInfo(self._h, info):
            w, h = info[0], info[1]
            ch, cw = info[8], info[9]  # 4:2:2 keeps full chroma height
            if self._borrow:
                # zero-copy emit: views straight over the padded decode
                # planes (~15% of 1080i decode was the copy-out memcpy)
                bid = ctypes.c_longlong()
                planes = (ctypes.c_void_p * 3)()
                strides = (ctypes.c_int * 3)()
                if not self._lib.M2V_BorrowFrame(self._h, bid, planes,
                                                 strides):
                    break
                base = _M2VBorrow(self, bid.value)
                y = np.asarray(_M2VPlane(base, planes[0], h, w,
                                         strides[0]))
                u = np.asarray(_M2VPlane(base, planes[1], ch, cw,
                                         strides[1]))
                v = np.asarray(_M2VPlane(base, planes[2], ch, cw,
                                         strides[2]))
                out.append(DecodedFrame(
                    y=y, u=u, v=v,
                    coding_type=info[2],
                    temporal_reference=info[3],
                    progressive_frame=bool(info[4]),
                    top_field_first=bool(info[5]),
                    repeat_first_field=bool(info[6]),
                ))
                continue
            y = self._pool.take((h, w), np.uint8)
            u = self._pool.take((ch, cw), np.uint8)
            v = self._pool.take((ch, cw), np.uint8)
            ok = self._lib.M2V_PopFrame(
                self._h, y.ctypes.data_as(ctypes.c_void_p),
                u.ctypes.data_as(ctypes.c_void_p),
                v.ctypes.data_as(ctypes.c_void_p))
            if not ok:
                break
            out.append(DecodedFrame(
                y=y, u=u, v=v,
                coding_type=info[2],
                temporal_reference=info[3],
                progressive_frame=bool(info[4]),
                top_field_first=bool(info[5]),
                repeat_first_field=bool(info[6]),
            ))
        return out

    def decode_picture(self, chunk: bytes) -> list[DecodedFrame]:
        b = bytes(chunk)
        self._lib.M2V_DecodePicture(self._h, b, len(b))
        return self._drain()

    def flush(self) -> list[DecodedFrame]:
        self._lib.M2V_Flush(self._h)
        return self._drain()


def decode_es_native(es: bytes) -> list[DecodedFrame]:
    """Decode a whole elementary stream with the native engine."""
    from ..ts.qp_extract import iter_picture_chunks

    dec = NativeMpeg2Decoder()
    out = []
    for chunk in iter_picture_chunks(es):
        out.extend(dec.decode_picture(chunk))
    out.extend(dec.flush())
    return out


# ---------------------------------------------------------------------------
# H.264: native C++ engine (native/h264dec.cpp), bit-exact twin of the
# pure-Python oracle (video/h264_ref.py H264RefDecoder).
# ---------------------------------------------------------------------------

_h264_sigs_done = False


def _bind_h264(lib) -> None:
    global _h264_sigs_done
    if _h264_sigs_done:
        return
    with _bind_lock:
        if _h264_sigs_done:
            return
        lib.H264_Create.restype = ctypes.c_void_p
        lib.H264_Destroy.argtypes = [ctypes.c_void_p]
        lib.H264_Decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_longlong]
        lib.H264_Decode.restype = ctypes.c_int
        lib.H264_Flush.argtypes = [ctypes.c_void_p]
        lib.H264_Flush.restype = ctypes.c_int
        lib.H264_NextInfo.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
        lib.H264_NextInfo.restype = ctypes.c_int
        lib.H264_PopFrame.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p]
        lib.H264_PopFrame.restype = ctypes.c_int
        lib.H264_Errors.argtypes = [ctypes.c_void_p]
        lib.H264_Errors.restype = ctypes.c_longlong
        _h264_sigs_done = True


def _annexb_segments(es: bytes, target: int = 1 << 20):
    """Yield `es` in ~target-byte pieces cut at NAL start-code boundaries
    (never mid-NAL; the engines take whole NALs per feed).  Draining
    decoded frames between feeds keeps the live-frame set bounded, so
    the engines' picture pools recycle instead of faulting fresh pages
    for every frame of a long buffer."""
    n = len(es)
    pos = 0
    while pos < n:
        end = pos + target
        if end >= n:
            yield es[pos:]
            return
        cut = es.find(b"\x00\x00\x01", end)
        if cut < 0:
            yield es[pos:]
            return
        if cut > 0 and es[cut - 1] == 0:  # 4-byte start code
            cut -= 1
        yield es[pos:cut]
        pos = cut


def h264_native_available() -> bool:
    lib = load_native()
    return lib is not None and hasattr(lib, "H264_Create")


class NativeH264Decoder:
    """Streaming Annex B H.264 decoder backed by the C++ engine.

    Same contract as the oracle (video/h264_ref.py H264RefDecoder):
    decode() takes whole NALs (cut the buffer at the last start code)
    and returns (Y, U, V, poc) frames in display order; flush() drains.
    """

    def __init__(self):
        lib = load_native()
        if lib is None or not hasattr(lib, "H264_Create"):
            raise RuntimeError("native H.264 decoder unavailable")
        _bind_h264(lib)
        self._lib = lib
        self._h = lib.H264_Create()
        self._pool = _PlanePool()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.H264_Destroy(h)
            self._h = None

    @property
    def errors(self) -> int:
        return int(self._lib.H264_Errors(self._h))

    def _drain(self) -> list[tuple]:
        out = []
        info = (ctypes.c_int * 4)()
        while self._lib.H264_NextInfo(self._h, info):
            w, h = info[0], info[1]
            y = self._pool.take((h, w), np.uint8)
            u = self._pool.take((h // 2, w // 2), np.uint8)
            v = self._pool.take((h // 2, w // 2), np.uint8)
            ok = self._lib.H264_PopFrame(
                self._h, y.ctypes.data_as(ctypes.c_void_p),
                u.ctypes.data_as(ctypes.c_void_p),
                v.ctypes.data_as(ctypes.c_void_p))
            if not ok:
                break
            out.append((y, u, v, info[2]))
        return out

    def decode(self, es: bytes) -> list[tuple]:
        out = []
        for seg in _annexb_segments(bytes(es)):
            self._lib.H264_Decode(self._h, seg, len(seg))
            out.extend(self._drain())
        return out

    def flush(self) -> list[tuple]:
        self._lib.H264_Flush(self._h)
        return self._drain()


# ---------------------------------------------------------------------------
# HEVC: native C++ engine (native/h265dec.cpp), bit-exact twin of the
# pure-Python oracle (video/h265_ref.py H265RefDecoder).
# ---------------------------------------------------------------------------

_h265_sigs_done = False


def _bind_h265(lib) -> None:
    global _h265_sigs_done
    if _h265_sigs_done:
        return
    with _bind_lock:
        if _h265_sigs_done:
            return
        lib.H265_Create.restype = ctypes.c_void_p
        lib.H265_Destroy.argtypes = [ctypes.c_void_p]
        lib.H265_Decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_longlong]
        lib.H265_Decode.restype = ctypes.c_int
        lib.H265_Flush.argtypes = [ctypes.c_void_p]
        lib.H265_Flush.restype = ctypes.c_int
        lib.H265_NextInfo.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
        lib.H265_NextInfo.restype = ctypes.c_int
        lib.H265_PopFrame.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p]
        lib.H265_PopFrame.restype = ctypes.c_int
        lib.H265_Errors.argtypes = [ctypes.c_void_p]
        lib.H265_Errors.restype = ctypes.c_longlong
        _h265_sigs_done = True


def h265_native_available() -> bool:
    lib = load_native()
    return lib is not None and hasattr(lib, "H265_Create")


class NativeH265Decoder:
    """Streaming Annex B HEVC decoder backed by the C++ engine.

    Same contract as the oracle (video/h265_ref.py H265RefDecoder):
    decode() takes whole NALs (cut the buffer at the last start code)
    and returns (Y, U, V) frames in display order (uint8 for 8-bit
    streams, uint16 for Main10); flush() drains.
    """

    def __init__(self):
        lib = load_native()
        if lib is None or not hasattr(lib, "H265_Create"):
            raise RuntimeError("native HEVC decoder unavailable")
        _bind_h265(lib)
        self._lib = lib
        self._h = lib.H265_Create()
        self._pool = _PlanePool()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.H265_Destroy(h)
            self._h = None

    @property
    def errors(self) -> int:
        return int(self._lib.H265_Errors(self._h))

    def _drain(self) -> list[tuple]:
        out = []
        info = (ctypes.c_int * 6)()
        while self._lib.H265_NextInfo(self._h, info):
            w, h, bd = info[0], info[1], info[4]
            dt = np.uint16 if bd > 8 else np.uint8
            y = self._pool.take((h, w), dt)
            u = self._pool.take((h // 2, w // 2), dt)
            v = self._pool.take((h // 2, w // 2), dt)
            ok = self._lib.H265_PopFrame(
                self._h, y.ctypes.data_as(ctypes.c_void_p),
                u.ctypes.data_as(ctypes.c_void_p),
                v.ctypes.data_as(ctypes.c_void_p))
            if not ok:
                break
            out.append((y, u, v, info[2]))
        return out

    def decode(self, es: bytes) -> list[tuple]:
        out = []
        for seg in _annexb_segments(bytes(es)):
            self._lib.H265_Decode(self._h, seg, len(seg))
            out.extend(self._drain())
        return out

    def flush(self) -> list[tuple]:
        self._lib.H265_Flush(self._h)
        return self._drain()
