"""ctypes binding for the optional FFmpeg bridge (native/avdec.cpp,
libamatsukaze_av.so) — in-process demux + decode of any libavcodec
codec (H.264/HEVC/MPEG-1/2) straight to YUV planes, plus a raw AAC
ADTS decoder used by the audio differential tests.

This is the native analog of the reference's ReaderWriterFFmpeg
(reference Amatsukaze/ReaderWriterFFmpeg.hpp:73-483). The library only
exists where the system FFmpeg development packages do; every consumer
treats it as optional (`avdec_available()`), with the in-build MPEG
decoder and cv2 as fallbacks.

The port's copy of amatsukaze_tpu/video/avdec.py.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ts.native import build_native

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_NAME = "libamatsukaze_av.so"

_lock = threading.Lock()
_lib = None
_load_attempted = False


def _load():
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        build_native(_LIB_NAME, 300)
        path = os.path.join(_NATIVE_DIR, _LIB_NAME)
        if not os.path.exists(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.AvDec_Open.restype = ctypes.c_void_p
        lib.AvDec_Open.argtypes = [ctypes.c_char_p]
        if hasattr(lib, "AvDec_Open10"):
            lib.AvDec_Open10.restype = ctypes.c_void_p
            lib.AvDec_Open10.argtypes = [ctypes.c_char_p]
        lib.AvDec_Info.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.AvDec_NextFrame.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.AvDec_NextFrame.restype = ctypes.c_int
        lib.AvDec_Close.argtypes = [ctypes.c_void_p]
        lib.AvAac_Open.restype = ctypes.c_void_p
        lib.AvAac_Decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.AvAac_Decode.restype = ctypes.c_int
        lib.AvAac_Close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def avdec_available() -> bool:
    return _load() is not None


class AvVideoDecoder:
    """Decode any container/codec FFmpeg knows to (Y, U, V) planes."""

    def __init__(self, path: str, keep_depth: bool = False):
        """With keep_depth, 10-bit sources (HEVC Main10) yield uint16
        planes instead of being converted down to 8-bit."""
        lib = _load()
        if lib is None:
            raise RuntimeError("FFmpeg bridge unavailable")
        self._lib = lib
        if keep_depth and hasattr(lib, "AvDec_Open10"):
            self._h = lib.AvDec_Open10(path.encode())
        else:
            self._h = lib.AvDec_Open(path.encode())
        if not self._h:
            raise RuntimeError(f"cannot open {path}")
        info = (ctypes.c_int * 12)()
        lib.AvDec_Info(self._h, info)
        self.width = info[0]
        self.height = info[1]
        self.fps_num = info[2]
        self.fps_den = info[3]
        self.interlaced = bool(info[4])
        self.codec_id = info[5]
        self.chroma_class = info[6]  # 1 = 4:2:0, 2 = 4:2:2
        self.sar = (info[7], info[8])
        self.bit_depth = info[9] or 8

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.AvDec_Close(h)
            self._h = None

    def frames(self):
        """Yield (y, u, v[, finfo]) planes in display order (uint8, or
        uint16 for 10-bit sources opened with keep_depth)."""
        w, h = self.width, self.height
        ch = h if self.chroma_class == 2 else h // 2
        cw = w // 2
        dt = np.uint16 if self.bit_depth > 8 else np.uint8
        finfo = (ctypes.c_int * 4)()
        while True:
            y = np.empty((h, w), dt)
            u = np.empty((ch, cw), dt)
            v = np.empty((ch, cw), dt)
            r = self._lib.AvDec_NextFrame(
                self._h, y.ctypes.data_as(ctypes.c_void_p),
                u.ctypes.data_as(ctypes.c_void_p),
                v.ctypes.data_as(ctypes.c_void_p), finfo)
            if r <= 0:
                return
            yield y, u, v


def decode_file_av(path: str):
    """(Y, U, V) frame iterator via the FFmpeg bridge. 10-bit sources
    (HEVC Main10) yield uint16 planes at native depth; the pipeline
    decides whether to pass the depth through to the encoder or
    downconvert for the 8-bit filter graph."""
    dec = AvVideoDecoder(path, keep_depth=True)
    yield from dec.frames()


class AvAacDecoder:
    """FFmpeg's AAC decoder over raw ADTS frames (float PCM out)."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("FFmpeg bridge unavailable")
        self._lib = lib
        self._h = lib.AvAac_Open()
        if not self._h:
            raise RuntimeError("no AAC decoder in libavcodec")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.AvAac_Close(h)
            self._h = None

    def decode(self, adts_frame: bytes):
        """-> (interleaved float32 [n, channels], sample_rate) or None
        while the decoder is still buffering."""
        buf = (ctypes.c_float * 16384)()
        info = (ctypes.c_int * 4)()
        n = self._lib.AvAac_Decode(self._h, adts_frame, len(adts_frame),
                                   buf, 16384, info)
        if n < 0:
            raise RuntimeError(f"AAC decode failed ({n})")
        if n == 0:
            return None
        chans, rate = info[0], info[1]
        pcm = np.ctypeslib.as_array(buf)[:n].copy().reshape(-1, chans)
        return pcm, rate


class AvVideoEncoder:
    """A libavcodec video encoder (libx264 / libx265 / libsvtav1) via
    the bridge: (Y, U, V) 4:2:0 planes in, raw bitstream out. Backs
    test-stream generation and the in-build encoder fallback."""

    def __init__(self, width: int, height: int, fps_num: int = 30000,
                 fps_den: int = 1001, crf: int = 20,
                 preset: str = "veryfast", interlaced: bool = False,
                 bframes: int = 2, x264_params: str = "",
                 codec: str = "libx264", bit_depth: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("FFmpeg bridge unavailable")
        if not hasattr(lib, "AvEnc_Open2"):
            raise RuntimeError("bridge lacks encode support")
        lib.AvEnc_Open2.restype = ctypes.c_void_p
        lib.AvEnc_Open2.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5 + [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
        lib.AvEnc_Encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.AvEnc_Encode.restype = ctypes.c_int
        lib.AvEnc_Close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        if bit_depth > 8:
            if not hasattr(lib, "AvEnc_Open3"):
                raise RuntimeError("bridge lacks 10-bit encode support")
            lib.AvEnc_Open3.restype = ctypes.c_void_p
            lib.AvEnc_Open3.argtypes = (
                [ctypes.c_char_p] + [ctypes.c_int] * 5
                + [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_char_p, ctypes.c_int])
            self._h = lib.AvEnc_Open3(codec.encode(), width, height,
                                      fps_num, fps_den,
                                      crf, preset.encode(),
                                      1 if interlaced else 0, bframes,
                                      x264_params.encode(), bit_depth)
        else:
            self._h = lib.AvEnc_Open2(codec.encode(), width, height,
                                      fps_num, fps_den,
                                      crf, preset.encode(),
                                      1 if interlaced else 0, bframes,
                                      x264_params.encode())
        if not self._h:
            raise RuntimeError(f"{codec} encoder unavailable")
        self.width, self.height = width, height
        self.bit_depth = bit_depth
        self._dtype = np.uint16 if bit_depth > 8 else np.uint8
        self._buf = np.empty(width * height * 8 + (1 << 16), np.uint8)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.AvEnc_Close(h)
            self._h = None

    def _collect(self, y, u, v) -> list[bytes]:
        sizes = (ctypes.c_int * 64)()
        npk = ctypes.c_int(0)
        n = self._lib.AvEnc_Encode(
            self._h,
            None if y is None else y.ctypes.data_as(ctypes.c_void_p),
            None if y is None else u.ctypes.data_as(ctypes.c_void_p),
            None if y is None else v.ctypes.data_as(ctypes.c_void_p),
            self._buf.ctypes.data_as(ctypes.c_void_p), self._buf.size,
            sizes, 64, ctypes.byref(npk))
        if n < 0:
            raise RuntimeError(f"encode failed ({n})")
        out, off = [], 0
        for k in range(npk.value):
            out.append(bytes(self._buf[off:off + sizes[k]]))
            off += sizes[k]
        return out

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
               ) -> list[bytes]:
        """-> list of complete access units (coded order; may be empty
        while the encoder buffers)."""
        y = np.ascontiguousarray(y, self._dtype)
        u = np.ascontiguousarray(u, self._dtype)
        v = np.ascontiguousarray(v, self._dtype)
        return self._collect(y, u, v)

    def flush(self) -> list[bytes]:
        out = []
        while True:
            chunk = self._collect(None, None, None)
            if not chunk:
                return out
            out.extend(chunk)


class AvAacEncoder:
    """libavcodec's AAC-LC encoder: interleaved s16 PCM in, raw AAC
    frames out (caller adds ADTS headers)."""

    _SFI = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
            24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}

    def __init__(self, sample_rate: int, channels: int,
                 bitrate: int = 192000):
        lib = _load()
        if lib is None or not hasattr(lib, "AvAacEnc_Open"):
            raise RuntimeError("FFmpeg bridge unavailable")
        lib.AvAacEnc_Open.restype = ctypes.c_void_p
        lib.AvAacEnc_Open.argtypes = [ctypes.c_int] * 3
        lib.AvAacEnc_FrameSize.argtypes = [ctypes.c_void_p]
        lib.AvAacEnc_FrameSize.restype = ctypes.c_int
        lib.AvAacEnc_Encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.AvAacEnc_Encode.restype = ctypes.c_int
        lib.AvAacEnc_Close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.AvAacEnc_Open(sample_rate, channels, bitrate)
        if not self._h:
            raise RuntimeError("no AAC encoder in libavcodec")
        self.sample_rate = sample_rate
        self.channels = channels
        self.frame_size = lib.AvAacEnc_FrameSize(self._h)
        self._buf = np.empty(1 << 16, np.uint8)
        self._pend = np.empty((0, channels), np.int16)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.AvAacEnc_Close(h)
            self._h = None

    def _adts(self, raw: bytes) -> bytes:
        ln = len(raw) + 7
        sfi = self._SFI[self.sample_rate]
        hdr = bytearray(7)
        hdr[0] = 0xFF
        hdr[1] = 0xF1  # MPEG-4, no CRC
        hdr[2] = (1 << 6) | (sfi << 2) | (self.channels >> 2)
        hdr[3] = ((self.channels & 3) << 6) | ((ln >> 11) & 3)
        hdr[4] = (ln >> 3) & 0xFF
        hdr[5] = ((ln & 7) << 5) | 0x1F
        hdr[6] = 0xFC
        return bytes(hdr) + raw

    def _emit(self, pcm, n) -> bytes:
        sizes = (ctypes.c_int * 16)()
        npk = ctypes.c_int(0)
        total = self._lib.AvAacEnc_Encode(
            self._h,
            None if pcm is None else pcm.ctypes.data_as(ctypes.c_void_p),
            n, self._buf.ctypes.data_as(ctypes.c_void_p), self._buf.size,
            sizes, 16, ctypes.byref(npk))
        if total < 0:
            raise RuntimeError(f"AAC encode failed ({total})")
        out, off = b"", 0
        for k in range(npk.value):
            out += self._adts(bytes(self._buf[off:off + sizes[k]]))
            off += sizes[k]
        return out

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: [n, channels] int16; returns ADTS bytes (buffered)."""
        self._pend = np.concatenate(
            [self._pend, pcm.reshape(-1, self.channels)])
        out = b""
        while len(self._pend) >= self.frame_size:
            chunk = np.ascontiguousarray(self._pend[:self.frame_size])
            self._pend = self._pend[self.frame_size:]
            out += self._emit(chunk, self.frame_size)
        return out

    def flush(self) -> bytes:
        out = b""
        if len(self._pend):
            pad = np.zeros((self.frame_size - len(self._pend),
                            self.channels), np.int16)
            chunk = np.ascontiguousarray(
                np.concatenate([self._pend, pad]))
            self._pend = self._pend[:0]
            out += self._emit(chunk, self.frame_size)
        while True:
            chunk = self._emit(None, 0)
            if not chunk:
                return out
            out += chunk


def remux_files(video_path: str, audio_paths: list[str], out_path: str,
                fps_num: int, fps_den: int,
                timecodes_ms: list[float] | None = None) -> None:
    """Remux a raw H.264/HEVC stream + ADTS audio tracks into a real
    container (mp4/mkv chosen by out_path extension) via libavformat.
    VFR timestamps come from timecodes_ms (timecode-v2 values)."""
    lib = _load()
    if lib is None or not hasattr(lib, "AvMux_Remux"):
        raise RuntimeError("FFmpeg bridge unavailable")
    lib.AvMux_Remux.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.AvMux_Remux.restype = ctypes.c_int
    aud = (ctypes.c_char_p * max(1, len(audio_paths)))(
        *[p.encode() for p in audio_paths])
    if timecodes_ms:
        tc = (ctypes.c_double * len(timecodes_ms))(*timecodes_ms)
        ntc = len(timecodes_ms)
    else:
        tc, ntc = None, 0
    r = lib.AvMux_Remux(video_path.encode(), aud, len(audio_paths),
                        out_path.encode(), fps_num, fps_den, tc, ntc)
    if r != 0:
        raise RuntimeError(f"remux failed ({r})")


# Backwards-compatible name (H.264 remains the default codec)
AvH264Encoder = AvVideoEncoder


def decode_with_qp(path: str):
    """Yield (y, u, v, qp_blocks) where qp_blocks is an int32 [N, 3]
    array of (x, y, qp) per coded block (FFmpeg's video-enc-params
    export; the modern form of the patched av_frame_get_qp_table the
    reference uses for KDeblock)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("FFmpeg bridge unavailable")
    lib.AvDec_LastQp.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int]
    lib.AvDec_LastQp.restype = ctypes.c_int
    dec = AvVideoDecoder(path)
    qp_buf = np.empty(3 * 36864, np.int32)
    for y, u, v in dec.frames():
        n = lib.AvDec_LastQp(dec._h,
                             qp_buf.ctypes.data_as(ctypes.c_void_p),
                             qp_buf.size)
        yield y, u, v, qp_buf[:3 * n].reshape(-1, 3).copy()
