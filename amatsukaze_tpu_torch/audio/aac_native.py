"""ctypes binding for the native AAC-LC decoder (native/aacdec.cpp).

The native decoder mirrors :class:`.aac.AacLcDecoder`
(the golden oracle) and replaces the reference's libfaad hot loop
(reference: Amatsukaze/AdtsParser.hpp:174-327). Use :func:`make_decoder`
to get the fastest available implementation; callers always have the
pure-Python decoder as fallback when no compiler is present.

The port's copy of amatsukaze_tpu/audio/aac_native.py.
"""

from __future__ import annotations

import ctypes
import threading

from ..ts.adts import AacDecodeResult, AacDecoder
from ..ts.native import load_native

MAX_CH = 24
MAX_ELEMS = 24

_lock = threading.Lock()
_lib = None
_load_attempted = False


def _load():
    """Attach the AAC prototypes to the shared native library
    (ts.native.load_native builds/loads libamatsukaze_native.so once)."""
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        lib = load_native()
        if lib is None:
            return None
        try:
            lib.AacDec_Create.restype = ctypes.c_void_p
            lib.AacDec_Destroy.argtypes = [ctypes.c_void_p]
            lib.AacDec_Reset.argtypes = [ctypes.c_void_p]
            lib.AacDec_Decode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.AacDec_Decode.restype = ctypes.c_int
            lib.AacDec_SbrDetected.argtypes = [ctypes.c_void_p]
            lib.AacDec_SbrDetected.restype = ctypes.c_int
            lib.AacDec_OutSamples.argtypes = [ctypes.c_void_p]
            lib.AacDec_OutSamples.restype = ctypes.c_int
            lib.AacDec_NeedsFallback.argtypes = [ctypes.c_void_p]
            lib.AacDec_NeedsFallback.restype = ctypes.c_int
        except AttributeError:  # stale .so without the AAC entry points
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeAacDecoder(AacDecoder):
    """AAC-LC decoder backed by the C++ engine; decode() mirrors
    AacLcDecoder.decode bit ranges / PCM (within float rounding)."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native AAC decoder unavailable")
        self._lib = lib
        self._h = lib.AacDec_Create()
        self._pcm = (ctypes.c_int16 * (2048 * MAX_CH))()  # 2048 under SBR
        self._sr = ctypes.c_int()
        self._etypes = (ctypes.c_int * MAX_ELEMS)()
        self._ebits = (ctypes.c_int64 * (2 * MAX_ELEMS))()
        self._ne = ctypes.c_int()
        self._sbr_fallback = None  # set on first HE-AAC (SBR) frame

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.AacDec_Destroy(self._h)
                self._h = None
        except (AttributeError, TypeError):
            pass

    def reset(self) -> None:
        if self._sbr_fallback is not None:
            from .aac import AacLcDecoder
            self._sbr_fallback = AacLcDecoder()
        self._lib.AacDec_Reset(self._h)

    def decode(self, frame: bytes) -> AacDecodeResult | None:
        frame = bytes(frame)
        if self._sbr_fallback is not None:
            return self._sbr_fallback.decode(frame)
        nch = self._lib.AacDec_Decode(
            self._h, frame, len(frame), self._pcm, ctypes.byref(self._sr),
            self._etypes, self._ebits, ctypes.byref(self._ne))
        if self._lib.AacDec_NeedsFallback(self._h):
            # escape hatch for future unsupported syntax; the native
            # engine currently decodes LC, SBR and parametric stereo
            # itself (aacsbr.inc / aacps.inc), so this never fires
            from .aac import AacLcDecoder
            self._sbr_fallback = AacLcDecoder()
            return self._sbr_fallback.decode(frame)
        if nch <= 0:
            return None
        ne = self._ne.value
        n_samples = self._lib.AacDec_OutSamples(self._h)
        pcm = ctypes.string_at(self._pcm, n_samples * nch * 2)
        return AacDecodeResult(
            pcm=pcm,
            num_channels=nch,
            sample_rate=self._sr.value,
            elements=[self._etypes[i] for i in range(ne)],
            element_bits=[(self._ebits[2 * i], self._ebits[2 * i + 1])
                          for i in range(ne)],
        )


def make_decoder() -> AacDecoder:
    """Fastest available AAC decoder: native C++ when buildable, else the
    pure-Python oracle."""
    if native_available():
        return NativeAacDecoder()
    from .aac import AacLcDecoder
    return AacLcDecoder()
