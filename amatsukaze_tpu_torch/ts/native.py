"""ctypes bindings for the native TS demux engine (native/tsdemux.cpp).

The engine runs the steady-state per-packet loop (sync scan, PID routing,
PES assembly + validation) in C++; Python keeps the control plane. Load via
:func:`load_native`, which builds the shared library on first use when a
compiler is available and returns None otherwise — every caller must keep
the pure-Python path as fallback.

The port's copy of amatsukaze_tpu/ts/native.py.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_NAME = "libamatsukaze_native.so"

EVENT_PES = 0
EVENT_RAW = 1
EVENT_PCR = 2
EVENT_PAUSE = 3

PID_OFF = 0
PID_PES = 1
PID_RAW = 2
PID_PAUSE = 3

_lock = threading.Lock()
_lib = None
_load_attempted = False


# Every loader of the port builds native/ through build_native(), which
# holds this lock while `make` runs: processes that load the libraries at
# the same time (test workers, chip_smoke.py's build thread) then
# wait for one build instead of racing on the same object files.
_BUILD_LOCK = os.path.join(os.path.dirname(__file__), "..", "ops", "build",
                           "native.lock")


def build_native(target: str, timeout: float) -> bool:
    """Run `make -C native -s <target>` under an exclusive lock on a file
    in the package's git-ignored build directory; True when make
    succeeded. The target is named, not `all`: the Makefile's probe for
    the FFmpeg headers passes without them under GNU make 4.3 and later
    (its escaped `#` reaches the shell), and `all` then fails on the bridge
    before the engines' library is linked."""
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return False
    jobs = str(min(8, os.cpu_count() or 1))
    try:
        os.makedirs(os.path.dirname(_BUILD_LOCK), exist_ok=True)
        with open(_BUILD_LOCK, "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR, "-s", "-j", jobs,
                                target], check=True, capture_output=True,
                               timeout=timeout)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def _build() -> str | None:
    if not build_native(_LIB_NAME, 180):
        return None
    path = os.path.join(_NATIVE_DIR, _LIB_NAME)
    return path if os.path.exists(path) else None


def load_native():
    """Return the loaded CDLL (shared by the TS demux, AAC decoder and QP
    extractor bindings), building/refreshing it if possible; None when
    unavailable. `make` is invoked even when the .so exists so a stale
    library built from older sources is refreshed (no-op when current)."""
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        path = _build() or os.path.join(_NATIVE_DIR, _LIB_NAME)
        if not os.path.exists(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        # Video-frame buffers (a 4K Main10 frame is ~17 MB per plane)
        # exceed glibc's mmap threshold, so by default every decoded
        # frame costs an mmap + page faults + munmap round trip.  Raise
        # M_MMAP_THRESHOLD so large plane buffers recycle through the
        # heap (measured ~1.5x on steady-state 4K decode through the
        # Python wrappers).
        try:
            ctypes.CDLL(None).mallopt(-3, 1 << 28)  # M_MMAP_THRESHOLD
        except (OSError, AttributeError):
            pass
        lib.tse_create.restype = ctypes.c_void_p
        lib.tse_destroy.argtypes = [ctypes.c_void_p]
        lib.tse_reset.argtypes = [ctypes.c_void_p]
        lib.tse_clear_pes.argtypes = [ctypes.c_void_p]
        lib.tse_set_pid_mode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int]
        lib.tse_clear_pid_modes.argtypes = [ctypes.c_void_p]
        lib.tse_set_pcr_pid.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tse_input.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_longlong]
        lib.tse_input.restype = ctypes.c_int
        lib.tse_skip_packet.argtypes = [ctypes.c_void_p]
        lib.tse_resume_packet.argtypes = [ctypes.c_void_p]
        lib.tse_seed_pes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_longlong]
        lib.tse_set_sync_ok.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tse_flush.argtypes = [ctypes.c_void_p]
        lib.tse_flush.restype = ctypes.c_int
        lib.tse_flush_pes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tse_event_count.argtypes = [ctypes.c_void_p]
        lib.tse_event_count.restype = ctypes.c_longlong
        lib.tse_events_meta.argtypes = [ctypes.c_void_p]
        lib.tse_events_meta.restype = ctypes.POINTER(ctypes.c_longlong)
        lib.tse_events_data.argtypes = [ctypes.c_void_p]
        lib.tse_events_data.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.tse_events_clear.argtypes = [ctypes.c_void_p]
        lib.tse_counter.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tse_counter.restype = ctypes.c_longlong
        lib.tse_set_packet_count.argtypes = [ctypes.c_void_p,
                                             ctypes.c_longlong]
        _lib = lib
        return _lib


class NativeTsEngine:
    """Thin OO wrapper over the C engine. `take_events()` drains the ordered
    event stream as (meta ndarray [n,6], payload bytes)."""

    def __init__(self, lib=None):
        self.lib = lib or load_native()
        if self.lib is None:
            raise RuntimeError("native TS engine unavailable")
        self.h = self.lib.tse_create()

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.tse_destroy(self.h)
            self.h = None

    def reset(self) -> None:
        self.lib.tse_reset(self.h)

    def clear_pes(self) -> None:
        self.lib.tse_clear_pes(self.h)

    def set_pid_mode(self, pid: int, mode: int) -> None:
        self.lib.tse_set_pid_mode(self.h, pid, mode)

    def clear_pid_modes(self) -> None:
        self.lib.tse_clear_pid_modes(self.h)

    def set_pcr_pid(self, pid: int) -> None:
        self.lib.tse_set_pcr_pid(self.h, pid)

    def input(self, data: bytes = b"") -> bool:
        """Feed bytes (empty = resume). Returns True when fully scanned,
        False when paused at a control (mode-3) packet."""
        return bool(self.lib.tse_input(self.h, data, len(data)))

    def skip_packet(self) -> None:
        self.lib.tse_skip_packet(self.h)

    def resume_packet(self) -> None:
        self.lib.tse_resume_packet(self.h)

    def seed_pes(self, pid: int, cc: int, data: bytes) -> None:
        self.lib.tse_seed_pes(self.h, pid, cc, data, len(data))

    def set_sync_ok(self, ok: bool) -> None:
        self.lib.tse_set_sync_ok(self.h, 1 if ok else 0)

    def flush(self) -> bool:
        return bool(self.lib.tse_flush(self.h))

    def flush_pes(self, pid: int) -> None:
        self.lib.tse_flush_pes(self.h, pid)

    def take_events(self):
        n = self.lib.tse_event_count(self.h)
        if n == 0:
            return np.empty((0, 6), np.int64), b""
        meta_ptr = self.lib.tse_events_meta(self.h)
        meta = np.ctypeslib.as_array(meta_ptr, shape=(n, 6)).copy()
        total = 0
        for off, ln in zip(meta[:, 2], meta[:, 3]):
            if off >= 0:
                total = max(total, int(off + ln))
        data_ptr = self.lib.tse_events_data(self.h)
        data = (ctypes.string_at(data_ptr, total) if total else b"")
        self.lib.tse_events_clear(self.h)
        return meta, data

    def counter(self, which: int) -> int:
        return self.lib.tse_counter(self.h, which)

    def set_packet_count(self, v: int) -> None:
        self.lib.tse_set_packet_count(self.h, v)
