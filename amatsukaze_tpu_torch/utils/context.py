"""Run context: leveled logger, error counters, DRCS map, temp-file
registry and the recording's trace (utils/perf.py).

Parity target: AMTContext (reference: Amatsukaze/StreamUtils.hpp:314-511) -
error counter ids and their JSON names match the reference so reports are
comparable (AMT_ERROR_NAMES at StreamUtils.hpp:334-341).

The port's copy of amatsukaze_tpu/utils/context.py.
"""

from __future__ import annotations

import enum
import os
import sys
import time
from dataclasses import dataclass, field

from .perf import Trace


class AMTError(Exception):
    """Framework error (reference: CoreUtils.hpp exception hierarchy)."""


class FormatError(AMTError):
    pass


class InvalidOperationError(AMTError):
    pass


class NoLogoError(AMTError):
    """Exit code 100 in the reference CLI (AmatsukazeCLI.hpp:670-677)."""


class NoDrcsMapError(AMTError):
    """Exit code 101 in the reference CLI."""


class ErrorCounter(enum.IntEnum):
    """Error counters surfaced in the JSON report.

    Names/order match AMT_ERROR_COUNTER + AMT_ERROR_NAMES
    (reference: StreamUtils.hpp:314-341).
    """

    UNKNOWN_PTS = 0
    DECODE_PACKET_FAILED = 1
    H264_PTS_MISMATCH = 2
    H264_UNEXPECTED_FIELD = 3
    NON_CONTINUOUS_PTS = 4
    NO_DRCS_MAP = 5
    DECODE_AUDIO = 6


ERROR_NAMES = (
    "unknown-pts",
    "decode-packet-failed",
    "h264-pts-mismatch",
    "h264-unexpected-field",
    "non-continuous-pts",
    "no-drcs-map",
    "decode-audio-failed",
)

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}


@dataclass
class AMTContext:
    """Logger + error counters + DRCS mapping + temp-file registry + the
    recording's trace."""

    level: str = "info"
    time_prefix: bool = False
    out: object = None  # file-like; defaults to stderr

    counters: dict = field(default_factory=lambda: {e: 0 for e in ErrorCounter})
    drcs_map: dict = field(default_factory=dict)  # md5-hex -> str
    _tmp_files: set = field(default_factory=set)
    trace: Trace = field(default_factory=Trace)

    # -- logging --------------------------------------------------------------
    def _log(self, lv: str, msg: str) -> None:
        if _LEVELS[lv] < _LEVELS[self.level]:
            return
        out = self.out or sys.stderr
        prefix = ""
        if self.time_prefix:
            prefix = time.strftime("%H:%M:%S ") + f"[{lv.upper()}] "
        print(prefix + msg, file=out)

    def debug(self, msg: str, *a) -> None:
        self._log("debug", msg % a if a else msg)

    def info(self, msg: str, *a) -> None:
        self._log("info", msg % a if a else msg)

    def warn(self, msg: str, *a) -> None:
        self._log("warn", msg % a if a else msg)

    def error(self, msg: str, *a) -> None:
        self._log("error", msg % a if a else msg)

    def progress(self, msg: str, *a) -> None:
        self._log("info", msg % a if a else msg)

    # -- error counters ---------------------------------------------------------
    def incr(self, counter: ErrorCounter, n: int = 1) -> None:
        self.counters[counter] += n

    def error_count(self, counter: ErrorCounter) -> int:
        return self.counters[counter]

    def error_json(self) -> dict:
        """Counter dict keyed by reference-compatible names."""
        return {ERROR_NAMES[e]: self.counters[e] for e in ErrorCounter}

    # -- DRCS ----------------------------------------------------------------
    def get_drcs_mapping(self, md5hex: str) -> str | None:
        return self.drcs_map.get(md5hex)

    def load_drcs_mapping(self, path: str) -> None:
        """Load `drcs_map.txt`: lines of `<md5hex>=<replacement>`."""
        if not os.path.exists(path):
            return
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                self.drcs_map[k.strip().lower()] = v

    # -- temp files -------------------------------------------------------------
    def register_tmp_file(self, path: str) -> str:
        self._tmp_files.add(path)
        return path

    def clear_tmp_files(self) -> None:
        # pop-based drain: registrations can race in from pipeline
        # threads (prefetch/pump); iterating the live set would raise
        # "Set changed size during iteration"
        while True:
            try:
                p = self._tmp_files.pop()
            except KeyError:
                return
            try:
                os.remove(p)
            except OSError:
                pass
