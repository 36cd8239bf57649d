"""Run context: leveled logger.

Counterpart of amatsukaze_tpu/utils/context.py (AMTContext, parity target
Amatsukaze/StreamUtils.hpp:314-511), cut to what the filter core uses: the
log calls. Error counters, the DRCS map and the temp-file registry belong
to the host layers that are not ported yet.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}


@dataclass
class AMTContext:
    """Leveled logger (writes to `out`, default stderr)."""

    level: str = "info"
    out: object = None

    def _log(self, lv: str, msg: str) -> None:
        if _LEVELS[lv] >= _LEVELS[self.level]:
            print(msg, file=self.out or sys.stderr)

    def debug(self, msg: str, *a) -> None:
        self._log("debug", msg % a if a else msg)

    def info(self, msg: str, *a) -> None:
        self._log("info", msg % a if a else msg)

    def warn(self, msg: str, *a) -> None:
        self._log("warn", msg % a if a else msg)

    def error(self, msg: str, *a) -> None:
        self._log("error", msg % a if a else msg)
