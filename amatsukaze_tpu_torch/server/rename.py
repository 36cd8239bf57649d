"""Output renaming from program information.

Parity: the TranscodeWorker SCRename flow (TranscodeWorker.cs:198-280) —
the reference shells out to the external SCRename VBScript with a
`yyyyMMddHHmm_EventName _ServiceName.ts` synthetic source name and a user
format string. Here the common case is built in: a token-based formatter
over the probed TsInfo event data, plus the same file-name escaping
(Util.EscapeFileName) that maps Windows-unsafe characters to their
full-width forms. An external renamer can still be plugged via
`external_renamer`.

The port's copy of amatsukaze_tpu/server/rename.py.
"""

from __future__ import annotations

import datetime
import os
import re

# half-width unsafe -> full-width (ref Util.EscapeFileName)
_ESCAPE = str.maketrans({
    "\\": "＼", "/": "／", ":": "：", "*": "＊", "?": "？",
    '"': "”", "<": "＜", ">": "＞", "|": "｜",
})


def escape_filename(name: str, replace_url: bool = False) -> str:
    s = name.translate(_ESCAPE)
    if replace_url:
        s = re.sub(r"https?://\S+", "", s)
    return s.strip()


_TOKEN_RE = re.compile(r"\$(\w+)(?::([^$]+))?\$")


def format_output_name(fmt: str, *, event_name: str = "",
                       service_name: str = "", time=None,
                       src_name: str = "") -> str:
    """Expand $tokens$ in a rename format:

      $title$ / $event$   event name
      $service$           service name
      $time$              air time, default yyyyMMddHHmm; $time:FORMAT$ uses
                          a strftime format
      $file$              original file name (no extension)
    """
    def sub(m):
        key, arg = m.group(1), m.group(2)
        if key in ("title", "event"):
            return escape_filename(event_name)
        if key == "service":
            return escape_filename(service_name)
        if key == "file":
            return escape_filename(os.path.splitext(
                os.path.basename(src_name))[0])
        if key == "time":
            if not time:
                return ""
            if isinstance(time, (int, float)):
                t = datetime.datetime.fromtimestamp(time)
            elif isinstance(time, str):
                t = datetime.datetime.fromisoformat(time)
            else:
                t = time
            return t.strftime(arg or "%Y%m%d%H%M")
        return m.group(0)

    out = _TOKEN_RE.sub(sub, fmt)
    # collapse separators left by empty tokens
    out = re.sub(r"\s{2,}", " ", out).strip(" ._-")
    return out


def rename_output(item, fmt: str, external_renamer=None) -> str | None:
    """Resolve the output base name for a queue item. `item` needs
    src_path / event_name / service_name / ts_time attributes (the server
    fills them from TsInfo). Returns None when no information is available
    (keep the original name, like the reference)."""
    event = getattr(item, "event_name", "") or ""
    service = getattr(item, "service_name", "") or ""
    ts_time = getattr(item, "ts_time", "") or None
    if external_renamer is not None:
        return external_renamer(item, fmt)
    if not fmt or not event:
        return None
    return format_output_name(fmt, event_name=event, service_name=service,
                              time=ts_time, src_name=item.src_path)
