"""NicoJK18 comment-server client + NicoConvASS-equivalent converter.

Parity: NicoJK18Client/Program.cs (the whole tool) and the NicoJK.hpp
integration points:

- wire protocol (Program.cs GetData/ReadData): GET
  ``{base}/api/v1/getcomment?jknum=jkN&slot=S&num=M`` where a slot is 300
  seconds of comments and at most 8 slots are requested per call; the
  response body is `num` blobs, each a 4-byte little-endian length
  followed by a zlib stream (the reference strips the 2-byte zlib header
  and raw-inflates) of UTF-8 chat XML
- HTTP status semantics: 400 = bad parameters (no retry), 406 = no such
  thread (the client exits with code 100, which NicoJK.hpp:147-151
  treats as "channel has no comments" rather than a failure), anything
  else retries with quadratic backoff (retry^2 * 2 seconds, 6 tries)
- chat ordering (Program.cs Exec): filter to [start, end), sort by
  (date, thread, no)
- output formats: ``-x`` XML (``<packet>...</packet>``) or the NicoJK
  line format (CR/LF escaped as &#13;/&#10;)
- jknum lookup from ch_sid.txt by service id (NicoJK.hpp getJKNum
  :111-129; the table is tab-separated with the service id in column 3)
- XML -> ASS conversion (the reference spawns the external NicoConvASS;
  here an in-build converter emits the same scrolling-comment ASS shape
  the downstream captions/nicojk.py parser consumes)

The port's copy of amatsukaze_tpu/captions/nicojk18.py.
"""

from __future__ import annotations

import io
import re
import struct
import time as _time
import urllib.error
import urllib.request
import zlib
from dataclasses import dataclass
from xml.etree import ElementTree

DEFAULT_BASE_URL = "http://nicojk18.sakura.ne.jp"
SLOT_DURATION = 5 * 60
MAX_SLOT_REQ = 8


class NoThreadError(Exception):
    """HTTP 406: the channel has no comment thread (exit code 100)."""


class ParamError(Exception):
    """HTTP 400: bad request parameters — do not retry."""


def read_data(stream, num: int) -> list[str]:
    """Parse `num` length-prefixed zlib blobs (ref ReadData)."""
    out = []
    for _ in range(num):
        head = stream.read(4)
        if len(head) != 4:
            raise IOError("receive error")
        (length,) = struct.unpack("<i", head)
        blob = stream.read(length)
        if len(blob) != length:
            raise IOError("receive error")
        # the reference skips the 2-byte zlib header and raw-inflates
        # (trailing adler32 is ignored by the raw decompressor)
        out.append(zlib.decompressobj(-15).decompress(blob[2:])
                   .decode("utf-8"))
    return out


def _default_http_get(url: str, timeout: float = 180.0):
    """Returns (status, body_bytes)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as res:
            return res.status, res.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def fetch_comments(jknum: str, start_time: int, end_time: int,
                   base_url: str = DEFAULT_BASE_URL, retry: int = 6,
                   http_get=None, sleep=_time.sleep, log=None) -> list[str]:
    """All raw chat-XML strings covering [start_time, end_time)
    (ref Exec's slot loop + GetData)."""
    http_get = http_get or _default_http_get
    log = log or (lambda msg: None)
    recv: list[str] = []
    start_slot = start_time // SLOT_DURATION
    end_slot = (end_time + SLOT_DURATION - 1) // SLOT_DURATION
    i = start_slot
    while i < end_slot:
        nslot = min(end_slot - i, MAX_SLOT_REQ)
        log(f"fetching {nslot} slots from {i}")
        for attempt in range(retry):
            if attempt > 0:
                wait = attempt * attempt * 2
                log(f"retrying in {wait}s ...")
                sleep(wait)
            url = (f"{base_url}/api/v1/getcomment?"
                   f"jknum={jknum}&slot={i}&num={nslot}")
            try:
                status, body = http_get(url)
            except OSError as e:
                log(f"failed: {e}")
                continue
            if status == 400:
                raise ParamError("bad parameters")
            if status == 406:
                raise NoThreadError("no comment thread")
            if status != 200:
                log(f"failed: HTTP {status}")
                continue
            recv.extend(read_data(io.BytesIO(body), nslot))
            break
        else:
            raise IOError(f"giving up after {retry} attempts")
        i += nslot
    return recv


@dataclass
class Chat:
    date: int
    thread: int
    no: int
    text: str
    xml: str


def wrap_xml(items) -> str:
    body = "\n".join(items)
    return f"<?xml version='1.0' encoding='UTF-8'?>\n<packet>\n{body}\n</packet>"


def nicojk_format(items) -> str:
    return "".join(s.replace("\r", "&#13;").replace("\n", "&#10;") + "\n"
                   for s in items)


def parse_chats(xml_strings: list[str]) -> list[Chat]:
    doc = ElementTree.fromstring(wrap_xml(xml_strings))
    chats = []
    for el in doc:
        try:
            chats.append(Chat(
                date=int(el.get("date")),
                thread=int(el.get("thread")),
                no=int(el.get("no")),
                text=el.text or "",
                xml=ElementTree.tostring(el, encoding="unicode").strip(),
            ))
        except (TypeError, ValueError):
            continue
    return chats


def ordered_chats(chats: list[Chat], start_time: int,
                  end_time: int) -> list[Chat]:
    return sorted((c for c in chats
                   if start_time <= c.date < end_time),
                  key=lambda c: (c.date, c.thread, c.no))


def parse_time(s: str) -> int:
    """Unix seconds or local-time yyyyMMddHHmmss (ref ParseTime)."""
    if len(s) == 14 and s.isdigit():
        t = _time.strptime(s, "%Y%m%d%H%M%S")
        return int(_time.mktime(t))
    return int(s)


def run_client(argv: list[str], base_url: str = DEFAULT_BASE_URL,
               http_get=None, sleep=_time.sleep, out=None) -> int:
    """NicoJK18Client.exe-compatible CLI: ``jkN start end [-f file]
    [-r retry] [-x]``; exit 0 ok / 1 error / 100 no thread."""
    import sys

    out = out or sys.stdout
    dst = None
    retry = 6
    as_xml = False
    pos: list[str] = []
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a in ("-f", "--file"):
                i += 1
                dst = argv[i]
            elif a in ("-r", "--retry"):
                i += 1
                retry = int(argv[i])
            elif a in ("-x", "--xml"):
                as_xml = True
            elif not a.startswith("-"):
                pos.append(a)
            i += 1
        jknum, start_time, end_time = \
            pos[0], parse_time(pos[1]), parse_time(pos[2])
    except (IndexError, ValueError):
        print("Usage: nicojk18 <jkN> <start> <end> [-f file] [-r n] [-x]",
              file=out)
        return 1
    if start_time > end_time or start_time + 3600 * 24 < end_time:
        print("invalid time range", file=out)
        return 1
    try:
        recv = fetch_comments(jknum, start_time, end_time, base_url,
                              retry=retry, http_get=http_get, sleep=sleep,
                              log=lambda m: print(m, file=out))
    except NoThreadError as e:
        print(str(e), file=out)
        return 100
    except (ParamError, OSError) as e:
        print(str(e), file=out)
        return 1
    chats = ordered_chats(parse_chats(recv), start_time, end_time)
    print(f"fetched {len(chats)} comments", file=out)
    result = (wrap_xml(c.xml for c in chats) if as_xml
              else nicojk_format(c.xml for c in chats))
    if dst is None:
        print(result, file=out)
    else:
        with open(dst, "w", encoding="utf-8") as f:
            f.write(result)
    return 0


# ---------------------------------------------------------------------------
# NicoConvASS-equivalent XML -> ASS conversion
# ---------------------------------------------------------------------------

_ASS_HEADER = """[Script Info]
ScriptType: v4.00+
PlayResX: {width}
PlayResY: {height}

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, SecondaryColour, OutlineColour, BackColour, Bold, Italic, Underline, StrikeOut, ScaleX, ScaleY, Spacing, Angle, BorderStyle, Outline, Shadow, Alignment, MarginL, MarginR, MarginV, Encoding
Style: white,MS PGothic,{fontsize},&H00ffffff,&H00ffffff,&H00000000,&H00000000,-1,0,0,0,200,200,0,0.00,1,0,4,7,20,20,40,1

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
"""

_SCROLL_SECONDS = 4.0
_ROWS = 12


def _ass_time(t: float) -> str:
    # format from integral centiseconds so 59.999 never rounds to an
    # invalid ":60.00" seconds field
    cs = round(t * 100)
    h, cs = divmod(cs, 360000)
    m, cs = divmod(cs, 6000)
    return f"{h}:{m:02d}:{cs // 100:02d}.{cs % 100:02d}"


def _esc(text: str) -> str:
    return re.sub(r"[\r\n]+", " ", text).replace("{", "(").replace("}", ")")


def chats_to_ass(chats: list[Chat], tx_start_time: int,
                 width: int = 1280, height: int = 720) -> str:
    """Scrolling-comment ASS (the NicoConvASS contract: right-to-left
    \\move comments laned into rows, times relative to the recording
    start)."""
    fontsize = height // 15
    out = [_ASS_HEADER.format(width=width, height=height,
                              fontsize=fontsize)]
    row_free = [0.0] * _ROWS  # when each lane frees up
    for c in ordered_chats(chats, 0, 1 << 62):
        t0 = c.date - tx_start_time
        if t0 < 0:
            continue
        row = min(range(_ROWS), key=lambda r: row_free[r])
        if row_free[row] > t0:
            row = int(t0 * 10) % _ROWS  # all lanes busy: reuse one
        row_free[row] = t0 + _SCROLL_SECONDS * 0.6
        y = 4 + row * (fontsize + 2)
        text_w = fontsize * max(1, len(c.text)) * 0.9
        move = (f"{{\\move({width + text_w / 2:.0f},{y + fontsize / 2:.0f},"
                f"{-text_w / 2:.0f},{y + fontsize / 2:.0f})}}")
        out.append(
            f"Dialogue: 0,{_ass_time(t0)},"
            f"{_ass_time(t0 + _SCROLL_SECONDS)},white,,0000,0000,0000,,"
            f"{move}{_esc(c.text)}")
    return "\n".join(out) + "\n"


def make_fetcher(ch_sid_path: str, base_url: str = DEFAULT_BASE_URL,
                 http_get=None, sleep=_time.sleep, retry: int = 6):
    """A captions.nicojk.NicoJK-compatible fetcher backed by the HTTP
    client: fetcher(service_id, start_time, duration) -> ASS text or
    None (no jknum mapping / no comment thread — the reference treats
    both as "no comments", not failure)."""
    from .nicojk import parse_ch_sid

    def fetcher(service_id: int, start_time, duration: int):
        with open(ch_sid_path, encoding="utf-8") as f:
            table = parse_ch_sid(f.read())
        entry = table.get(int(service_id))
        if entry is None:
            return None
        jknum = f"jk{entry[0]}"
        start = int(start_time)
        try:
            recv = fetch_comments(jknum, start, start + int(duration),
                                  base_url, retry=retry,
                                  http_get=http_get, sleep=sleep)
        except NoThreadError:
            return None  # exit-100 semantics: channel without comments
        chats = ordered_chats(parse_chats(recv), start,
                              start + int(duration))
        if not chats:
            return None
        return chats_to_ass(chats, start)

    return fetcher


def main(argv=None) -> int:
    import sys

    return run_client(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    raise SystemExit(main())
