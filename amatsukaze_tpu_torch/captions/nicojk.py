"""NicoJK (nico-nico jikkyo) comment handling.

Parity: NicoJK / NicoJKFormatter (Amatsukaze/NicoJK.hpp:18-368): jknum lookup
from ch_sid.txt, comment acquisition via pluggable fetchers (the reference
spawns NicoJK18Client.exe / NicoConvASS.exe; zero-egress environments plug a
local-log reader instead), ASS dialogue parsing into NicoJKLine, derived
720T/1080T transparent variants by editing the style lines, and per-output
re-emission.

The port's copy of amatsukaze_tpu/captions/nicojk.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..reform.stream_reform import MPEG_CLOCK_HZ, NicoJKLine

NICOJK_TYPES = ("720S", "720T", "1080S", "1080T")
MASK_720S, MASK_720T, MASK_1080S, MASK_1080T = 1, 2, 4, 8

_DIALOGUE_RE = re.compile(
    r"Dialogue: 0,(\d):(\d\d):(\d\d)\.(\d\d),(\d):(\d\d):(\d\d)\.(\d\d)(.*)"
)


def parse_ch_sid(text: str) -> dict[int, tuple[int, str]]:
    """ch_sid.txt: five tab-separated columns per line with the jknum in
    column 1, the service id in column 3 and the TV name in column 5
    (ref getJKNum NicoJK.hpp:111-129: regex groups m[1]/m[3]/m[5],
    strtol base 0 so hex service ids work)."""
    out = {}
    for line in text.splitlines():
        parts = line.split("\t")
        if len(parts) >= 5:
            try:
                jknum = int(parts[0].lstrip("jk"), 0)
                sid = int(parts[2], 0)
            except ValueError:
                continue
            out[sid] = (jknum, parts[4])
    return out


def _to_clock(h, m, s, cs) -> float:
    return ((h * 3600 + m * 60 + s) + cs / 100.0) * MPEG_CLOCK_HZ


def parse_ass(text: str) -> tuple[list[str], list[NicoJKLine]]:
    """Split an ASS file into header lines + parsed dialogues
    (ref readASS :263-297)."""
    headers: list[str] = []
    dialogues: list[NicoJKLine] = []
    lines = text.splitlines()
    i = 0
    for i, line in enumerate(lines):
        headers.append(line)
        if line == "[Events]":
            break
    if i + 1 < len(lines):
        headers.append(lines[i + 1])  # Format: ...
    for line in lines[i + 2 :]:
        m = _DIALOGUE_RE.match(line)
        if m:
            g = [int(x) for x in m.groups()[:8]]
            dialogues.append(
                NicoJKLine(_to_clock(*g[:4]), _to_clock(*g[4:8]), m.group(9))
            )
    return headers, dialogues


def make_transparent_variant(ass_text: str) -> str:
    """Derive the `T` (transparent) variant: 0x70 alpha on the four style
    colours, outline on, shadow off (ref makeT :165-209)."""
    out = []
    lines = ass_text.splitlines()
    it = iter(range(len(lines)))
    i = 0
    # copy until [V4+ Styles]
    while i < len(lines):
        out.append(lines[i])
        if lines[i] == "[V4+ Styles]":
            break
        i += 1
    i += 1
    if i < len(lines):
        out.append(lines[i])  # Format:
        i += 1
    while i < len(lines) and lines[i].startswith("Style:"):
        tokens = lines[i].split(",")
        for k in range(3, 7):
            if len(tokens[k]) >= 4:
                tokens[k] = tokens[k][:2] + "70" + tokens[k][4:]
        if len(tokens) > 17:
            tokens[16] = "1"  # outline on
            tokens[17] = "0"  # shadow off
        out.append(",".join(tokens))
        i += 1
    out.extend(lines[i:])
    return "\n".join(out) + "\n"


class NicoJKFormatter:
    """Re-emit dialogues with output-file-relative times
    (ref NicoJKFormatter :332-368)."""

    @staticmethod
    def _time(t: float) -> str:
        total_sec = t / MPEG_CLOCK_HZ
        total_min = total_sec / 60
        h = int(total_min / 60)
        m = int(total_min) % 60
        sec = total_sec - int(total_min) * 60
        return f"{h}:{m:02d}:{sec:05.2f}"

    def generate(self, headers: list[str], dialogues: list[NicoJKLine]) -> str:
        parts = list(headers)
        for d in dialogues:
            parts.append(
                f"Dialogue: 0,{self._time(d.start)},{self._time(d.end)}{d.line}"
            )
        return "\n".join(parts) + "\n"


class NicoJK:
    """Comment acquisition orchestrator. Fetchers are pluggable:
    fetcher(service_id, start_time, duration) -> ass_text | None."""

    def __init__(self, ctx, ch_sid_map: dict | None = None, fetchers=None,
                 mask: int = MASK_720S):
        self.ctx = ctx
        self.ch_sid = ch_sid_map or {}
        self.fetchers = fetchers or []
        self.mask = mask
        self.headers: dict[int, list[str]] = {}
        self.dialogues: dict[int, list[NicoJKLine]] = {}
        self.failed = False

    def jknum_for(self, service_id: int) -> int:
        entry = self.ch_sid.get(service_id)
        return entry[0] if entry else -1

    def make_ass(self, service_id: int, start_time, duration: int) -> bool:
        """Returns True when comments were obtained (ref makeASS :131-154)."""
        ass_s = None
        for fetcher in self.fetchers:
            try:
                ass_s = fetcher(service_id, start_time, duration)
            except Exception as e:  # noqa: BLE001
                self.ctx.warn("nicojk fetcher failed: %s", e)
                self.failed = True
            if ass_s:
                break
        if not ass_s:
            return False
        texts = {0: ass_s, 2: ass_s}  # S variants share the fetched ASS
        texts[1] = make_transparent_variant(ass_s)
        texts[3] = texts[1]
        for t in range(4):
            if self.mask & (1 << t):
                headers, dialogues = parse_ass(texts[t])
                self.headers[t] = headers
                self.dialogues[t] = dialogues
        return True

    def get_dialogues(self) -> list[list[NicoJKLine]]:
        return [self.dialogues.get(t, []) for t in range(4)]
