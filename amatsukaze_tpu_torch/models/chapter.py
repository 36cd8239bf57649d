"""Chapter generation from JLS-style CM analysis elements.

The port's copy of amatsukaze_tpu/models/chapter.py, which holds no JAX: the
port keeps its own so that it imports nothing of the JAX package.

Parity: MakeChapter (Amatsukaze/CMAnalyze.hpp:462-679): parse the JLS detail
output, merge redundant cut spans, name program chapters A/B/C... (with
NNSec suffixes for trailers/sponsors/60s/90s blocks), convert to per-output
file frames, drop chapters shorter than 2 s, and emit `CHAPTERxx=` files.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass


@dataclass
class JlsElement:
    frame_start: int
    frame_end: int  # exclusive
    seconds: int
    comment: str = ""
    is_cut: bool = False
    is_cm: bool = False
    is_old: bool = False


_JLS_RE = re.compile(r"^\s*(\d+)\s+(\d+)\s+(\d+)\s+([-\d]+)\s+(\d+).*:(\S+)")
_JLS_RE_OLD = re.compile(r"^\s*(\d+)\s+(\d+)\s+(\d+)\s+([-\d]+)\s+(\d+)")


def parse_jls(text: str) -> list[JlsElement]:
    """Parse the JLS detail output (ref readJls :501-530)."""
    out = []
    for line in text.splitlines():
        m = _JLS_RE.search(line)
        if m:
            out.append(
                JlsElement(int(m.group(1)), int(m.group(2)) + 1, int(m.group(3)),
                           m.group(6))
            )
            continue
        m = _JLS_RE_OLD.search(line)
        if m:
            out.append(
                JlsElement(int(m.group(1)), int(m.group(2)) + 1, int(m.group(3)), "")
            )
    return out


def format_jls(elements: list[JlsElement]) -> str:
    """Emit a JLS-style detail file (so our in-process decider's output is
    inspectable with the same tooling)."""
    lines = []
    for e in elements:
        label = f"  :{e.comment}" if e.comment else ""
        lines.append(
            f"{e.frame_start:6d} {e.frame_end - 1:6d} {e.seconds:4d} "
            f"0 0{label}"
        )
    return "\n".join(lines) + "\n"


class ChapterMaker:
    """Builds chapter lists (ref makeBase/makeFileChapter/writeChapter)."""

    def __init__(self, trims: list[int], elements: list[JlsElement]):
        self.chapters: list[JlsElement] = []
        self._make_base(trims, elements)

    def _make_base(self, trims: list[int], elements: list[JlsElement]) -> None:
        if not elements:
            return
        for e in elements:
            trim_idx = bisect.bisect_left(trims, (e.frame_start + e.frame_end) // 2)
            e.is_cut = trim_idx % 2 == 0
            e.is_cm = e.comment == "CM"
            e.is_old = len(e.comment) == 0

        # merge adjacent cut spans of the same kind (ref :553-573)
        cur = elements[0]
        for e in elements[1:]:
            if cur.is_cut and e.is_cut and cur.is_cm == e.is_cm:
                cur.frame_end = e.frame_end
                cur.seconds += e.seconds
            else:
                self.chapters.append(cur)
                cur = e
        self.chapters.append(cur)

        # rename comments to chapter labels (ref :576-604)
        n_chapter = -1
        prev_cm = True
        for c in self.chapters:
            if c.is_cut:
                c.comment = "CM" if (c.is_cm or c.is_old) else "CM?"
                prev_cm = True
            else:
                show_sec = (
                    c.comment.startswith(("Trailer", "Sponsor", "Endcard",
                                          "Edge", "Border"))
                    or c.seconds in (60, 90)
                )
                if prev_cm:
                    n_chapter += 1
                    prev_cm = False
                c.comment = chr(ord("A") + n_chapter % 26)
                if show_sec:
                    c.comment += f"{c.seconds}Sec"

    def file_chapters(self, out_frames: list[int], fps: float) -> list[JlsElement]:
        """Convert to output-file frame indices; drop chapters < 2 s
        (ref makeFileChapter :607-646)."""
        cvt = []
        for c in self.chapters:
            cvt.append(
                JlsElement(
                    bisect.bisect_left(out_frames, c.frame_start),
                    bisect.bisect_left(out_frames, c.frame_end),
                    c.seconds, c.comment, c.is_cut, c.is_cm, c.is_old,
                )
            )
        fps_i = int(round(fps))
        out: list[JlsElement] = []
        cur = JlsElement(0, 0, 0, "")
        for c in cvt:
            if c.frame_end - c.frame_start < fps_i * 2:
                cur.frame_end = c.frame_end
            elif not cur.comment:
                start = cur.frame_start
                cur = JlsElement(start, c.frame_end, c.seconds, c.comment,
                                 c.is_cut, c.is_cm, c.is_old)
            else:
                out.append(cur)
                cur = JlsElement(c.frame_start, c.frame_end, c.seconds, c.comment,
                                 c.is_cut, c.is_cm, c.is_old)
        if cur.comment:
            out.append(cur)
        return out

    @staticmethod
    def format_chapters(chapters: list[JlsElement], frame_rate_num: int,
                        frame_rate_denom: int) -> str:
        """CHAPTERxx=hh:mm:ss.mmm file body (ref writeChapter :648-678)."""
        frame_ms = frame_rate_denom / frame_rate_num * 1000.0
        lines = []
        sumframes = 0
        for i, c in enumerate(chapters):
            ms = int(round(sumframes * frame_ms))
            s, ms_part = divmod(ms, 1000)
            m, s = divmod(s, 60)
            h, m = divmod(m, 60)
            h %= 60
            lines.append(f"CHAPTER{i + 1:02d}={h:02d}:{m:02d}:{s:02d}.{ms_part:03d}")
            lines.append(f"CHAPTER{i + 1:02d}NAME={c.comment}")
            sumframes += c.frame_end - c.frame_start
        return "\n".join(lines) + ("\n" if lines else "")
