"""ASS / SRT caption formatters.

Parity: CaptionASSFormatter / CaptionSRTFormatter
(Amatsukaze/CaptionFormatter.hpp:12-295): same header, style line (Yu Gothic
with the +10 size fudge), per-fragment override codes (pos/colour/scale/
spacing/underline/bold/italic) with state-change tracking, and the SRT
index/position line-break behaviour (small-size fragments skipped).

The port's copy of amatsukaze_tpu/captions/formatters.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..reform.stream_reform import MPEG_CLOCK_HZ, OutCaptionLine
from .b24 import CaptionFormat

DEF_FONT_SIZE = 36.0
SIZE_SMALL = 0


@dataclass
class _State:
    x: int = 0
    y: int = 0
    fsx: float = 1.0
    fsy: float = 1.0
    spacing: int = 4
    text_color: tuple = (255, 255, 255, 255)
    back_color: tuple = (0, 0, 0, 128)
    style: int = 0


STYLE_UNDERLINE = 1
STYLE_BOLD = 4
STYLE_ITALIC = 8


class CaptionASSFormatter:
    def __init__(self, ctx):
        self.ctx = ctx

    def generate(self, lines: list[OutCaptionLine]) -> str:
        if not lines:
            return ""
        self.play_res_x = lines[0].line.plane_w
        self.play_res_y = lines[0].line.plane_h
        out = [self._header()]
        for line in lines:
            s = self._item(line)
            if s:
                out.append(s)
        return "".join(out)

    def _header(self) -> str:
        return (
            "[Script Info]\n"
            "ScriptType: v4.00+\n"
            "Collisions: Normal\n"
            "ScaledBorderAndShadow: Yes\n"
            f"PlayResX: {self.play_res_x}\n"
            f"PlayResY: {self.play_res_y}\n"
            "\n"
            "[V4+ Styles]\n"
            "Format: Name, Fontname, Fontsize, PrimaryColour, SecondaryColour,"
            " OutlineColour, BackColour, Bold, Italic, Underline, StrikeOut,"
            " ScaleX, ScaleY, Spacing, Angle, BorderStyle, Outline, Shadow,"
            " Alignment, MarginL, MarginR, MarginV, Encoding\n"
            # Yu Gothic needs +10 to hit the nominal size (ref :73-75)
            f"Style: Default,Yu Gothic,{int(DEF_FONT_SIZE) + 10},&H00FFFFFF,"
            "&H000000FF,&H00000000,&H7F000000,1,0,0,0,100,100,4,0,1,2,2,1,0,0,0,1\n"
            "\n"
            "[Events]\n"
            "Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV,"
            " Effect, Text\n"
        )

    @staticmethod
    def _time(t: float) -> str:
        total_sec = t / MPEG_CLOCK_HZ
        total_min = total_sec / 60
        h = int(total_min / 60)
        m = int(total_min) % 60
        sec = total_sec - int(total_min) * 60
        return f"{h}:{m:02d}:{sec:05.2f}"

    def _item(self, line: OutCaptionLine) -> str:
        cl = line.line
        if not cl.formats:
            return ""
        self._cur = _State()
        parts = [
            f"Dialogue: 0,{self._time(line.start)},{self._time(line.end)},"
            "Default,,0000,0000,0000,,"
        ]
        scalex = self.play_res_x / cl.plane_w
        scaley = self.play_res_y / cl.plane_h
        fmts = cl.formats
        text = cl.text
        for i, fmt in enumerate(fmts):
            begin = fmt.pos
            end = fmts[i + 1].pos if i + 1 < len(fmts) else len(text)
            frag = text[begin:end]
            attr = []
            if i == 0:
                n = max(1, len(frag))
                x = cl.pos_x + (fmt.width / n - fmt.char_w) * DEF_FONT_SIZE / fmt.char_w / 2
                y = cl.pos_y - (fmt.height - fmt.char_h) / 2
                self._set_pos(attr, int(x * scalex), int(y * scaley))
            self._fragment(attr, scalex, scaley, frag, fmt)
            if attr:
                parts.append("{" + "".join(attr) + "}")
            parts.append(frag)
        parts.append("\n")
        return "".join(parts)

    def _fragment(self, attr, scalex, scaley, text, fmt: CaptionFormat) -> None:
        n = max(1, len(text))
        fsx = fmt.char_w / DEF_FONT_SIZE
        fsy = fmt.char_h / DEF_FONT_SIZE
        spacing = (fmt.width / n - fmt.char_w) / fsx if fsx else 0
        self._set_color(attr, fmt.text_color, fmt.back_color)
        self._set_font_size(attr, fsx * scalex, fsy * scaley)
        self._set_spacing(attr, round(spacing * scalex))
        self._set_style(attr, fmt.style)

    def _set_pos(self, attr, x, y) -> None:
        if self._cur.x != x or self._cur.y != y:
            attr.append(f"\\pos({x},{y})")
            self._cur.x, self._cur.y = x, y

    def _set_color(self, attr, tc, bc) -> None:
        if self._cur.text_color != tc:
            attr.append(f"\\c&H{255 - tc[3]:02X}{tc[2]:02X}{tc[1]:02X}{tc[0]:02X}")
            self._cur.text_color = tc
        if self._cur.back_color != bc:
            attr.append(f"\\4c&H{255 - bc[3]:02X}{bc[2]:02X}{bc[1]:02X}{bc[0]:02X}")
            self._cur.back_color = bc

    def _set_font_size(self, attr, fsx, fsy) -> None:
        if self._cur.fsx != fsx:
            attr.append(f"\\fscx{int(fsx * 100)}")
            self._cur.fsx = fsx
        if self._cur.fsy != fsy:
            attr.append(f"\\fscy{int(fsy * 100)}")
            self._cur.fsy = fsy

    def _set_spacing(self, attr, spacing) -> None:
        if self._cur.spacing != spacing:
            attr.append(f"\\fsp{spacing}")
            self._cur.spacing = spacing

    def _set_style(self, attr, style) -> None:
        for bit, code in ((STYLE_UNDERLINE, "u"), (STYLE_BOLD, "b"),
                          (STYLE_ITALIC, "i")):
            cur = bool(self._cur.style & bit)
            new = bool(style & bit)
            if cur != new:
                attr.append(f"\\{code}{int(new)}")
        self._cur.style = style


class CaptionSRTFormatter:
    def __init__(self, ctx):
        self.ctx = ctx

    @staticmethod
    def _time(t: float) -> str:
        total_sec = t / MPEG_CLOCK_HZ
        total_min = total_sec / 60
        h = int(total_min / 60)
        m = int(total_min) % 60
        sec = total_sec - int(total_min) * 60
        s = int(sec)
        ms = round((sec - s) * 1000)
        return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"

    def generate(self, lines: list[OutCaptionLine]) -> str:
        out = []
        linebuf = []
        sub_index = 1
        prev_end = -1.0
        prev_pos_y = -1.0

        def push_line():
            if linebuf:
                out.append("".join(linebuf) + "\n")
                linebuf.clear()

        for line in lines:
            cl = line.line
            if not cl.formats:
                continue
            fmts = cl.formats
            text = cl.text
            for i, fmt in enumerate(fmts):
                if fmt.size_mode == SIZE_SMALL:
                    # small-size (ruby/furigana) fragments are not
                    # emitted in SRT (ref CaptionFormatter.hpp:267-270)
                    continue
                if line.end != prev_end:
                    push_line()
                    out.append(f"\n{sub_index}\n")
                    sub_index += 1
                    out.append(f"{self._time(line.start)} --> {self._time(line.end)}\n")
                    prev_end = line.end
                    prev_pos_y = -1.0
                if cl.pos_y != prev_pos_y:
                    push_line()
                    prev_pos_y = cl.pos_y
                begin = fmt.pos
                end = fmts[i + 1].pos if i + 1 < len(fmts) else len(text)
                linebuf.append(text[begin:end])
        push_line()
        return "".join(out)
