"""ARIB STD-B24 caption PES parsing -> CaptionItem stream.

Replaces the vendored TVCaptionMod2 Caption.dll + the wrapper in the
reference (CaptionData.hpp:36-478): data-group/ data-unit parsing, caption
management (languages, clear timing), caption statements decoded through
captions.arib, plane sizing from the SWF mode, char size modes, and DRCS
gaiji handling (MD5 of the bitmap pattern, mapped via AMTContext's drcs map;
unmapped ones are written out as BMPs + counted as AMT_ERR_NO_DRCS_MAP,
ref CaptionData.hpp:170-255, :374-445).

The port's copy of amatsukaze_tpu/captions/b24.py.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field, replace

from ..utils.context import ErrorCounter
from .arib import AribDecoder


@dataclass
class CaptionFormat:
    """Per-span style (ref CaptionData.hpp:37-96)."""

    pos: int = 0
    char_w: float = 36.0
    char_h: float = 36.0
    width: float = 36.0
    height: float = 36.0
    text_color: tuple = (255, 255, 255, 255)
    back_color: tuple = (0, 0, 0, 128)
    style: int = 0
    size_mode: int = 2  # 0=small 1=medium 2=normal (decoder starts NSZ)


@dataclass
class CaptionLine:
    text: str = ""
    plane_w: int = 960
    plane_h: int = 540
    pos_x: float = 0.0
    pos_y: float = 0.0
    formats: list = field(default_factory=list)


@dataclass
class CaptionItem:
    pts: int = 0
    lang_index: int = 0
    wait_time: int = 0  # ms
    line: CaptionLine | None = None  # None = clear


@dataclass
class DRCSOutInfo:
    elapsed: float = 0.0
    filename: str = ""


# ARIB colour map (CLUT index -> RGBA), first 8 entries
CLUT = [
    (0, 0, 0, 255), (255, 0, 0, 255), (0, 255, 0, 255), (255, 255, 0, 255),
    (0, 0, 255, 255), (255, 0, 255, 255), (0, 255, 255, 255), (255, 255, 255, 255),
]

# SWF (caption display format) -> plane size
_SWF_PLANES = {0: (960, 540), 2: (960, 540), 7: (960, 540), 9: (720, 480),
               11: (1280, 720)}

# STD-B24 table 8-7 common CLUT, first 16 entries: 8 full-intensity
# colours, transparent, 7 half-intensity colours (RGBA)
_ARIB_CLUT = (
    (0, 0, 0, 255), (255, 0, 0, 255), (0, 255, 0, 255), (255, 255, 0, 255),
    (0, 0, 255, 255), (255, 0, 255, 255), (0, 255, 255, 255),
    (255, 255, 255, 255),
    (0, 0, 0, 0), (170, 0, 0, 255), (0, 170, 0, 255), (170, 170, 0, 255),
    (0, 0, 170, 255), (170, 0, 170, 255), (0, 170, 170, 255),
    (170, 170, 170, 255),
)

# CSI SWF writing-format parameter -> plane (STD-B24 table 7-8)
_CSI_SWF_PLANES = {5: (1920, 1080), 7: (960, 540), 9: (720, 480),
                   11: (1280, 720)}


def _parse_csi(params: bytes) -> tuple[list[int], int]:
    """CSI body: ASCII-digit params separated by 0x3B, optional 0x20
    intermediate, final byte last. Returns (numbers, final)."""
    final = params[-1]
    body = params[:-1].rstrip(b"\x20")
    nums = []
    for part in body.split(b"\x3B"):
        digits = bytes(b for b in part if 0x30 <= b <= 0x39)
        if digits:
            nums.append(int(digits))
    return nums, final


def _make_format(cur: dict, pos: int) -> "CaptionFormat":
    # size modes scale the SSM cell (0=small halves both dims,
    # 1=medium halves width; ref CaptionData.hpp:293-323)
    w = cur["cw"] * (0.5 if cur["size"] in (0, 1) else 1.0)
    h = cur["ch"] * (0.5 if cur["size"] == 0 else 1.0)
    return CaptionFormat(pos=pos, char_w=w, char_h=h, width=w, height=h,
                         text_color=cur["fg"], back_color=cur["bg"],
                         style=cur.get("style", 0), size_mode=cur["size"])


def drcs_md5(width: int, height: int, depth: int, pattern: bytes) -> str:
    """MD5 over a normalised 1-bit-per-pixel bitmap (ref CalcMD5FromDRCSPattern,
    CaptionData.hpp:170-205): gradation patterns binarise at >= half level."""
    threshold = max(1, (depth + 1) // 2) if depth > 2 else 1
    bits_per_px = 1 if depth <= 2 else 2 if depth <= 4 else 4
    out = bytearray((width * height + 7) // 8)
    bitpos = 0
    for y in range(height):
        for x in range(width):
            idx = y * width + x
            bo = idx * bits_per_px
            byte = pattern[bo // 8] if bo // 8 < len(pattern) else 0
            shift = 8 - (bo % 8) - bits_per_px
            level = (byte >> shift) & ((1 << bits_per_px) - 1)
            if level >= threshold:
                out[bitpos // 8] |= 0x80 >> (bitpos % 8)
            bitpos += 1
    return hashlib.md5(bytes([width, height]) + bytes(out)).hexdigest()


class CaptionDecoder:
    """Decode caption PES payloads into CaptionItem lists.

    Plugs into ts.splitter.CaptionPesParser as `caption_decoder`:
    decode(pts, payload) -> [CaptionItem].
    """

    def __init__(self, ctx, drcs_out_dir: str = ""):
        self.ctx = ctx
        self.drcs_out_dir = drcs_out_dir
        self.languages: list[int] = []  # language tags from management data
        self._drcs_map: dict[str, str] = {}  # md5 -> replacement (per stream)
        self._drcs_codes: dict[tuple[int, int], str] = {}  # (final, code) -> md5
        self.plane = (960, 540)

    # -- entry ---------------------------------------------------------------
    def decode(self, pts: int, payload: bytes) -> list[CaptionItem]:
        # PES data packet: data_identifier, private_stream_id, PES_data_len
        if len(payload) < 3:
            return []
        if payload[0] not in (0x80,):  # synchronized PES data (captions)
            return []
        header_len = payload[2] & 0x0F
        pos = 3 + header_len
        return self._data_group(pts, payload[pos:])

    def _data_group(self, pts: int, data: bytes) -> list[CaptionItem]:
        if len(data) < 5:
            return []
        group_id = (data[0] >> 2) & 0x3F
        size = (data[3] << 8) | data[4]
        body = data[5 : 5 + size]
        # group 0x0 / 0x20 = management; 0x1-0x8 / 0x21-0x28 = statements
        gid = group_id & 0x1F
        if gid == 0:
            self._management(body)
            return []
        lang_index = gid - 1
        return self._statement(pts, lang_index, body)

    def _management(self, body: bytes) -> None:
        if len(body) < 2:
            return
        tmd = (body[0] >> 6) & 3
        pos = 1
        if tmd == 0b10:  # OTM present
            pos += 5
        if pos >= len(body):
            return
        num_languages = body[pos]
        pos += 1
        self.languages = []
        for _ in range(num_languages):
            if pos + 1 > len(body):
                break
            dmf = body[pos] & 0x0F
            pos += 1
            if dmf in (0b1100, 0b1101, 0b1110):
                pos += 1  # DC
            self.languages.append(pos)
            pos += 3  # ISO language code
            if pos < len(body):
                fmt = body[pos] >> 4
                self.plane = _SWF_PLANES.get(fmt, (960, 540))
                pos += 1

    def _statement(self, pts: int, lang_index: int, body: bytes) -> list[CaptionItem]:
        if len(body) < 4:
            return []
        tmd = (body[0] >> 6) & 3
        pos = 1
        wait_time = 0
        if tmd in (0b01, 0b10):
            # STM: 36-bit BCD time (9 nibbles + 4 reserved)
            pos += 5
        if pos + 3 > len(body):
            return []
        unit_len = (body[pos] << 16) | (body[pos + 1] << 8) | body[pos + 2]
        pos += 3
        units_end = min(len(body), pos + unit_len)
        items: list[CaptionItem] = []
        while pos + 5 <= units_end:
            if body[pos] != 0x1F:  # unit_separator
                break
            unit_parameter = body[pos + 1]
            du_size = (body[pos + 2] << 16) | (body[pos + 3] << 8) | body[pos + 4]
            du = body[pos + 5 : pos + 5 + du_size]
            pos += 5 + du_size
            if unit_parameter == 0x20:  # statement body
                items.extend(self._statement_body(pts, lang_index, wait_time, du))
            elif unit_parameter in (0x30, 0x31):  # DRCS
                self._drcs_unit(pts, du, two_byte=(unit_parameter == 0x31))
        return items

    def _statement_body(self, pts, lang_index, wait_time, du) -> list[CaptionItem]:
        # SWF is scoped to this statement: it starts from the
        # management-data plane and a CSI SWF only affects the current
        # statement's layout (Caption.dll resets from management data).
        state = {"clear": False, "aps": [], "wait_ms": 0,
                 "plane": self.plane}
        dec = AribDecoder(caption=True)
        dec.drcs_hook = self._drcs_lookup
        # region/cell layout defaults (STD-B24 profile A, stated for the
        # 960x540 plane: display area at (170,30), 36x36 chars with
        # 4px/24px spacing) scale with the active plane; updated by
        # CSI SDP/SSM/SHS/SVS. `explicit` tracks which were set by CSI so
        # an SWF plane switch rescales only the still-default metrics.
        s = state["plane"][0] / 960.0
        cur = {"fg": (255, 255, 255, 255), "bg": (0, 0, 0, 128), "size": 2,
               "cw": 36.0 * s, "ch": 36.0 * s, "style": 0}
        layout = {"sdp": [170.0 * s, 30.0 * s], "shs": 4.0 * s,
                  "svs": 24.0 * s, "explicit": set()}
        fmts: list[CaptionFormat] = [_make_format(cur, 0)]

        def push():
            f = _make_format(cur, dec.emitted)
            if fmts[-1].pos == f.pos:
                fmts[-1] = f
            else:
                fmts.append(f)

        def hook(code, params):
            if code == "CS":
                state["clear"] = True
            elif code == "APS" and len(params) >= 2:
                # capture the grid metrics at APS time from the UNSCALED
                # SSM dims (size modes scale glyphs, not the pen grid)
                state["aps"].append((params[0] & 0x3F, params[1] & 0x3F,
                                     cur["cw"] + layout["shs"],
                                     cur["ch"] + layout["svs"],
                                     layout["sdp"][0], layout["sdp"][1],
                                     dec.emitted))
            elif code == "CSI" and params:
                nums, final = _parse_csi(params)
                if final == 0x5F and len(nums) >= 2:  # SDP: area origin
                    layout["sdp"] = [float(nums[0]), float(nums[1])]
                    layout["explicit"].add("sdp")
                elif final == 0x57 and len(nums) >= 2:  # SSM: char dims
                    cur["cw"], cur["ch"] = float(nums[0]), float(nums[1])
                    layout["explicit"].add("ssm")
                    push()
                elif final == 0x58 and nums:  # SHS: horizontal spacing
                    layout["shs"] = float(nums[0])
                    layout["explicit"].add("shs")
                elif final == 0x59 and nums:  # SVS: vertical spacing
                    layout["svs"] = float(nums[0])
                    layout["explicit"].add("svs")
                elif final == 0x53 and nums:  # SWF: writing format
                    new_plane = _CSI_SWF_PLANES.get(nums[0])
                    if new_plane and new_plane != state["plane"]:
                        state["plane"] = new_plane
                        ns = new_plane[0] / 960.0
                        if "sdp" not in layout["explicit"]:
                            layout["sdp"] = [170.0 * ns, 30.0 * ns]
                        if "shs" not in layout["explicit"]:
                            layout["shs"] = 4.0 * ns
                        if "svs" not in layout["explicit"]:
                            layout["svs"] = 24.0 * ns
                        if "ssm" not in layout["explicit"]:
                            cur["cw"] = cur["ch"] = 36.0 * ns
                            push()
                elif final == 0x64 and nums:  # MDF: bold/italic
                    cur["style"] = (cur["style"] & 1) | {
                        0: 0, 1: 4, 2: 8, 3: 12}.get(nums[0], 0)
                    push()
            elif code == "COL" and params:
                v = params[0]
                if v < 8:  # C1 BKF..WHF foreground
                    cur["fg"] = _ARIB_CLUT[v]
                elif 0x48 <= v <= 0x4F:  # COL foreground, palette row 1
                    cur["fg"] = _ARIB_CLUT[8 + (v & 7)]
                elif 0x50 <= v <= 0x57:  # COL background
                    cur["bg"] = _ARIB_CLUT[v & 7]
                elif 0x58 <= v <= 0x5F:  # half-fg -> half-intensity row
                    cur["fg"] = _ARIB_CLUT[8 + (v & 7)]
                elif 0x60 <= v <= 0x67:  # half-bg
                    cur["bg"] = _ARIB_CLUT[8 + (v & 7)]
                push()
            elif code in ("SSZ", "MSZ", "NSZ"):
                cur["size"] = {"SSZ": 0, "MSZ": 1, "NSZ": 2}[code]
                push()
            elif code == "STL":
                cur["style"] |= 1  # UNDERLINE (ref CaptionData.hpp:39)
                push()
            elif code == "SPL":
                cur["style"] &= ~1
                push()
            elif code == "TIME" and params:
                # display-delay accumulation, 0.1 s units
                # (ref Caption.dll dwWaitTime semantics)
                state["wait_ms"] += (params[0] - 0x40) * 100

        text = dec.decode(bytes(du), control_hook=hook)
        items = []
        if state["clear"]:
            items.append(CaptionItem(pts=pts, lang_index=lang_index,
                                     wait_time=wait_time + state["wait_ms"],
                                     line=None))
        # One CaptionLine per APS-positioned run (the reference DLL
        # yields one CAPTION_CHAR_DATA line per positioned run,
        # CaptionData.hpp:36-96) — ruby rows are separate lines above
        # their base text, each with its own pen position. Text before
        # the first APS forms an unpositioned line.
        aps_list = state["aps"]
        if not aps_list:
            segments = [(None, 0, len(text))]
        else:
            segments = []
            if aps_list[0][-1] > 0:
                segments.append((None, 0, aps_list[0][-1]))
            for i, a in enumerate(aps_list):
                end = (aps_list[i + 1][-1] if i + 1 < len(aps_list)
                       else len(text))
                segments.append((a, a[-1], end))
        w, h = state["plane"]
        for aps, s, e in segments:
            raw = text[s:e]
            lead = len(raw) - len(raw.lstrip("\n"))
            seg_text = raw.strip("\n")
            if not seg_text:
                continue
            # spans overlapping [s, e): the latest span at/before the
            # segment start carries in at pos 0; later ones rebase
            formats: list[CaptionFormat] = []
            for f in fmts:
                if f.pos >= e:
                    continue
                g = replace(f, pos=max(0, f.pos - s - lead))
                if g.pos >= len(seg_text):
                    continue
                if formats and formats[-1].pos == g.pos:
                    formats[-1] = g
                else:
                    formats.append(g)
            # width/height are SPAN extents (the formatter derives
            # per-char advance as width/len(frag)): chars * cell size
            for i, f in enumerate(formats):
                end = (formats[i + 1].pos if i + 1 < len(formats)
                       else len(seg_text))
                f.width = f.char_w * max(1, end - f.pos)
                f.height = f.char_h
            pos_x = pos_y = 0.0
            if aps:
                # pen position: display-area origin + cell-metric grid
                # (char cell = SSM dims + SHS/SVS spacing, captured at
                # APS time; y is the row BOTTOM, matching the
                # Alignment=1 \pos convention)
                row, col, cell_w, cell_h, ox, oy, _off = aps
                pos_x = ox + col * cell_w
                pos_y = oy + (row + 1) * cell_h
            line = CaptionLine(
                text=seg_text, plane_w=w, plane_h=h,
                pos_x=pos_x, pos_y=pos_y,
                formats=formats or [CaptionFormat(pos=0)],
            )
            items.append(CaptionItem(pts=pts, lang_index=lang_index,
                                     wait_time=wait_time + state["wait_ms"],
                                     line=line))
        return items

    # -- DRCS ------------------------------------------------------------------
    def _drcs_unit(self, pts, du, two_byte: bool) -> None:
        if not du:
            return
        num = du[0]
        pos = 1
        for _ in range(num):
            if pos + 3 > len(du):
                return
            # CharacterCode is 16 bits for BOTH unit kinds (STD-B24
            # Fig. 9-3): for the 1-byte DRCS-1..15 sets the high byte is
            # the charset final (0x41-0x4F), for DRCS-0 it is the
            # two-byte code itself
            cc1, cc2 = du[pos], du[pos + 1]
            pos += 2
            if two_byte:
                code_key = (0x40, ((cc1 & 0x7F) << 8) | (cc2 & 0x7F))
            else:
                code_key = (cc1 & 0x7F, cc2 & 0x7F)
            if pos >= len(du):
                return
            num_font = du[pos]
            pos += 1
            for _ in range(num_font):
                if pos + 4 > len(du):
                    return
                mode = du[pos] & 0x0F
                pos += 1
                if mode in (0, 1):  # bitmap
                    depth, width, height = du[pos], du[pos + 1], du[pos + 2]
                    pos += 3
                    bits = 1 if depth <= 2 else 2 if depth <= 4 else 4
                    nbytes = (width * height * bits + 7) // 8
                    pattern = bytes(du[pos : pos + nbytes])
                    pos += nbytes
                    md5 = drcs_md5(width, height, depth, pattern)
                    self._drcs_codes[code_key] = md5
                    mapping = self.ctx.get_drcs_mapping(md5)
                    if mapping is None:
                        self.ctx.incr(ErrorCounter.NO_DRCS_MAP)
                        self._save_unmapped(md5, width, height, pattern, bits)
                    else:
                        self._drcs_map[md5] = mapping
                else:  # geometric: skip
                    return

    def _drcs_lookup(self, charset_final: int, code: int) -> str | None:
        """Replacement text for a previously-downloaded DRCS glyph: the
        (charset, code) pair resolves to the glyph's md5, which the user
        mapping (drcs_map.txt / AMTContext) turns into text
        (ref CaptionData.hpp:416-445 SetDRCSReplace path)."""
        md5 = self._drcs_codes.get((charset_final, code))
        if md5 is None:
            return None
        rep = self._drcs_map.get(md5)
        if rep is None:
            rep = self.ctx.get_drcs_mapping(md5)
            if rep is not None:
                self._drcs_map[md5] = rep
        return rep

    def _save_unmapped(self, md5, width, height, pattern, bits) -> None:
        """Write the unmapped DRCS as a BMP for the GUI mapping flow
        (ref CaptionData.hpp:374-445)."""
        if not self.drcs_out_dir:
            return
        os.makedirs(self.drcs_out_dir, exist_ok=True)
        path = os.path.join(self.drcs_out_dir, f"{md5}.bmp")
        if os.path.exists(path):
            return
        row_bytes = (width + 31) // 32 * 4
        img = bytearray(row_bytes * height)
        for y in range(height):
            for x in range(width):
                bo = (y * width + x) * bits
                byte = pattern[bo // 8] if bo // 8 < len(pattern) else 0
                shift = 8 - (bo % 8) - bits
                if (byte >> shift) & ((1 << bits) - 1):
                    dst = (height - 1 - y) * row_bytes + x // 8
                    img[dst] |= 0x80 >> (x % 8)
        header = bytearray(62)
        header[0:2] = b"BM"
        size = 62 + len(img)
        header[2:6] = size.to_bytes(4, "little")
        header[10:14] = (62).to_bytes(4, "little")
        header[14:18] = (40).to_bytes(4, "little")
        header[18:22] = width.to_bytes(4, "little")
        header[22:26] = height.to_bytes(4, "little")
        header[26:28] = (1).to_bytes(2, "little")
        header[28:30] = (1).to_bytes(2, "little")
        header[46:50] = (2).to_bytes(4, "little")
        header[54:58] = bytes([0, 0, 0, 0])
        header[58:62] = bytes([255, 255, 255, 0])
        with open(path, "wb") as f:
            f.write(header + img)
