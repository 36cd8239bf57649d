"""ARIB STD-B24 8-bit character decoding (service names, event info, captions).

Replaces AribString.hpp (reference, 1067 lines) and the character-decode part
of the vendored Caption.dll: G0-G3 set designation (ESC sequences), LS0/LS1/
SS2/SS3 invocation, 2-byte Kanji (JIS X 0208 + ARIB gaiji rows 85-94),
1-byte alphanumeric/hiragana/katakana (with half-width mapping), DRCS
placeholders, and the control codes that matter for text extraction.

The port's copy of amatsukaze_tpu/captions/arib.py.
"""

from __future__ import annotations

# final bytes of ARIB character set designations
SET_KANJI = 0x42  # 2-byte
SET_ALNUM = 0x4A
SET_HIRAGANA = 0x30
SET_KATAKANA = 0x31
SET_MOSAIC_A = 0x32
SET_MOSAIC_B = 0x33
SET_MOSAIC_C = 0x34
SET_MOSAIC_D = 0x35
SET_PROP_ALNUM = 0x36
SET_PROP_HIRAGANA = 0x37
SET_PROP_KATAKANA = 0x38
SET_JIS_X0201_KATAKANA = 0x49
SET_JIS_KANJI_1 = 0x39
SET_JIS_KANJI_2 = 0x3A
SET_ADDITIONAL_SYMBOLS = 0x3B
# DRCS finals: 0x40-0x4F (DRCS-0..15), macro 0x70

_TWO_BYTE_SETS = {SET_KANJI, SET_JIS_KANJI_1, SET_JIS_KANJI_2,
                  SET_ADDITIONAL_SYMBOLS, 0x40}

_HIRAGANA_TABLE = (
    "ぁあぃいぅうぇえぉおかがきぎく"
    "ぐけげこごさざしじすずせぜそぞた"
    "だちぢっつづてでとどなにぬねのは"
    "ばぱひびぴふぶぷへべぺほぼぽまみ"
    "むめもゃやゅゆょよらりるれろゎわ"
    "ゐゑをん   ゝゞー。「」、・"
)
_KATAKANA_TABLE = (
    "ァアィイゥウェエォオカガキギク"
    "グケゲコゴサザシジスズセゼソゾタ"
    "ダチヂッツヅテデトドナニヌネノハ"
    "バパヒビピフブプヘベペホボポマミ"
    "ムメモャヤュユョヨラリルレロヮワ"
    "ヰヱヲンヴヵヶヽヾー。「」、・"
)
# JIS X0201 katakana (half width), 0x21..0x5F
_X0201_KATAKANA = (
    "。「」、・ヲァィゥェォャュョッーアイウエオカキクケコサシスセソタチツテト"
    "ナニヌネノハヒフヘホマミムメモヤユヨラリルレロワン゙゚"
)

# a practical subset of ARIB additional symbols (gaiji), keyed by (row, cell)
_GAIJI = {
    (90, 48): "10.", (90, 49): "11.", (90, 50): "12.",
    (92, 25): "サ", (92, 26): "ス", (92, 27): "タ", (92, 28): "デ",
    (92, 29): "ニ", (92, 30): "初", (92, 31): "終", (92, 32): "生",
    (92, 33): "販", (92, 34): "声", (92, 35): "吹", (92, 36): "PP",
    (92, 37): "秘", (92, 38): "ほか", (92, 39): "字", (92, 40): "映",
    (92, 41): "多", (92, 42): "解", (92, 43): "SS", (92, 44): "B",
    (92, 45): "N", (92, 47): "天", (92, 48): "交", (92, 49): "映",
    (92, 50): "無", (92, 51): "料", (92, 54): "前", (92, 55): "後",
    (92, 56): "再", (92, 57): "新", (92, 58): "初", (92, 59): "終",
    (92, 60): "手", (92, 84): "HV", (92, 85): "SD",
    (93, 61): "→", (93, 62): "←", (93, 63): "↑", (93, 64): "↓",
    (93, 90): "♪",
    (94, 71): "℡",
}


def _decode_kanji(b1: int, b2: int) -> str:
    """JIS X 0208 row/cell -> str; ARIB gaiji for rows 85-94."""
    row, cell = b1 - 0x20, b2 - 0x20
    if row >= 85:
        return _GAIJI.get((row, cell), "〓")
    try:
        return bytes([b1 + 0x80, b2 + 0x80]).decode("euc_jp")
    except UnicodeDecodeError:
        return "〓"


class _CharSet:
    """A designated G-set. `drcs` is True only when the set was designated
    with the 0x20 intermediate byte (STD-B24 DRCS designation) — the final
    byte alone is ambiguous: DRCS-2/9/10 finals collide with Kanji (0x42),
    JIS X0201 katakana (0x49) and alnum (0x4A)."""

    def __init__(self, final: int, two_byte: bool, drcs: bool = False):
        self.final = final
        self.two_byte = two_byte
        self.drcs = drcs

    def decode(self, b1: int, b2: int = 0) -> str:
        f = self.final
        if self.drcs:
            return "□"  # DRCS placeholder (the bitmap path handles real DRCS)
        if f in (SET_KANJI, SET_JIS_KANJI_1, SET_JIS_KANJI_2,
                 SET_ADDITIONAL_SYMBOLS):
            return _decode_kanji(b1, b2)
        if f == SET_ALNUM or f == SET_PROP_ALNUM:
            return chr(b1)
        if f in (SET_HIRAGANA, SET_PROP_HIRAGANA):
            i = b1 - 0x21
            return _HIRAGANA_TABLE[i] if 0 <= i < len(_HIRAGANA_TABLE) else "?"
        if f in (SET_KATAKANA, SET_PROP_KATAKANA):
            i = b1 - 0x21
            return _KATAKANA_TABLE[i] if 0 <= i < len(_KATAKANA_TABLE) else "?"
        if f == SET_JIS_X0201_KATAKANA:
            i = b1 - 0x21
            return _X0201_KATAKANA[i] if 0 <= i < len(_X0201_KATAKANA) else "?"
        if f == SET_MOSAIC_A:
            return _mosaic_a(b1)
        if f in (SET_MOSAIC_B, SET_MOSAIC_C, SET_MOSAIC_D):
            # separated / line-drawing mosaic sets: no exact Unicode
            # counterpart; render a shade cell so layout advances
            return "▒"
        return ""


def _mosaic_a(c: int) -> str:
    """ARIB mosaic set A -> Unicode.

    The contiguous 2x3 block mosaics (columns 2-3 and 6-7) follow the
    videotex arrangement the set derives from (ITU-T T.101 / teletext
    G1): cells TL,TR,ML,MR,BL,BR are pattern bits 0..4 from the low
    code bits plus bit 5 from the 0x40 column bit. Unicode sextants
    (U+1FB00..U+1FB3B, Symbols for Legacy Computing) render these
    exactly, with the three classic exceptions encoded as half/full
    blocks. The 0x40-0x5F column (separated elements) renders as a
    shade cell. The reference's AribString marks mosaics non-drawable
    and drops them (AribString.hpp:30-33); rendering them is strictly
    more faithful for the rare mosaic captions.
    """
    if 0x21 <= c <= 0x3F or 0x60 <= c <= 0x7F:
        p = (c & 0x1F) | ((c & 0x40) >> 1)
        if p == 21:
            return "▌"  # left half block
        if p == 42:
            return "▐"  # right half block
        if p == 63:
            return "█"  # full block
        return chr(0x1FB00 + p - 1 - (p > 21) - (p > 42))
    if 0x40 <= c <= 0x5F:
        return "▒"
    return ""


# STD-B24 default macros (table 7-17): macro codes 0x60-0x6F expand to
# fixed designation/invocation sequences. Normative spec data — identical
# in any conforming decoder (the reference carries the same table,
# AribString.hpp:840-862).
SET_MACRO = 0x70
DEFAULT_MACROS = [
    b"\x1b\x24\x39\x1b\x29\x4a\x1b\x2a\x30\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x24\x39\x1b\x29\x31\x1b\x2a\x30\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x24\x39\x1b\x29\x20\x41\x1b\x2a\x30\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x32\x1b\x29\x34\x1b\x2a\x35\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x32\x1b\x29\x33\x1b\x2a\x35\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x32\x1b\x29\x20\x41\x1b\x2a\x35\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x20\x41\x1b\x29\x20\x42\x1b\x2a\x20\x43\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x20\x44\x1b\x29\x20\x45\x1b\x2a\x20\x46\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x20\x47\x1b\x29\x20\x48\x1b\x2a\x20\x49\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x20\x4a\x1b\x29\x20\x4b\x1b\x2a\x20\x4c\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x20\x4d\x1b\x29\x20\x4e\x1b\x2a\x20\x4f\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x24\x39\x1b\x29\x20\x42\x1b\x2a\x30\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x24\x39\x1b\x29\x20\x43\x1b\x2a\x30\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x24\x39\x1b\x29\x20\x44\x1b\x2a\x30\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x31\x1b\x29\x30\x1b\x2a\x4a\x1b\x2b\x20\x70\x0f\x1b\x7d",
    b"\x1b\x28\x4a\x1b\x29\x32\x1b\x2a\x20\x41\x1b\x2b\x20\x70\x0f\x1b\x7d",
]


class AribDecoder:
    """Stateful STD-B24 8-bit decoder.

    Initial designations: G0=Kanji, G1=Alnum, G2=Hiragana; GL=G0, GR=G2.
    G3 is the MACRO set for caption statements and Katakana for
    service/event strings — exactly the reference's bCaption split
    (AribString.hpp:179-183); a caption that invokes a default macro
    re-designates G0-G3 per STD-B24 table 7-17.
    """

    def __init__(self, caption: bool = False):
        self.g = [
            _CharSet(SET_KANJI, True),
            _CharSet(SET_ALNUM, False),
            _CharSet(SET_HIRAGANA, False),
            _CharSet(SET_MACRO if caption else SET_KATAKANA, False),
        ]
        self.gl = 0
        self.gr = 2
        self.single_shift: int | None = None
        self.drcs_hook = None  # callable(charset_final, code) -> str | None

    def _char(self, cs: "_CharSet", b1: int, b2: int = 0) -> str:
        """One character through `cs`; DRCS charsets consult drcs_hook
        (md5-mapped replacement text, ref CaptionData.hpp:416-445) and
        fall back to the placeholder glyph."""
        if cs.drcs and self.drcs_hook is not None:
            code = ((b1 << 8) | b2) if cs.two_byte else b1
            rep = self.drcs_hook(cs.final, code)
            if rep is not None:
                return rep
        return cs.decode(b1, b2)

    # -- ESC designation handling --------------------------------------------
    def _escape(self, data: bytes, pos: int) -> int:
        """Process an ESC sequence at data[pos] (after the ESC byte);
        returns bytes consumed."""
        if pos >= len(data):
            return 0
        b = data[pos]
        if b == 0x6E:  # LS2
            self.gl = 2
            return 1
        if b == 0x6F:  # LS3
            self.gl = 3
            return 1
        if b == 0x7E:  # LS1R
            self.gr = 1
            return 1
        if b == 0x7D:  # LS2R
            self.gr = 2
            return 1
        if b == 0x7C:  # LS3R
            self.gr = 3
            return 1
        # designation: ESC 0x28-0x2B F (1-byte) / ESC 0x24 [0x28-0x2B] F (2-byte)
        if 0x28 <= b <= 0x2B:
            if pos + 1 < len(data):
                nxt = data[pos + 1]
                if nxt == 0x20 and pos + 2 < len(data):  # DRCS
                    fin = data[pos + 2]
                    self.g[b - 0x28] = _CharSet(fin, False,
                                                drcs=(fin != SET_MACRO))
                    return 3
                self.g[b - 0x28] = _CharSet(nxt, False)
                return 2
            return 1
        if b == 0x24:
            if pos + 1 < len(data):
                nxt = data[pos + 1]
                if 0x28 <= nxt <= 0x2B and pos + 2 < len(data):
                    if data[pos + 2] == 0x20 and pos + 3 < len(data):  # 2-byte DRCS
                        self.g[nxt - 0x28] = _CharSet(data[pos + 3], True,
                                                      drcs=True)
                        return 4
                    self.g[nxt - 0x28] = _CharSet(data[pos + 2], True)
                    return 3
                self.g[0] = _CharSet(nxt, True)
                return 2
            return 1
        return 1

    # -- main ------------------------------------------------------------------
    def decode(self, data: bytes, control_hook=None) -> str:
        """Decode a byte string to text. control_hook(code, params) receives
        CSI/other control codes (position, colour) for layout-aware callers.
        During decode `self.emitted` counts output characters so far, so
        hooks can anchor per-span formats to text positions."""
        self.emitted = 0
        out = _CountingOut(self)
        i = 0
        n = len(data)
        while i < n:
            b = data[i]
            if b == 0x1B:  # ESC
                i += 1 + self._escape(data, i + 1)
                continue
            if b == 0x0F:  # LS0
                self.gl = 0
                i += 1
                continue
            if b == 0x0E:  # LS1
                self.gl = 1
                i += 1
                continue
            if b == 0x19:  # SS2
                self.single_shift = 2
                i += 1
                continue
            if b == 0x1D:  # SS3
                self.single_shift = 3
                i += 1
                continue
            if b == 0x20:  # SP
                out.append(" ")
                i += 1
                continue
            if b == 0x7F or b < 0x20:  # DEL + C0 controls
                consumed = self._control(data, i, out, control_hook)
                i += consumed
                continue
            if 0x80 <= b <= 0x9F:  # C1 controls
                i += self._c1(data, i, hook=control_hook)
                continue
            if b == 0xA0:
                out.append(" ")
                i += 1
                continue
            if 0xA1 <= b <= 0xFE or b == 0xFF:  # GR
                cs = self.g[self.gr]
                if cs.final == SET_MACRO:
                    i += self._macro(b & 0x7F)
                    continue
                if cs.two_byte and i + 1 < n:
                    out.append(self._char(cs, b & 0x7F, data[i + 1] & 0x7F))
                    i += 2
                else:
                    out.append(self._char(cs, b & 0x7F))
                    i += 1
                continue
            # GL region 0x21-0x7E
            idx = self.single_shift if self.single_shift is not None else self.gl
            self.single_shift = None
            cs = self.g[idx]
            if cs.final == SET_MACRO:
                i += self._macro(b)
                continue
            if cs.two_byte and i + 1 < n:
                out.append(self._char(cs, b, data[i + 1]))
                i += 2
            else:
                out.append(self._char(cs, b))
                i += 1
        return "".join(out)

    def _macro(self, code: int) -> int:
        """Execute a default macro (STD-B24 table 7-17): the expansion is
        a pure designation/invocation sequence run through the decoder
        state (ref PutMacroChar, AribString.hpp:840-862)."""
        if 0x60 <= code <= 0x6F:
            saved = getattr(self, "emitted", 0)
            self.decode(DEFAULT_MACROS[code & 0x0F])
            self.emitted = saved  # nested decode resets the counter
        return 1

    def _control(self, data: bytes, i: int, out: list, hook) -> int:
        """C0/C1-ish control codes inside caption statements; returns bytes
        consumed. Text-relevant ones map to whitespace/newlines."""
        b = data[i]
        if b == 0x0D:  # APR - new line
            out.append("\n")
            return 1
        if b == 0x09:  # APF - forward = space
            out.append(" ")
            return 1
        if b == 0x0C:  # CS - clear screen
            if hook:
                hook("CS", b"")
            return 1
        if b == 0x16:  # PAPF: 1 param
            return 2
        if b == 0x1C:  # APS: 2 params (row, col)
            if hook and i + 2 < len(data):
                hook("APS", data[i + 1 : i + 3])
            if out and out[-1] != "\n":
                out.append("\n")
            return 3
        if b == 0x0B:  # APU
            return 1
        if b == 0x0A:  # APD
            out.append("\n")
            return 1
        if b == 0x08:  # APB
            return 1
        return 1


    def _c1(self, data: bytes, i: int, hook=None) -> int:
        """C1 control codes (colour/size/position extensions). Returns bytes
        consumed; colour codes 0x80-0x87 are foreground-colour selectors."""
        b = data[i]
        if 0x80 <= b <= 0x87:  # BKF..WHF foreground colours
            if hook:
                hook("COL", bytes([b & 0x07]))
            return 1
        if b == 0x88:  # SSZ small
            if hook:
                hook("SSZ", b"")
            return 1
        if b == 0x89:  # MSZ medium (half width)
            if hook:
                hook("MSZ", b"")
            return 1
        if b == 0x8A:  # NSZ normal
            if hook:
                hook("NSZ", b"")
            return 1
        if b == 0x8B:  # SZX: 1 param
            return 2
        if b == 0x90:  # COL: 1-2 params
            if i + 1 < len(data) and data[i + 1] == 0x20:
                return 3
            if hook and i + 1 < len(data):
                # full param byte: 0x48-4F fg, 0x50-57 bg, 0x58-5F
                # half-fg, 0x60-67 half-bg (STD-B24 table 7-14)
                hook("COL", bytes([data[i + 1]]))
            return 2
        if b == 0x91:  # FLC: 1 param
            return 2
        if b == 0x93:  # POL: 1 param
            return 2
        if b == 0x94:  # WMM: 1 param
            return 2
        if b == 0x95:  # MACRO until 0x4F terminator
            j = i + 1
            while j < len(data) and data[j] != 0x4F:
                j += 1
            return j - i + 1
        if b == 0x97:  # HLC: 1 param
            return 2
        if b == 0x98:  # RPC: 1 param
            return 2
        if b == 0x9B:  # CSI: params until final byte 0x40-0x6F
            j = i + 1
            while j < len(data) and not (0x40 <= data[j] <= 0x6F):
                j += 1
            if hook and j < len(data):
                hook("CSI", data[i + 1 : j + 1])
            return j - i + 1
        if b == 0x9A:  # STL - start lining (underline)
            if hook:
                hook("STL", b"")
            return 1
        if b == 0x99:  # SPL - stop lining
            if hook:
                hook("SPL", b"")
            return 1
        if b == 0x9D:  # TIME: 0x20 + wait param (units of 0.1 s)
            if i + 1 < len(data) and data[i + 1] == 0x28:
                # time-control variant 0x9D 0x28 P... F: parameters run
                # until a final byte 0x40-0x43 (STD-B24 table 7-16);
                # consume them so they are not decoded as text.
                j = i + 2
                while j < len(data) and not (0x40 <= data[j] <= 0x43):
                    j += 1
                return j - i + 1
            if (hook and i + 2 < len(data) and data[i + 1] == 0x20):
                hook("TIME", bytes([data[i + 2]]))
            return 3
        return 1


class _CountingOut(list):
    """Output accumulator that keeps the decoder's emitted-character
    count in sync so control hooks can anchor formats to positions."""

    def __init__(self, dec: AribDecoder):
        super().__init__()
        self._dec = dec

    def append(self, s: str) -> None:
        super().append(s)
        self._dec.emitted += len(s)


def decode_arib_string(data: bytes) -> str:
    """One-shot decode for service/event names (ref CAribString usage)."""
    return AribDecoder().decode(bytes(data))
