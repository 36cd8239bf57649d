"""PSI section assembly + table parsers (PAT/PMT/SDT/EIT/TDT/TOT).

Parity: PsiSection/PsiParser/PsiUpdatedDetector and the table structs in the
reference (Amatsukaze/Mpeg2TsParser.hpp:443-1092), including the MJD/BCD JST
time decode (:764-798) and the ARIB descriptors used for service/event names
and caption component tags.

The port's copy of amatsukaze_tpu/ts/psi.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.crc import crc32_mpeg2
from .packet import TsPacket


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

def parse_descriptors(data) -> list[tuple[int, memoryview]]:
    """Yield (tag, payload) pairs from a descriptor loop."""
    mv = memoryview(data)
    out = []
    off = 0
    while off + 2 <= len(mv):
        tag = mv[off]
        ln = mv[off + 1]
        if off + 2 + ln > len(mv):
            break
        out.append((tag, mv[off + 2 : off + 2 + ln]))
        off += 2 + ln
    return out


def parse_service_descriptor(payload) -> tuple[int, bytes, bytes] | None:
    """(service_type, provider_name, service_name) — ARIB-encoded bytes."""
    p = memoryview(payload)
    if len(p) < 3:
        return None
    service_type = p[0]
    lp = p[1]
    if 2 + lp + 1 > len(p):
        return None
    provider = bytes(p[2 : 2 + lp])
    ln = p[2 + lp]
    if 3 + lp + ln > len(p):
        return None
    name = bytes(p[3 + lp : 3 + lp + ln])
    return service_type, provider, name


def parse_short_event_descriptor(payload) -> tuple[bytes, bytes, bytes] | None:
    """(lang_code, event_name, text) — ARIB-encoded bytes."""
    p = memoryview(payload)
    if len(p) < 5:
        return None
    lang = bytes(p[0:3])
    le = p[3]
    if 4 + le + 1 > len(p):
        return None
    name = bytes(p[4 : 4 + le])
    lt = p[4 + le]
    if 5 + le + lt > len(p):
        return None
    text = bytes(p[5 + le : 5 + le + lt])
    return lang, name, text


def parse_stream_identifier(payload) -> int | None:
    p = memoryview(payload)
    return p[0] if len(p) == 1 else None


def parse_content_descriptor(payload) -> list[tuple[int, int, int, int]]:
    """ARIB genre nibbles: (level1, level2, user1, user2) per element."""
    p = memoryview(payload)
    out = []
    for off in range(0, len(p) - 1, 2):
        out.append((p[off] >> 4, p[off] & 0xF, p[off + 1] >> 4, p[off + 1] & 0xF))
    return out


# ---------------------------------------------------------------------------
# JST time (MJD + BCD)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class JSTTime:
    """40-bit ARIB time: 16-bit MJD + 24-bit BCD hhmmss (ref :764-798)."""

    time: int  # raw 40-bit value

    def get_day(self) -> tuple[int, int, int]:
        return self.mjd_to_ymd((self.time >> 24) & 0xFFFF)

    def get_time(self) -> tuple[int, int, int]:
        bcd = self.time & 0xFFFFFF
        h = ((bcd >> 20) & 0xF) * 10 + ((bcd >> 16) & 0xF)
        m = ((bcd >> 12) & 0xF) * 10 + ((bcd >> 8) & 0xF)
        s = ((bcd >> 4) & 0xF) * 10 + (bcd & 0xF)
        return h, m, s

    def to_datetime(self):
        import datetime

        y, mo, d = self.get_day()
        h, mi, se = self.get_time()
        try:
            return datetime.datetime(y, mo, d, h, mi, se)
        except ValueError:
            return None

    @staticmethod
    def mjd_to_ymd(mjd16: int) -> tuple[int, int, int]:
        # pre-2000 wrap handling matches the reference (:788)
        mjd = mjd16 + 65536 if mjd16 < 51544 else mjd16
        ydash = int((mjd - 15078.2) / 365.25)
        mdash = int((mjd - 14956.1 - int(ydash * 365.25)) / 30.6001)
        d = mjd - 14956 - int(ydash * 365.25) - int(mdash * 30.6001)
        k = 1 if mdash in (14, 15) else 0
        return ydash + k + 1900, mdash - 1 - k * 12, d

    @staticmethod
    def from_ymdhms(y: int, mo: int, d: int, h: int, mi: int, s: int) -> "JSTTime":
        # inverse of mjd_to_ymd for test/mux use
        l = 1 if mo in (1, 2) else 0
        mjd = 14956 + d + int((y - 1900 - l) * 365.25) + int((mo + 1 + l * 12) * 30.6001)
        bcd = (
            ((h // 10) << 20) | ((h % 10) << 16)
            | ((mi // 10) << 12) | ((mi % 10) << 8)
            | ((s // 10) << 4) | (s % 10)
        )
        return JSTTime(((mjd & 0xFFFF) << 24) | bcd)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

class PsiSection:
    """A complete PSI section (ref Mpeg2TsParser.hpp:565-616)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data

    @property
    def table_id(self) -> int:
        return self.data[0]

    @property
    def section_syntax_indicator(self) -> bool:
        return bool(self.data[1] & 0x80)

    @property
    def section_length(self) -> int:
        return ((self.data[1] & 0x0F) << 8) | self.data[2]

    @property
    def id(self) -> int:
        """table_id_extension: TSID for PAT, program_number for PMT, ..."""
        return int.from_bytes(self.data[3:5], "big")

    @property
    def version_number(self) -> int:
        return (self.data[5] >> 1) & 0x1F

    @property
    def current_next_indicator(self) -> bool:
        return bool(self.data[5] & 1)

    @property
    def section_number(self) -> int:
        return self.data[6]

    @property
    def last_section_number(self) -> int:
        return self.data[7]

    def parse(self) -> bool:
        return len(self.data) >= 3

    def check(self) -> bool:
        if len(self.data) != self.section_length + 3:
            return False
        if self.section_syntax_indicator:
            if crc32_mpeg2(self.data) != 0:
                return False
        return True

    def payload(self) -> memoryview:
        off = 8 if self.section_syntax_indicator else 3
        return memoryview(self.data)[off : len(self.data) - 4]

    def __eq__(self, o) -> bool:
        return isinstance(o, PsiSection) and bytes(self.data) == bytes(o.data)


class PAT:
    def __init__(self, section: PsiSection):
        self.section = section
        self.elems: list[tuple[int, int]] = []  # (program_number, PID)

    @property
    def tsid(self) -> int:
        return self.section.id

    def parse(self) -> bool:
        p = self.section.payload()
        self.elems = [
            (int.from_bytes(p[i : i + 2], "big"), int.from_bytes(p[i + 2 : i + 4], "big") & 0x1FFF)
            for i in range(0, len(p) - 3, 4)
        ]
        return True

    def check(self) -> bool:
        if self.section.table_id != 0x00:
            return False
        if not self.section.section_syntax_indicator:
            return False
        return len(self.section.payload()) % 4 == 0

    def programs(self) -> list[tuple[int, int]]:
        """(service_id, pmt_pid) pairs, network PID (program 0) excluded."""
        return [(num, pid) for num, pid in self.elems if num != 0]


@dataclass(frozen=True)
class PMTElement:
    stream_type: int
    elementary_pid: int
    descriptors: tuple  # ((tag, bytes), ...)

    def component_tag(self) -> int | None:
        for tag, payload in self.descriptors:
            if tag == 0x52:
                ct = parse_stream_identifier(payload)
                if ct is not None:
                    return ct
        return None


class PMT:
    def __init__(self, section: PsiSection):
        self.section = section
        self.pcr_pid = -1
        self.elems: list[PMTElement] = []

    @property
    def program_number(self) -> int:
        return self.section.id

    def parse(self) -> bool:
        p = self.section.payload()
        if len(p) < 4:
            return False
        self.pcr_pid = int.from_bytes(p[0:2], "big") & 0x1FFF
        info_len = int.from_bytes(p[2:4], "big") & 0xFFF
        off = 4 + info_len
        while off + 5 <= len(p):
            stype = p[off]
            epid = int.from_bytes(p[off + 1 : off + 3], "big") & 0x1FFF
            es_len = int.from_bytes(p[off + 3 : off + 5], "big") & 0xFFF
            descs = tuple(
                (t, bytes(pl)) for t, pl in parse_descriptors(p[off + 5 : off + 5 + es_len])
            )
            self.elems.append(PMTElement(stype, epid, descs))
            off += 5 + es_len
        return True

    def check(self) -> bool:
        return self.section.table_id == 0x02 and self.section.section_syntax_indicator


@dataclass(frozen=True)
class SDTService:
    service_id: int
    descriptors: tuple


class SDT:
    def __init__(self, section: PsiSection):
        self.section = section
        self.services: list[SDTService] = []

    @property
    def tsid(self) -> int:
        return self.section.id

    def parse(self) -> bool:
        p = self.section.payload()
        if len(p) < 3:
            return False
        self.original_network_id = int.from_bytes(p[0:2], "big")
        off = 3
        while off + 5 <= len(p):
            sid = int.from_bytes(p[off : off + 2], "big")
            dlen = int.from_bytes(p[off + 3 : off + 5], "big") & 0xFFF
            descs = tuple(
                (t, bytes(pl)) for t, pl in parse_descriptors(p[off + 5 : off + 5 + dlen])
            )
            self.services.append(SDTService(sid, descs))
            off += 5 + dlen
        return True

    def check(self) -> bool:
        return self.section.section_syntax_indicator


@dataclass(frozen=True)
class EITEvent:
    event_id: int
    start_time: JSTTime
    duration: int  # BCD-coded hhmmss
    descriptors: tuple


class EIT:
    def __init__(self, section: PsiSection):
        self.section = section
        self.events: list[EITEvent] = []

    @property
    def service_id(self) -> int:
        return self.section.id

    def parse(self) -> bool:
        p = self.section.payload()
        if len(p) < 6:
            return False
        off = 6
        while off + 12 <= len(p):
            eid = int.from_bytes(p[off : off + 2], "big")
            start = JSTTime(int.from_bytes(p[off + 2 : off + 7], "big"))
            dur = int.from_bytes(p[off + 7 : off + 10], "big")
            dlen = int.from_bytes(p[off + 10 : off + 12], "big") & 0xFFF
            descs = tuple(
                (t, bytes(pl)) for t, pl in parse_descriptors(p[off + 12 : off + 12 + dlen])
            )
            self.events.append(EITEvent(eid, start, dur, descs))
            off += 12 + dlen
        return True

    def check(self) -> bool:
        return True


class TDT:
    def __init__(self, section: PsiSection):
        self.section = section

    def jst_time(self) -> JSTTime:
        return JSTTime(int.from_bytes(self.section.data[3:8], "big"))

    def parse(self) -> bool:
        return len(self.section.data) >= 8

    def check(self) -> bool:
        return True


class TOT(TDT):
    def check(self) -> bool:
        # TOT has a CRC even though section_syntax_indicator is 0 (ref :825-829)
        if self.section.section_syntax_indicator:
            return False
        return crc32_mpeg2(self.section.data) == 0


# ---------------------------------------------------------------------------
# section assembly
# ---------------------------------------------------------------------------

class PsiParser:
    """Reassembles PSI sections from TS payloads (ref :896-964)."""

    def __init__(self, ctx=None):
        self.ctx = ctx
        self._buf = bytearray()
        self._clock = -1

    def clear(self) -> None:
        self._buf.clear()

    def on_ts_packet(self, clock: int, packet: TsPacket) -> None:
        if not packet.has_payload:
            return
        payload = packet.payload()
        if packet.payload_unit_start_indicator:
            start = payload[0] + 1  # pointer_field
            if start >= len(payload):
                return
            if start > 1:
                # tail of the previous section
                self._buf.extend(payload[1:start])
                self._check_and_out()
            self._buf.clear()
            self._clock = clock
            self._buf.extend(payload[start:])
            self._check_and_out()
        else:
            self._buf.extend(payload)
            self._check_and_out()

    def _check_and_out(self) -> None:
        while len(self._buf) >= 3:
            section_length = ((self._buf[1] & 0x0F) << 8) | self._buf[2]
            total = section_length + 3
            if len(self._buf) < total:
                return
            section = PsiSection(bytes(self._buf[:total]))
            if section.parse() and section.check():
                self.on_psi_section(self._clock, section)
            del self._buf[:total]
            # stuffing bytes (0xFF) terminate the packet's section run
            if self._buf and self._buf[0] == 0xFF:
                self._buf.clear()
                return

    # -- override -------------------------------------------------------------
    def on_psi_section(self, clock: int, section: PsiSection) -> None:
        raise NotImplementedError


class PsiUpdatedDetector(PsiParser):
    """Deduplicates identical sections (ref :966-986)."""

    def __init__(self, ctx=None):
        super().__init__(ctx)
        self._cur: bytes | None = None

    def on_psi_section(self, clock: int, section: PsiSection) -> None:
        if self._cur != section.data:
            self._cur = section.data
            self.on_table_updated(clock, section)

    def on_table_updated(self, clock: int, section: PsiSection) -> None:
        raise NotImplementedError
