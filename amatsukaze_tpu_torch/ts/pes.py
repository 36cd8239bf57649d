"""PES packet view + assembly from TS payloads.

Parity: PESConstantHeader / PESPacket / PesParser in the reference
(Amatsukaze/Mpeg2TsParser.hpp:121-432): header validation including the
marker/fixed bits, optional-field length accounting, 33-bit PTS/DTS
read/rewrite, and the continuity-counter-gated assembly buffer.

The port's copy of amatsukaze_tpu/ts/pes.py.
"""

from __future__ import annotations

from .packet import TsPacket


def read_timestamp(b) -> int:
    """33-bit PTS/DTS from the 5-byte PES encoding."""
    raw = int.from_bytes(b[:5], "big")
    return (((raw >> 33) & 0x7) << 30) | (((raw >> 17) & 0x7FFF) << 15) | ((raw >> 1) & 0x7FFF)


def write_timestamp(ts: int, prefix: int = 0x3) -> bytes:
    """Encode a 33-bit timestamp; prefix is the 4-bit '0010'/'0011' marker."""
    raw = (
        (prefix << 36)
        | (((ts >> 30) & 0x7) << 33)
        | (1 << 32)
        | (((ts >> 15) & 0x7FFF) << 17)
        | (1 << 16)
        | ((ts & 0x7FFF) << 1)
        | 1
    )
    return raw.to_bytes(5, "big")


class PESPacket:
    """A complete PES packet (header + payload) over a byte buffer."""

    __slots__ = ("data", "pts", "dts", "payload_offset")

    def __init__(self, data):
        self.data = bytearray(data) if not isinstance(data, (bytearray, memoryview)) else data
        self.pts = -1
        self.dts = -1
        self.payload_offset = 0

    # -- constant header -----------------------------------------------------
    @property
    def packet_start_code_prefix(self) -> int:
        return int.from_bytes(self.data[0:3], "big")

    @property
    def stream_id(self) -> int:
        return self.data[3]

    @property
    def pes_packet_length(self) -> int:
        return int.from_bytes(self.data[4:6], "big")

    @property
    def pts_dts_flags(self) -> int:
        return (self.data[7] >> 6) & 3

    @property
    def has_pts(self) -> bool:
        return bool(self.pts_dts_flags & 2)

    @property
    def has_dts(self) -> bool:
        return bool(self.pts_dts_flags & 1)

    @property
    def pes_header_data_length(self) -> int:
        return self.data[8]

    def parse(self) -> bool:
        d = self.data
        if len(d) < 9:
            return False
        if d[3] == 0xBF:  # private_stream_2: no optional header
            return False
        # optional-field length accounting (ref Mpeg2TsParser.hpp:166-199)
        flags2 = d[7]
        need = 0
        if flags2 & 0x80:
            need += 5  # PTS
        if flags2 & 0x40:
            need += 5  # DTS
        if flags2 & 0x20:
            need += 6  # ESCR
        if flags2 & 0x10:
            need += 3  # ES_rate
        if flags2 & 0x08:
            need += 1  # DSM trick mode
        if flags2 & 0x04:
            need += 1  # additional copy info
        if flags2 & 0x02:
            need += 2  # PES CRC
        if flags2 & 0x01:
            need += 1  # PES extension
        if self.pes_header_data_length < need:
            return False
        pos = 9
        if flags2 & 0x80:
            self.pts = read_timestamp(d[pos : pos + 5])
            pos += 5
        if flags2 & 0x40:
            self.dts = read_timestamp(d[pos : pos + 5])
            pos += 5
        self.payload_offset = 9 + self.pes_header_data_length
        return True

    def check(self) -> bool:
        d = self.data
        if self.packet_start_code_prefix != 0x000001:
            return False
        if (d[6] & 0xC0) != 0x80:  # '10' fixed bits
            return False
        if self.pts_dts_flags == 0x01:
            return False  # forbidden
        if self.payload_offset >= len(d):
            return False
        plen = self.pes_packet_length
        if plen != 0 and plen + 6 != len(d):
            return False
        return True

    def payload(self):
        return memoryview(self.data)[self.payload_offset :]

    # -- in-place rewrites (used by the PS writer) -----------------------------
    def change_timestamp(self, pts: int, dts: int) -> None:
        pos = 9
        if self.has_pts:
            prefix = 0x3 if self.has_dts else 0x2
            self.data[pos : pos + 5] = write_timestamp(pts, prefix)
            pos += 5
        if self.has_dts:
            self.data[pos : pos + 5] = write_timestamp(dts, 0x1)
        self.pts, self.dts = pts, dts

    def change_stream_id(self, sid: int) -> None:
        self.data[3] = sid

    def write_packet_length(self) -> None:
        self.data[4:6] = (len(self.data) - 6).to_bytes(2, "big")


class PesParser:
    """Reassemble PES packets from TS payloads (ref Mpeg2TsParser.hpp:371-432).

    Continuity-counter mismatch clears the assembly buffer; a new
    payload_unit_start flushes any pending packet first.
    """

    def __init__(self):
        self._buf = bytearray()
        self._cc = 0

    def on_ts_packet(self, clock: int, packet: TsPacket) -> None:
        cc = packet.continuity_counter
        if cc != self._cc:
            self._buf.clear()
        self._cc = (cc + 1) & 0xF

        if not packet.has_payload:
            return
        if packet.payload_unit_start_indicator and self._buf:
            self._check_and_out(clock, bytes(self._buf))
            self._buf.clear()
        self._buf.extend(packet.payload())

        # emit early if PES_packet_length is known and satisfied
        if len(self._buf) >= 6:
            plen = int.from_bytes(self._buf[4:6], "big")
            total = plen + 6
            if plen != 0 and len(self._buf) >= total:
                self._check_and_out(clock, bytes(self._buf[:total]))
                del self._buf[:total]

    def flush(self, clock: int = -1) -> None:
        """Emit a pending unbounded-length packet at end of stream."""
        if self._buf:
            self._check_and_out(clock, bytes(self._buf))
            self._buf.clear()

    def _check_and_out(self, clock: int, data: bytes) -> None:
        pkt = PESPacket(bytearray(data))
        if pkt.parse() and pkt.check():
            self.on_pes_packet(clock, pkt)

    # -- override -------------------------------------------------------------
    def on_pes_packet(self, clock: int, packet: PESPacket) -> None:
        raise NotImplementedError
