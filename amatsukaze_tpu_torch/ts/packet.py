"""MPEG2-TS packet layer: 188-byte packet views + vectorized sync scanning.

Behavioural parity: TsPacket / AdaptationField / TsPacketParser in the
reference (Amatsukaze/Mpeg2TsParser.hpp:13-365). The reference scans
byte-by-byte in C++; here the sync scan and resync (8-consecutive-packet
check, Mpeg2TsParser.hpp:286-305) are vectorized with numpy so the Python
host loop only touches packets that downstream handlers actually select.

The port's copy of amatsukaze_tpu/ts/packet.py.
"""

from __future__ import annotations

import numpy as np

TS_PACKET_LENGTH = 188
TS_SYNC_BYTE = 0x47
MPEG_CLOCK_HZ = 90_000  # PTS/DTS clock
PCR_CLOCK_HZ = 27_000_000

# How many consecutive sync bytes prove re-synchronisation
# (ref Mpeg2TsParser.hpp:277 CHECK_PACKET_NUM).
CHECK_PACKET_NUM = 8


class AdaptationField:
    """Adaptation field view (ref Mpeg2TsParser.hpp:13-57)."""

    __slots__ = ("data", "pcr", "opcr")

    def __init__(self, data: memoryview):
        self.data = data
        self.pcr = None  # 27 MHz
        self.opcr = None

    @property
    def adaptation_field_length(self) -> int:
        return self.data[0]

    @property
    def discontinuity_indicator(self) -> bool:
        return bool(self.data[1] & 0x80)

    @property
    def random_access_indicator(self) -> bool:
        return bool(self.data[1] & 0x40)

    @property
    def pcr_flag(self) -> bool:
        return bool(self.data[1] & 0x10)

    @property
    def opcr_flag(self) -> bool:
        return bool(self.data[1] & 0x08)

    def parse(self) -> bool:
        consumed = 2
        if self.pcr_flag:
            if consumed + 6 > len(self.data):
                return False
            self.pcr = _read_pcr(self.data[consumed : consumed + 6])
            consumed += 6
        if self.opcr_flag:
            if consumed + 6 > len(self.data):
                return False
            self.opcr = _read_pcr(self.data[consumed : consumed + 6])
            consumed += 6
        return True


def _read_pcr(b: memoryview) -> int:
    raw = int.from_bytes(b, "big")
    base = raw >> 15  # 33 bits
    ext = raw & 0x1FF  # 9 bits
    return base * 300 + ext


def write_pcr(pcr27: int) -> bytes:
    base, ext = divmod(pcr27, 300)
    raw = (base << 15) | (0x3F << 9) | ext  # 6 reserved bits set
    return raw.to_bytes(6, "big")


class TsPacket:
    """One 188-byte TS packet view (ref Mpeg2TsParser.hpp:60-119)."""

    __slots__ = ("data", "payload_offset")

    def __init__(self, data):
        self.data = data  # memoryview/bytes of length 188
        self.payload_offset = 0

    @property
    def sync_byte(self) -> int:
        return self.data[0]

    @property
    def transport_error_indicator(self) -> bool:
        return bool(self.data[1] & 0x80)

    @property
    def payload_unit_start_indicator(self) -> bool:
        return bool(self.data[1] & 0x40)

    @property
    def pid(self) -> int:
        return ((self.data[1] & 0x1F) << 8) | self.data[2]

    @property
    def transport_scrambling_control(self) -> int:
        return (self.data[3] >> 6) & 3

    @property
    def adaptation_field_control(self) -> int:
        return (self.data[3] >> 4) & 3

    @property
    def continuity_counter(self) -> int:
        return self.data[3] & 0x0F

    @property
    def has_adaptation_field(self) -> bool:
        return bool(self.adaptation_field_control & 2)

    @property
    def has_payload(self) -> bool:
        return bool(self.adaptation_field_control & 1)

    def parse(self) -> bool:
        if self.adaptation_field_control & 1:
            if self.adaptation_field_control & 2:
                # adaptation_field_length excludes the 4-byte header + itself
                self.payload_offset = 4 + 1 + self.data[4]
            else:
                self.payload_offset = 4
        return True

    def check(self) -> bool:
        # Same reject set as the reference (Mpeg2TsParser.hpp:93-103)
        if self.sync_byte != TS_SYNC_BYTE:
            return False
        if 0x0002 <= self.pid <= 0x000F:
            return False  # reserved PIDs
        if self.transport_scrambling_control == 0x01:
            return False  # undefined scrambling
        if self.adaptation_field_control == 0x00:
            return False  # undefined AFC
        if self.has_payload and self.payload_offset >= TS_PACKET_LENGTH:
            return False  # adaptation field too long
        return True

    def adaptation_field(self) -> memoryview:
        if self.has_payload:
            return self.data[4 : self.payload_offset]
        return self.data[4:TS_PACKET_LENGTH]

    def payload(self) -> memoryview:
        return self.data[self.payload_offset : TS_PACKET_LENGTH]

    def get_pcr(self) -> int | None:
        """27 MHz PCR if present and valid, else None."""
        if not self.has_adaptation_field:
            return None
        af_data = self.adaptation_field()
        if len(af_data) < 2:
            return None
        af = AdaptationField(af_data)
        if af.parse() and af.pcr_flag:
            return af.pcr
        return None


class PacketBatch:
    """A contiguous run of sync-aligned packets.

    ``data`` holds ``count * 188`` bytes; vectorized per-packet fields are
    computed once for the whole run so downstream routing can pre-filter by
    PID without touching uninteresting packets in Python.
    """

    __slots__ = ("data", "count", "_arr", "_pids")

    def __init__(self, data: bytes | memoryview):
        self.data = memoryview(data)
        self.count = len(self.data) // TS_PACKET_LENGTH
        self._arr = None
        self._pids = None

    @property
    def arr(self) -> np.ndarray:
        if self._arr is None:
            self._arr = np.frombuffer(self.data, dtype=np.uint8).reshape(
                self.count, TS_PACKET_LENGTH
            )
        return self._arr

    @property
    def pids(self) -> np.ndarray:
        if self._pids is None:
            a = self.arr
            self._pids = ((a[:, 1].astype(np.int32) & 0x1F) << 8) | a[:, 2]
        return self._pids

    def packet(self, i: int) -> TsPacket:
        return TsPacket(self.data[i * TS_PACKET_LENGTH : (i + 1) * TS_PACKET_LENGTH])

    def __iter__(self):
        for i in range(self.count):
            yield self.packet(i)


def _leading_sync_run(buf: np.ndarray, pos: int) -> int:
    """Number of consecutive packets starting at pos whose sync byte is 0x47."""
    n = len(buf)
    strided = buf[pos : n : TS_PACKET_LENGTH]
    ok = strided == TS_SYNC_BYTE
    if ok.all():
        return len(ok)
    return int(np.argmin(ok))


def _find_resync(buf: np.ndarray, start: int) -> int:
    """First offset >= start where CHECK_PACKET_NUM strided sync bytes hold.

    Returns -1 if no such offset exists within the buffer.
    """
    n = len(buf)
    limit = n - CHECK_PACKET_NUM * TS_PACKET_LENGTH  # last valid candidate offset
    if limit < start:
        return -1
    m = buf == TS_SYNC_BYTE
    cand = m[start : limit + 1].copy()
    for k in range(1, CHECK_PACKET_NUM):
        off = start + k * TS_PACKET_LENGTH
        cand &= m[off : off + (limit + 1 - start)]
    hits = np.flatnonzero(cand)
    return int(start + hits[0]) if len(hits) else -1


class TsPacketParser:
    """Sync-scanning packet splitter (ref Mpeg2TsParser.hpp:270-364).

    Feed raw bytes with :meth:`input_ts`; complete, sync-verified packets are
    delivered to :meth:`on_ts_packets` as :class:`PacketBatch` runs. Call
    :meth:`flush` at EOF to drain the tail (single-sync check per packet,
    matching the reference's flush()).
    """

    def __init__(self, ctx=None):
        self.ctx = ctx
        self._buf = bytearray()
        self._sync_ok = False

    def reset(self) -> None:
        self._buf.clear()
        self._sync_ok = False

    # -- override -------------------------------------------------------------
    def on_ts_packets(self, batch: PacketBatch) -> None:
        raise NotImplementedError

    # -- input ----------------------------------------------------------------
    def input_ts(self, data: bytes) -> None:
        self._buf.extend(data)
        self._scan()

    def flush(self) -> None:
        # Emit remaining whole packets whose own sync byte holds.
        snapshot = bytes(self._buf)
        buf = np.frombuffer(snapshot, dtype=np.uint8)
        pos = 0
        runs = []
        while pos + TS_PACKET_LENGTH <= len(buf):
            if buf[pos] == TS_SYNC_BYTE:
                k = _leading_sync_run(buf, pos)
                # every whole packet in the run is emittable at flush time
                k = min(k, (len(buf) - pos) // TS_PACKET_LENGTH)
                if k > 0:
                    runs.append((pos, k))
                    pos += k * TS_PACKET_LENGTH
                    continue
            pos += 1
        self._buf.clear()
        data = memoryview(snapshot)
        for p, k in runs:
            self._emit(data[p : p + k * TS_PACKET_LENGTH])

    # -- internals ------------------------------------------------------------
    def _scan(self) -> None:
        snapshot = bytes(self._buf)
        buf = np.frombuffer(snapshot, dtype=np.uint8)
        n = len(buf)
        pos = 0
        emit_runs = []
        while True:
            if not self._sync_ok:
                q = _find_resync(buf, pos)
                if q < 0:
                    break
                pos = q
                self._sync_ok = True
            # count consecutive verified sync bytes (188-strided) from pos;
            # a packet is emittable only when its successor's sync is also
            # verified (ref outPackets(): 2*188-byte lookahead).
            run = _leading_sync_run(buf, pos)
            whole = (n - pos) // TS_PACKET_LENGTH
            emit = min(whole, run - 1)
            if emit > 0:
                emit_runs.append((pos, emit))
                pos += emit * TS_PACKET_LENGTH
            if run >= whole:
                break  # clean up to buffer end; tail stays for more data/flush
            # sync broke mid-buffer: drop the unverified head packet via
            # byte-wise resync (ref: syncOK=false + trimHead(1) loop)
            self._sync_ok = False
        # drop consumed bytes first (handlers may reset() us), then emit
        data = memoryview(snapshot)
        if pos > 0:
            del self._buf[:pos]
        for p, k in emit_runs:
            self._emit(data[p : p + k * TS_PACKET_LENGTH])

    def _emit(self, mv: memoryview) -> None:
        self.on_ts_packets(PacketBatch(mv))
