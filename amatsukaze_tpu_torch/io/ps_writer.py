"""MPEG2-PS writer for the intermediate per-format video files, + verifier.

Parity: PsStreamWriter / PsStreamVerifier (Amatsukaze/Mpeg2PsWriter.hpp):
pack headers with SCR, the 2-stream PSM (video 0xE0 + first audio 0xC0) with
CRC, PES re-packetisation with 32 KB splits, and the VBV-style decoder-buffer
clock model (MP@HL 80 Mbps / 9781248-bit VBV; audio buffer sized by channel
count). Byte-format compatible so standard demuxers (and the reference's own
parser) read the output.

The port's copy of amatsukaze_tpu/io/ps_writer.py.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from ..types import NUM_AUDIO_CHANNELS, AudioChannels
from ..utils.bits import BitWriter
from ..utils.crc import crc32_mpeg2

PACK_START_CODE = 0x000001BA
PSM_START_CODE = 0x000001BC
SYSTEM_HEADER_START_CODE = 0x000001BB
MPEG_PROGRAM_END_CODE = 0x000001B9

BITRATE = 80 * 1000 * 1000  # MP@HL max
VBV_SIZE = 9781248 // 8
SYSTEM_CLOCK = 27_000_000
VIDEO_STREAM_ID = 0xE0
AUDIO_STREAM_ID = 0xC0
PES_SPLIT = 32 * 1000


def _audio_buffer_size(n_channels: int) -> int:
    if n_channels <= 2:
        return 3584
    if n_channels <= 8:
        return 8976
    if n_channels <= 12:
        return 12804
    return 51216


@dataclass
class _AccessUnit:
    dts: int
    size: int


class _EsBuffer:
    def __init__(self, size: int):
        self.buffer_size = size
        self.filled = 0
        self.units: deque[_AccessUnit] = deque()

    def make_space(self, size: int) -> int:
        time = -1
        if size > self.buffer_size:
            if self.units:
                time = self.units[-1].dts
                self.filled = 0
                self.units.clear()
            return time
        while self.buffer_size - self.filled < size:
            au = self.units.popleft()
            self.filled -= au.size
            time = au.dts
        return time

    def put(self, au: _AccessUnit) -> None:
        self.units.append(au)
        self.filled += au.size


class PsStreamWriter:
    """Write demuxed PES into a program stream (ref :308-601)."""

    def __init__(self, ctx, on_data=None):
        self.ctx = ctx
        self.on_data = on_data or (lambda data: None)
        self.current_clock = -1
        self.video_buffer = _EsBuffer(VBV_SIZE)
        self.audio_buffer = _EsBuffer(3584)
        self.audio_channels = AudioChannels.NONE
        self.psm_version = 0
        self.video_stream_type = 0
        self.audio_stream_type = 0
        self.next_is_psm = True
        self._buf = bytearray()

    def out_header(self, video_stream_type: int, audio_stream_type: int) -> None:
        if (self.video_stream_type != video_stream_type
                or self.audio_stream_type != audio_stream_type):
            self.video_stream_type = video_stream_type
            self.audio_stream_type = audio_stream_type
            self.psm_version += 1
        self.next_is_psm = True

    # -- public --------------------------------------------------------------
    def out_video_pes_packet(self, clock: int, frames, packet) -> None:
        if not frames:
            return
        self._init_if_needed(clock)
        pts = frames[0].pts
        dts = frames[0].dts
        last_dts = frames[-1].dts
        self._put_access_unit(last_dts, len(packet.data), self.video_buffer)
        self._write_pes(packet, VIDEO_STREAM_ID, pts, dts)
        self._out_pack()

    def out_audio_pes_packet(self, audio_idx: int, clock: int, frames, packet) -> None:
        if audio_idx != 0 or not frames:
            return
        self._init_if_needed(clock)
        pts = frames[0].pts
        last = frames[-1].pts
        ch = frames[0].format.channels
        if self.audio_channels != ch:
            self.audio_channels = ch
            self.audio_buffer.buffer_size = _audio_buffer_size(
                NUM_AUDIO_CHANNELS.get(ch, 2)
            )
        self._put_access_unit(last, len(packet.data), self.audio_buffer)
        self._write_pes(packet, AUDIO_STREAM_ID, pts, pts)
        self._out_pack()

    def finish(self) -> None:
        self._buf += MPEG_PROGRAM_END_CODE.to_bytes(4, "big")
        self._out_pack()

    # -- internals --------------------------------------------------------------
    def _init_if_needed(self, clock: int) -> None:
        if self.current_clock == -1:
            self.current_clock = clock
        if self.next_is_psm:
            self.next_is_psm = False
            self._write_pack_header()
            psm_start = len(self._buf)
            w = BitWriter()
            w.write(PSM_START_CODE, 32)
            psm_length = 2 + 2 + 2 + 4 * 2 + 4
            w.write(psm_length, 16)
            w.write(1, 1)  # current_next
            w.write(0x3, 2)  # reserved
            w.write(self.psm_version & 0x1F, 5)
            w.write(0x7F, 7)  # reserved
            w.write(1, 1)  # marker
            w.write(0, 16)  # program_stream_info_length
            w.write(4 * 2, 16)  # elementary_stream_map_length
            w.write(self.video_stream_type, 8)
            w.write(VIDEO_STREAM_ID, 8)
            w.write(0, 16)
            w.write(self.audio_stream_type, 8)
            w.write(AUDIO_STREAM_ID, 8)
            w.write(0, 16)
            body = w.getvalue()
            self._buf += body
            crc = crc32_mpeg2(self._buf[psm_start:])
            self._buf += crc.to_bytes(4, "big")
            self._out_pack()

    def _write_scr(self, w: BitWriter, scr: int) -> None:
        base, ext = divmod(scr, 300)
        w.write(1, 2)
        w.write((base >> 30) & 0x7, 3)
        w.write(1, 1)
        w.write((base >> 15) & 0x7FFF, 15)
        w.write(1, 1)
        w.write(base & 0x7FFF, 15)
        w.write(1, 1)
        w.write(ext, 9)
        w.write(1, 1)

    def _write_pts(self, w: BitWriter, prefix: int, pts: int) -> None:
        w.write(prefix, 4)
        w.write((pts >> 30) & 0x7, 3)
        w.write(1, 1)
        w.write((pts >> 15) & 0x7FFF, 15)
        w.write(1, 1)
        w.write(pts & 0x7FFF, 15)
        w.write(1, 1)

    def _write_pack_header(self) -> None:
        w = BitWriter()
        w.write(PACK_START_CODE, 32)
        self._write_scr(w, max(0, self.current_clock))
        w.write(BITRATE // (50 * 8), 22)
        w.write(0x3, 2)
        w.write(0x1F, 5)
        w.write(0, 3)  # stuffing length
        self._buf += w.getvalue()

    def _write_pes_header(self, w: BitWriter, stream_id: int, payload_len: int,
                          flags: int, pts: int, dts: int) -> None:
        header_length = (5 if flags & 1 else 0) + (5 if flags & 2 else 0)
        w.write(1, 24)
        w.write(stream_id, 8)
        w.write(3 + header_length + payload_len, 16)
        w.write(0x2, 2)
        w.write(0, 2)
        w.write(0, 1)
        w.write(0, 1)
        w.write(0, 1)
        w.write(1, 1)  # original_or_copy
        w.write(flags, 2)
        w.write(0, 6)
        w.write(header_length, 8)
        if flags == 2:
            self._write_pts(w, 2, pts)
        elif flags == 3:
            self._write_pts(w, 3, pts)
            self._write_pts(w, 1, dts)

    def _write_pes(self, packet, stream_id: int, pts: int, dts: int) -> None:
        payload = bytes(packet.payload())
        offset = 0
        flags = packet.pts_dts_flags
        while True:
            length = min(PES_SPLIT, len(payload) - offset)
            w = BitWriter()
            if offset == 0:
                self._write_pack_header_into(w)
                self._write_pes_header(w, stream_id, length, flags, pts, dts)
            else:
                self._write_pes_header(w, stream_id, length, 0, 0, 0)
            self._buf += w.getvalue()
            self._buf += payload[offset : offset + length]
            offset += length
            if offset >= len(payload):
                break

    def _write_pack_header_into(self, w: BitWriter) -> None:
        w.write(PACK_START_CODE, 32)
        self._write_scr(w, max(0, self.current_clock))
        w.write(BITRATE // (50 * 8), 22)
        w.write(0x3, 2)
        w.write(0x1F, 5)
        w.write(0, 3)

    def _proceed_clock(self, nbytes: int) -> None:
        self.current_clock += nbytes * 8 * SYSTEM_CLOCK // BITRATE

    def _put_access_unit(self, dts: int, size: int, es: _EsBuffer) -> None:
        au = _AccessUnit(dts, size)
        time = es.make_space(size)
        if time > self.current_clock:
            self.current_clock = time
        es.put(au)

    def _out_pack(self) -> None:
        if self._buf:
            self.on_data(bytes(self._buf))
            self._proceed_clock(len(self._buf))
            self._buf.clear()


class PsStreamVerifier:
    """Structural check of a produced PS (ref PsStreamVerifier :140-273):
    walks packs, validates PSM CRC, counts video/audio PES packets."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.n_video = 0
        self.n_audio = 0
        self.n_psm = 0

    def verify(self, data: bytes) -> bool:
        pos = 0
        n = len(data)
        while pos + 4 <= n:
            code = int.from_bytes(data[pos : pos + 4], "big")
            if code == PACK_START_CODE:
                # fixed-length pack header (no stuffing written by us)
                pos += 14
            elif code == PSM_START_CODE:
                length = int.from_bytes(data[pos + 4 : pos + 6], "big")
                section = data[pos : pos + 6 + length]
                # the CRC covers the PSM from its start code (ref :449-451)
                if crc32_mpeg2(section) != 0:
                    self.ctx.error("PSM CRC mismatch")
                    return False
                self.n_psm += 1
                pos += 6 + length
            elif code == MPEG_PROGRAM_END_CODE:
                pos += 4
            elif (code >> 8) == 1 and (code & 0xFF) in (VIDEO_STREAM_ID, AUDIO_STREAM_ID):
                length = int.from_bytes(data[pos + 4 : pos + 6], "big")
                if (code & 0xFF) == VIDEO_STREAM_ID:
                    self.n_video += 1
                else:
                    self.n_audio += 1
                pos += 6 + length
            else:
                self.ctx.error("unknown start code %08x at %d", code, pos)
                return False
        return True
