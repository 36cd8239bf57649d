"""Mid-file TS prober + slim filter.

Parity: TsInfo / TsInfoParser / TsSlimFilter (Amatsukaze/TsInfo.hpp:44-704):
read a window from the middle of the file (fallback: 1/30 from the start),
harvest PAT -> all PMTs, SDT service names, EIT present-event info (title /
text / ARIB genre nibbles), TDT/TOT time, and each program's actual video
format from its ES; the server uses this when enqueueing files. The slim
filter drops every packet before the first video packet.

The port's copy of amatsukaze_tpu/ts/info.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..captions.arib import decode_arib_string
from ..types import VideoFormat, VideoStreamFormat
from .packet import TS_PACKET_LENGTH, PacketBatch, TsPacketParser
from .pes import PesParser
from .psi import (
    EIT,
    PAT,
    SDT,
    TDT,
    TOT,
    PsiUpdatedDetector,
    parse_content_descriptor,
    parse_service_descriptor,
    parse_short_event_descriptor,
)
from .selector import is_audio_stream, is_video_stream
from .video_h264 import H264VideoParser
from .video_mpeg2 import Mpeg2VideoParser


@dataclass
class ProgramItem:
    service_id: int = -1
    pmt_pid: int = -1
    video_pid: int = -1
    stream_type: int = -1
    has_video: bool = False
    video_format: VideoFormat = field(default_factory=VideoFormat)
    format_ok: bool = False
    # audio elementary streams: (PID, stream_type) in PMT order
    audio_pids: list = field(default_factory=list)

    @property
    def has_audio(self) -> bool:
        return bool(self.audio_pids)


@dataclass
class EventItem:
    name: str = ""
    text: str = ""
    genres: list = field(default_factory=list)  # (level1, level2) nibbles


def _arib(b: bytes) -> str:
    try:
        return decode_arib_string(bytes(b))
    except Exception:  # noqa: BLE001 — tolerate malformed mid-file strings
        return ""


class _Delegate(PsiUpdatedDetector):
    def __init__(self, ctx, fn):
        super().__init__(ctx)
        self._fn = fn

    def on_table_updated(self, clock, section):
        self._fn(section)


class _VideoFormatProbe(PesParser):
    """Assemble the video PES and pull the first coded format."""

    def __init__(self, ctx, prog: ProgramItem):
        super().__init__()
        self.ctx = ctx
        self.prog = prog
        self.parser = (H264VideoParser(ctx) if prog.stream_type == 0x1B
                       else Mpeg2VideoParser(ctx))

    def on_pes_packet(self, clock, packet) -> None:
        pts = packet.pts if packet.has_pts else -1
        dts = packet.dts if packet.has_dts else pts
        frames = self.parser.input_frame(packet.payload(), pts, dts)
        if frames:
            fmt = frames[0].format
            if not fmt.is_empty():
                self.prog.video_format = fmt
                self.prog.format_ok = True


class TsInfo(TsPacketParser):
    """(ref TsInfo, TsInfo.hpp:464-612)."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.ctx = ctx
        self.programs: list[ProgramItem] = []
        self.service_names: dict[int, str] = {}
        self.events: dict[int, EventItem] = {}
        self.time = None
        self._pat = _Delegate(ctx, self._on_pat)
        self._pid_parsers: dict[int, object] = {0x0000: self._pat}
        self._pid_parsers[0x0011] = _Delegate(ctx, self._on_sdt)
        self._pid_parsers[0x0012] = _Delegate(ctx, self._on_eit)
        self._pid_parsers[0x0014] = _Delegate(ctx, self._on_tdt)
        self._pmt_pids: dict[int, _Delegate] = {}
        self._video_probes: dict[int, _VideoFormatProbe] = {}

    # ----------------------------------------------------------------- parse
    def on_ts_packets(self, batch: PacketBatch) -> None:
        for pkt in batch:
            if not (pkt.parse() and pkt.check()):
                continue
            h = self._pid_parsers.get(pkt.pid)
            if h is None:
                continue
            if isinstance(h, PesParser):
                h.on_ts_packet(0, pkt)
            else:
                h.on_ts_packet(0, pkt)

    def _on_pat(self, section) -> None:
        pat = PAT(section)
        if not (pat.parse() and pat.check()):
            return
        for sid, pid in pat.programs():
            if any(p.service_id == sid for p in self.programs):
                continue
            prog = ProgramItem(service_id=sid, pmt_pid=pid)
            self.programs.append(prog)
            dele = _Delegate(self.ctx, lambda s, p=prog: self._on_pmt(p, s))
            self._pmt_pids[pid] = dele
            self._pid_parsers[pid] = dele

    def _on_pmt(self, prog: ProgramItem, section) -> None:
        from .psi import PMT

        pmt = PMT(section)
        if not (pmt.parse() and pmt.check()):
            return
        if section.id != prog.service_id:
            return
        for elem in pmt.elems:
            if is_video_stream(elem.stream_type):
                if prog.has_video:
                    continue
                prog.video_pid = elem.elementary_pid
                prog.stream_type = elem.stream_type
                prog.has_video = True
                if elem.elementary_pid not in self._video_probes:
                    probe = _VideoFormatProbe(self.ctx, prog)
                    self._video_probes[elem.elementary_pid] = probe
                    self._pid_parsers[elem.elementary_pid] = probe
            elif is_audio_stream(elem.stream_type):
                pair = (elem.elementary_pid, elem.stream_type)
                if pair not in prog.audio_pids:
                    prog.audio_pids.append(pair)

    def _on_sdt(self, section) -> None:
        if section.table_id not in (0x42,):  # actual TS only
            return
        sdt = SDT(section)
        if not (sdt.parse() and sdt.check()):
            return
        for svc in sdt.services:
            for tag, payload in svc.descriptors:
                if tag == 0x48:
                    parsed = parse_service_descriptor(payload)
                    if parsed:
                        _, _, name = parsed
                        self.service_names.setdefault(svc.service_id,
                                                      _arib(name))

    def _on_eit(self, section) -> None:
        if section.table_id not in (0x4E,):  # present/following, actual
            return
        if section.section_number != 0:  # present event only
            return
        eit = EIT(section)
        if not (eit.parse() and eit.check()) or not eit.events:
            return
        ev = eit.events[0]
        item = EventItem()
        for tag, payload in ev.descriptors:
            if tag == 0x4D:  # short event
                parsed = parse_short_event_descriptor(payload)
                if parsed:
                    _, name, text = parsed
                    item.name = _arib(name)
                    item.text = _arib(text)
            elif tag == 0x54:  # content (genre)
                item.genres = [(l1, l2) for l1, l2, _, _ in
                               parse_content_descriptor(payload)]
        self.events.setdefault(eit.service_id, item)

    def _on_tdt(self, section) -> None:
        if section.table_id == 0x70:
            tdt = TDT(section)
            if tdt.parse() and tdt.check() and self.time is None:
                self.time = tdt.jst_time()
        elif section.table_id == 0x73:
            tot = TOT(section)
            if tot.parse() and tot.check() and self.time is None:
                self.time = tot.jst_time()

    # ------------------------------------------------------------------ file
    def _complete(self) -> bool:
        return (bool(self.programs)
                and all(p.format_ok for p in self.programs if p.has_video)
                and self.time is not None)

    def read_file(self, path: str, window: int = 16 << 20) -> bool:
        """Probe from the middle of the file, then from 1/30 in
        (ref TsInfo::ReadFile :472-493)."""
        size = os.path.getsize(path)
        offsets = [max(0, size // 2 - window // 2), size // 30]
        with open(path, "rb") as f:
            for off in offsets:
                off -= off % TS_PACKET_LENGTH
                f.seek(off)
                data = f.read(window)
                self.reset()
                self.input_ts(data)
                self.flush()
                if self._complete():
                    return True
        return bool(self.programs)

    def get_program(self, service_id: int) -> ProgramItem | None:
        for p in self.programs:
            if p.service_id == service_id:
                return p
        return None


def slim_ts(src_path: str, dst_path: str, chunk: int = 4 << 20) -> int:
    """Drop every packet before the first video packet
    (ref TsSlimFilter :643-704). Returns bytes written."""
    from ..utils.context import AMTContext

    info = TsInfo(AMTContext(level="error"))
    info.read_file(src_path)
    video_pids = {p.video_pid for p in info.programs if p.has_video}
    if not video_pids:
        raise ValueError("no video stream found")

    written = 0
    started = False
    with open(src_path, "rb") as fi, open(dst_path, "wb") as fo:
        buf = b""
        while True:
            data = fi.read(chunk)
            if not data:
                break
            buf += data
            n = len(buf) // TS_PACKET_LENGTH * TS_PACKET_LENGTH
            block, buf = buf[:n], buf[n:]
            if started:
                fo.write(block)
                written += len(block)
                continue
            for pos in range(0, n, TS_PACKET_LENGTH):
                if block[pos] != 0x47:
                    continue
                pid = ((block[pos + 1] & 0x1F) << 8) | block[pos + 2]
                if pid in video_pids:
                    fo.write(block[pos:])
                    written += n - pos
                    started = True
                    break
    return written
