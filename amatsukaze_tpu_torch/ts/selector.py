"""PID routing with service selection and double-buffered handler tables.

Parity: PidHandlerTable / TsPacketSelector in the reference
(Amatsukaze/Mpeg2TsParser.hpp:988-1533): PAT -> service choice -> PMT ->
video/audio/caption ES selection (caption via component_tag 0x30/0x87),
deferred handler-table swap on video-PID change (swap happens on the first
packet of the new video PID), TDT/TOT time callbacks.

The port's copy of amatsukaze_tpu/ts/selector.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from .packet import TsPacket
from .psi import PAT, PMT, TDT, TOT, PsiUpdatedDetector

PID_PAT = 0x0000
PID_TDT = 0x0014


@dataclass
class PMTESInfo:
    stype: int = -1
    pid: int = -1


def is_video_stream(stream_type: int) -> bool:
    # MPEG2, H.264, H.265 (the reference comments 0x24 out of isVideo,
    # Mpeg2TsParser.hpp:1420; in-build HEVC ingest goes beyond parity)
    return stream_type in (0x02, 0x1B, 0x24)


def is_audio_stream(stream_type: int) -> bool:
    # ADTS AAC (2K broadcast) + LATM/LOAS AAC (stream_type 0x11, the
    # ARIB STD-B32 4K framing; the reference accepts only 0x0F)
    return stream_type in (0x0F, 0x11)


def is_caption_stream(stream_type: int) -> bool:
    return stream_type == 0x06


class PidHandlerTable:
    """PID -> handler map with constant entries that survive clear()."""

    def __init__(self):
        self._const: dict[int, object] = {}
        self._table: dict[int, object] = {}
        self.version = 0  # bumped on any change (used for batch prefiltering)

    def add_constant(self, pid: int, handler) -> None:
        self._const[pid] = handler
        self._table[pid] = handler
        self.version += 1

    def add(self, pid: int, handler) -> None:
        # a PID being re-pointed elsewhere keeps the newest assignment,
        # mirroring the reference's handlers-vector bookkeeping
        self._table[pid] = handler
        self.version += 1

    def get(self, pid: int):
        return self._table.get(pid)

    def clear(self) -> None:
        self._table = dict(self._const)
        self.version += 1

    def pids(self):
        return self._table.keys()


class TsPacketSelectorHandler:
    """Callbacks from the selector (ref Mpeg2TsParser.hpp:1062-1092)."""

    def on_pid_select(self, tsid: int, sids: list[int]) -> int:
        """Return the index of the service to select, or -1 for none."""
        raise NotImplementedError

    def on_pmt_updated(self, pcr_pid: int) -> None:
        pass

    def on_pid_table_changed(self, video: PMTESInfo, audio: list[PMTESInfo],
                             caption: PMTESInfo) -> None:
        pass

    def on_video_packet(self, clock: int, packet: TsPacket) -> None:
        pass

    def on_audio_packet(self, clock: int, packet: TsPacket, audio_idx: int) -> None:
        pass

    def on_caption_packet(self, clock: int, packet: TsPacket) -> None:
        pass

    def on_time(self, clock: int, jst_time) -> None:
        pass


class _Delegator(PsiUpdatedDetector):
    def __init__(self, ctx, fn):
        super().__init__(ctx)
        self._fn = fn

    def on_table_updated(self, clock, section):
        self._fn(clock, section)


class TsPacketSelector:
    def __init__(self, ctx):
        self.ctx = ctx
        self.handler: TsPacketSelectorHandler | None = None
        self._waiting_new_video = False
        self._tsid = -1
        self._sid = -1
        self._video_es = PMTESInfo()
        self._audio_es: list[PMTESInfo] = []
        self._caption_es = PMTESInfo()
        self._pmt_pid = -1
        self._start_clock = -1
        self._current_clock = -1

        self._pat_parser = _Delegator(ctx, self._on_pat)
        self._pmt_parser = _Delegator(ctx, self._on_pmt)
        self._tdt_parser = _Delegator(ctx, self._on_tdt)

        self._cur = PidHandlerTable()
        self._next = PidHandlerTable()
        for t in (self._cur, self._next):
            t.add_constant(PID_PAT, self._pat_parser)
            t.add_constant(PID_TDT, self._tdt_parser)

    # -- public ----------------------------------------------------------------
    def set_handler(self, handler: TsPacketSelectorHandler) -> None:
        self.handler = handler

    def set_start_clock(self, clock: int) -> None:
        self._start_clock = clock

    def reset_parser(self) -> None:
        self._pat_parser.clear()
        self._pmt_parser.clear()

    @property
    def table_version(self) -> int:
        return self._cur.version + (1 << 20) * int(self._waiting_new_video)

    def active_pids(self) -> set[int]:
        """PIDs that currently need Python-level handling (for batch
        prefiltering); includes the pending new video PID if waiting."""
        pids = set(self._cur.pids())
        if self._waiting_new_video and self._video_es.pid != -1:
            pids.add(self._video_es.pid)
        return pids

    def native_routing(self):
        """Routing tables for the native demux engine: (pes, pause, raw)
        where pes maps pid -> ("video",) | ("audio", idx) | ("caption",).
        Pause pids are the control packets that can change routing (PAT,
        the selected PMT, and — during a deferred video-PID swap — the
        pending video pid, whose first packet triggers the table swap)."""
        pes: dict[int, tuple] = {}
        for pid in self._cur.pids():
            h = self._cur.get(pid)
            if isinstance(h, _VideoProxy):
                pes[pid] = ("video",)
            elif isinstance(h, _AudioProxy):
                pes[pid] = ("audio", h.idx)
            elif isinstance(h, _CaptionProxy):
                pes[pid] = ("caption",)
        pause = {PID_PAT}
        if self._pmt_pid != -1:
            pause.add(self._pmt_pid)
        if self._waiting_new_video and self._video_es.pid != -1:
            pause.add(self._video_es.pid)
            pes.pop(self._video_es.pid, None)
        raw = {PID_TDT}
        return pes, pause, raw

    def input_ts_packet(self, clock: int, packet: TsPacket) -> None:
        self._current_clock = clock
        if self._waiting_new_video and packet.pid == self._video_es.pid:
            self._waiting_new_video = False
            self._swap_handler_table()
            if self.handler:
                self.handler.on_pid_table_changed(
                    self._video_es, self._audio_es, self._caption_es
                )
        h = self._cur.get(packet.pid)
        if h is not None:
            h.on_ts_packet(clock, packet)

    # -- PSI callbacks -----------------------------------------------------------
    def _on_pat(self, clock, section) -> None:
        if self.handler is None:
            return
        pat = PAT(section)
        if not (section.current_next_indicator and pat.parse() and pat.check()):
            return
        progs = pat.programs()
        sids = [s for s, _ in progs]
        pids = [p for _, p in progs]
        if self._tsid != pat.tsid:
            self._cur.clear()
            self._pmt_parser.clear()
            self._tsid = pat.tsid
        progidx = self.handler.on_pid_select(pat.tsid, sids)
        if progidx >= len(sids):
            raise IndexError("selected service index out of range")
        if progidx >= 0:
            sid, pid = sids[progidx], pids[progidx]
            if self._sid != sid:
                self._cur.clear()
                self._pmt_parser.clear()
                self._sid = sid
            self._pmt_pid = pid
            self._cur.add(pid, self._pmt_parser)

    def _on_pmt(self, clock, section) -> None:
        if self.handler is None:
            return
        pmt = PMT(section)
        if not (section.current_next_indicator and pmt.parse() and pmt.check()):
            return

        video = PMTESInfo()
        audio: list[PMTESInfo] = []
        caption = PMTESInfo()
        for elem in pmt.elems:
            st = elem.stream_type
            if is_video_stream(st) and video.stype == -1:
                video = PMTESInfo(st, elem.elementary_pid)
            elif is_audio_stream(st):
                audio.append(PMTESInfo(st, elem.elementary_pid))
            elif is_caption_stream(st):
                ct = elem.component_tag()
                if ct in (0x30, 0x87):  # caption (not superimpose)
                    caption = PMTESInfo(st, elem.elementary_pid)
        if video.pid == -1:
            self.ctx.warn("PMT has no video stream")
            return
        if not audio:
            self.ctx.warn("PMT has no audio stream")

        table = self._cur
        if video.pid != self._video_es.pid:
            # video PID change: stage the new table, swap on first new-video packet
            self._waiting_new_video = True
            table = self._next
            if self._video_es.pid != -1:
                self.ctx.info("PMT: video stream change detected")

        self._video_es = video
        self._audio_es = audio
        self._caption_es = caption

        table.add(video.pid, _VideoProxy(self))
        for i, a in enumerate(audio):
            table.add(a.pid, _AudioProxy(self, i))
        if caption.pid != -1:
            table.add(caption.pid, _CaptionProxy(self))

        self.handler.on_pmt_updated(pmt.pcr_pid)
        if table is self._cur:
            self.handler.on_pid_table_changed(video, audio, caption)

    def _on_tdt(self, clock, section) -> None:
        if self.handler is None or clock == -1:
            return
        if section.table_id == 0x70:
            tdt = TDT(section)
            if tdt.parse() and tdt.check():
                self.handler.on_time(clock, tdt.jst_time())
        elif section.table_id == 0x73:
            tot = TOT(section)
            if tot.parse() and tot.check():
                self.handler.on_time(clock, tot.jst_time())

    def _swap_handler_table(self) -> None:
        self._cur, self._next = self._next, self._cur
        self._next.clear()
        self._cur.add(self._pmt_pid, self._pmt_parser)


class _VideoProxy:
    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s

    def on_ts_packet(self, clock, packet):
        if self.s.handler:
            self.s.handler.on_video_packet(clock, packet)


class _AudioProxy:
    __slots__ = ("s", "idx")

    def __init__(self, s, idx):
        self.s = s
        self.idx = idx

    def on_ts_packet(self, clock, packet):
        if self.s.handler:
            self.s.handler.on_audio_packet(clock, packet, self.idx)


class _CaptionProxy:
    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s

    def on_ts_packet(self, clock, packet):
        if self.s.handler:
            self.s.handler.on_caption_packet(clock, packet)
