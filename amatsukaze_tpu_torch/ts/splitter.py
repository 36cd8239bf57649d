"""TS demux driver: 3-phase init with rewind-and-replay, PCR wall clock,
ES parser wiring, scramble counting.

Parity: TsSplitter / TsPacketBuffer / TsSystemClock and the
VideoFrameParser/AudioFrameParser wrappers in the reference
(Amatsukaze/TsSplitter.hpp): PMT_WAITING -> PCR_WAITING -> INIT_FINISHED,
with the buffered stream replayed from the beginning once the PCR bitrate is
known (TsSplitter.hpp:457-499), PCR -> wall-clock interpolation (:320-400),
and per-ES parser fan-out (:40-250).

Packets arrive as vectorized batches (see packet.PacketBatch);
only PIDs with live handlers are touched by the Python loop.

The port's copy of amatsukaze_tpu/ts/splitter.py.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..types import AudioFormat, VideoFormat, VideoStreamFormat
from .adts import AdtsParser
from .packet import TS_PACKET_LENGTH, PacketBatch, TsPacket, TsPacketParser
from .pes import PesParser, PESPacket
from .selector import PMTESInfo, TsPacketSelector, TsPacketSelectorHandler
from .video_h264 import H264VideoParser
from .video_h265 import H265VideoParser
from .video_mpeg2 import Mpeg2VideoParser

MAX_BUFFERED_PACKETS = 50 * 1024  # 9.6 MB (ref TsSplitter.hpp:418)

# init phases (ref TsSplitter.hpp:460-464)
PMT_WAITING = 0
PCR_WAITING = 1
INIT_FINISHED = 2


def _cdiv_trunc(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


class TsSystemClock:
    """PCR-anchored wall clock, 27 MHz (ref TsSplitter.hpp:320-400)."""

    def __init__(self):
        self.pcr_pid = -1
        self.num_pcr_received = 0
        self.num_total_packets = 0
        # two PCR anchors: (clock, packet_index)
        self.pcr_info = [[0, -1], [0, -1]]

    def set_pcr_pid(self, pid: int) -> None:
        self.pcr_pid = pid

    def pcr_received(self) -> bool:
        return self.num_pcr_received >= 2

    def get_clock(self, relative: int = 0) -> int:
        if not self.pcr_received():
            return -1
        index = self.num_total_packets + relative - 1
        (c0, i0), (c1, i1) = self.pcr_info
        return _cdiv_trunc((c1 - c0) * (index - i1), (i1 - i0)) + c1

    def back_ts(self) -> None:
        self.num_total_packets = 0

    def input_ts_packet(self, packet: TsPacket) -> None:
        if packet.pid == self.pcr_pid and packet.has_adaptation_field:
            af_data = packet.adaptation_field()
            if len(af_data) >= 2:
                from .packet import AdaptationField

                af = AdaptationField(af_data)
                if af.parse():
                    if af.discontinuity_indicator:
                        self.num_pcr_received = 0
                    if self.pcr_info[1][1] < self.num_total_packets:
                        self.pcr_info[0], self.pcr_info[1] = (
                            self.pcr_info[1],
                            self.pcr_info[0],
                        )
                        if af.pcr_flag:
                            self.pcr_info[1][0] = af.pcr
                            self.pcr_info[1][1] = self.num_total_packets
                            self.num_pcr_received += 1
        self.num_total_packets += 1

    def current_bitrate(self) -> float:
        (c0, i0), (c1, i1) = self.pcr_info
        return (i1 - i0) * TS_PACKET_LENGTH * 8 / (c1 - c0) * 27_000_000

    # -- native-engine event feed (amatsukaze_tpu/ts/native.py) ----------------
    def apply_af_event(self, index: int, flags: int, pcr: int) -> None:
        """Mirror of input_ts_packet for a pcr-pid adaptation-field event
        delivered by the native engine: flags bit0 = discontinuity,
        bit1 = has_pcr; `index` is the packet's global index."""
        if flags & 1:
            self.num_pcr_received = 0
        if self.pcr_info[1][1] < index:
            self.pcr_info[0], self.pcr_info[1] = (
                self.pcr_info[1],
                self.pcr_info[0],
            )
            if flags & 2:
                self.pcr_info[1][0] = pcr
                self.pcr_info[1][1] = index
                self.num_pcr_received += 1
        self.num_total_packets = index + 1

    def clock_at(self, index: int) -> int:
        """Clock of the packet at a global index with the current anchors
        (identical to get_clock(0) right after that packet was counted)."""
        if not self.pcr_received():
            return -1
        (c0, i0), (c1, i1) = self.pcr_info
        return _cdiv_trunc((c1 - c0) * (index - i1), (i1 - i0)) + c1


class VideoFrameParser(PesParser):
    """PES -> coded frames via the MPEG2/H264 ES parsers
    (ref TsSplitter.hpp:28-112)."""

    def __init__(self, ctx, splitter: "TsSplitter"):
        super().__init__()
        self.ctx = ctx
        self.splitter = splitter
        self._stream_format = VideoStreamFormat.MPEG2
        self._video_format = VideoFormat()
        self._mpeg2 = Mpeg2VideoParser(ctx)
        self._h264 = H264VideoParser(ctx)
        self._h265 = H265VideoParser(ctx)
        self._parser = self._mpeg2

    def set_stream_format(self, fmt: VideoStreamFormat) -> None:
        if self._stream_format != fmt:
            self._parser = {
                VideoStreamFormat.MPEG2: self._mpeg2,
                VideoStreamFormat.H265: self._h265,
            }.get(fmt, self._h264)
            self.reset()
            self._stream_format = fmt

    def get_stream_format(self) -> VideoStreamFormat:
        return self._stream_format

    def reset(self) -> None:
        self._video_format = VideoFormat()
        self._parser.reset()

    def on_pes_packet(self, clock: int, packet: PESPacket) -> None:
        if not packet.has_pts:
            self.ctx.error("video PES packet without PTS")
            return
        pts = packet.pts if packet.has_pts else -1
        dts = packet.dts if packet.has_dts else pts
        frames = self._parser.input_frame(packet.payload(), pts, dts)
        if frames is None:
            self.ctx.error("failed to get frame info, PTS=%d", pts)
            return
        if frames:
            first = frames[0]
            if first.format.is_empty():
                return
            if first.format != self._video_format:
                self._video_format = first.format
                self.splitter.on_video_format_changed(first.format)
            if clock == -1:
                self.ctx.error("video PES packet without clock info")
                return
            self.splitter.on_video_pes_packet(clock, frames, packet)


class AudioFrameParser(PesParser):
    """PES -> ADTS frames (ref TsSplitter.hpp:114-157). LATM/LOAS
    audio (stream_type 0x11, 4K broadcast) is re-wrapped to ADTS in
    front of the same machinery (ts/latm.py)."""

    def __init__(self, ctx, splitter: "TsSplitter", audio_idx: int,
                 decoder_factory=None):
        super().__init__()
        self.ctx = ctx
        self.splitter = splitter
        self.audio_idx = audio_idx
        dec = decoder_factory() if decoder_factory else None
        self._adts = AdtsParser(ctx, dec)
        self._format = AudioFormat()
        self._latm = None  # set when the PMT types this PID 0x11

    def set_stream_type(self, stream_type: int) -> None:
        if stream_type == 0x11 and self._latm is None:
            from .latm import LatmToAdts

            self._latm = LatmToAdts()
        elif stream_type != 0x11:
            self._latm = None

    def on_pes_packet(self, clock: int, packet: PESPacket) -> None:
        t0 = time.perf_counter()
        try:
            self._on_pes_packet(clock, packet)
        finally:
            self.splitter.audio_seconds += time.perf_counter() - t0

    def _on_pes_packet(self, clock: int, packet: PESPacket) -> None:
        if clock == -1:
            self.ctx.error("audio PES packet without clock info")
            return
        pts = packet.pts if packet.has_pts else -1
        payload = packet.payload()
        if self._latm is not None:
            payload = self._latm.feed(payload)
        frames = self._adts.input_frame(payload, pts)
        if frames:
            first = frames[0]
            if first.format != self._format:
                self._format = first.format
                self.splitter.on_audio_format_changed(self.audio_idx, first.format)
            self.splitter.on_audio_pes_packet(self.audio_idx, clock, frames, packet)


class CaptionPesParser(PesParser):
    """PES -> caption items with PTS sanity correction
    (ref TsSplitter.hpp:160-250). The ARIB decode is pluggable."""

    def __init__(self, ctx, splitter: "TsSplitter", caption_decoder=None):
        super().__init__()
        self.ctx = ctx
        self.splitter = splitter
        self.decoder = caption_decoder

    def on_pes_packet(self, clock: int, packet: PESPacket) -> None:
        if self.decoder is None:
            return
        t0 = time.perf_counter()
        try:
            self._decode(clock, packet)
        finally:
            self.splitter.caption_seconds += time.perf_counter() - t0

    def _decode(self, clock: int, packet: PESPacket) -> None:
        pts = packet.pts if packet.has_pts else -1
        sys_clock = clock // 300
        # receivers must get >=0.5 s of lead; observed streams use ~0.75-0.80 s.
        # outside [0.5, 1.5] s assume broken PTS and rebase (ref :174-186)
        td = pts - sys_clock
        if td < 0.5 * 90000 or td > 1.5 * 90000:
            pts = sys_clock + int(0.8 * 90000)
        captions = self.decoder.decode(pts, bytes(packet.payload()))
        if captions:
            self.splitter.on_caption_pes_packet(clock, captions, packet)


class _SplitterPacketParser(TsPacketParser):
    def __init__(self, ctx, sink):
        super().__init__(ctx)
        self.sink = sink  # callable(batch)

    def on_ts_packets(self, batch: PacketBatch) -> None:
        self.sink(batch)


class TsSplitter(TsPacketSelectorHandler):
    """Abstract demux driver; subclasses get the on_* callbacks
    (ref TsSplitter.hpp:402-682)."""

    def __init__(self, ctx, enable_video=True, enable_audio=True,
                 enable_caption=True, audio_decoder_factory=None,
                 caption_decoder=None):
        self.ctx = ctx
        self.enable_video = enable_video
        self.enable_audio = enable_audio
        self.enable_caption = enable_caption
        self._audio_decoder_factory = audio_decoder_factory

        self.init_phase = PMT_WAITING
        self.prefered_service_id = -1
        self.selected_service_id = -1
        self.num_total_packets = 0
        self.num_scramble_packets = 0
        # seconds in the audio PES path (ADTS parse, decode, the subclass's
        # callback) and in the caption decode
        self.audio_seconds = 0.0
        self.caption_seconds = 0.0

        self.packet_parser = _SplitterPacketParser(ctx, self._on_live_batch)
        self._store = bytearray()  # rewind buffer (ref TsPacketBuffer)
        self._buffering = True
        self._live_batch: PacketBatch | None = None
        self._live_synced = 0  # packets of the live batch already in the store
        self.system_clock = TsSystemClock()
        self.selector = TsPacketSelector(ctx)
        self.selector.set_handler(self)

        self.video_parser = VideoFrameParser(ctx, self)
        self.audio_parsers: list[AudioFrameParser] = []
        self.caption_parser = CaptionPesParser(ctx, self, caption_decoder)

        # native steady-state engine (activated after INIT_FINISHED)
        self._engine = None
        self._engine_pes: dict[int, tuple] = {}
        self._engine_modes: dict[int, int] = {}
        self._engine_counts = (0, 0)  # (selected_total, selected_scramble)
        self._suppress_stream = False
        self._want_engine = os.environ.get("AMATSUKAZE_NO_NATIVE", "") == ""
        # packets staged for the engine when init completes MID-chunk
        # (everything after the PCR-acquisition packet belongs to the
        # steady-state engine, not the Python batch loop)
        self._pending_engine_tail: bytearray | None = None

    # -- public -----------------------------------------------------------------
    def reset(self) -> None:
        self.init_phase = PMT_WAITING
        self.prefered_service_id = -1
        self.selected_service_id = -1
        self._buffering = True
        self._store.clear()

    def set_service_id(self, sid: int) -> None:
        self.prefered_service_id = sid

    def get_actual_service_id(self) -> int:
        return self.selected_service_id

    def input_ts_data(self, data: bytes) -> None:
        if self._engine is None and self._want_engine \
                and self.init_phase == INIT_FINISHED:
            self._activate_engine()
        if self._engine is not None:
            self._native_input(data)
        else:
            self.packet_parser.input_ts(data)
            tail = self._pending_engine_tail
            if tail is not None:
                # init completed mid-chunk: hand the already-parsed rest
                # of this chunk to the engine (ahead of the parser's
                # partial-packet tail, which _activate_engine inherits)
                self._pending_engine_tail = None
                self._activate_engine(pre_parsed=bytes(tail))
                if self._engine is None:  # no native lib: Python path
                    self._on_live_batch(
                        PacketBatch(memoryview(bytes(tail))))

    def flush(self) -> None:
        if self._engine is not None:
            self._native_flush()
        else:
            self.packet_parser.flush()
            tail = self._pending_engine_tail
            if tail is not None:  # init completed inside the last chunk
                self._pending_engine_tail = None
                self._activate_engine(pre_parsed=bytes(tail))
                if self._engine is not None:
                    self._native_flush()
                else:
                    self._on_live_batch(
                        PacketBatch(memoryview(bytes(tail))))

    # -- native steady-state engine ------------------------------------------------
    #
    # Once INIT_FINISHED, the per-packet loop (sync scan, PID routing, PES
    # assembly) moves into native/tsdemux.cpp; Python handles the ordered
    # event stream: PSI control packets (pause), PCR clock anchors, and
    # fully-assembled PES units going straight to the frame parsers.

    def _activate_engine(self, pre_parsed: bytes = b"") -> None:
        try:
            from .native import NativeTsEngine
        except Exception:  # pragma: no cover
            self._want_engine = False
            return
        try:
            eng = NativeTsEngine()
        except RuntimeError:
            self._want_engine = False
            return
        self._engine = eng
        # continue global packet numbering + inherit the scan tail/state
        eng.set_packet_count(self.system_clock.num_total_packets)
        eng.set_sync_ok(self.packet_parser._sync_ok)
        tail = bytes(self.packet_parser._buf)
        self.packet_parser._buf.clear()
        self._engine_counts = (0, 0)
        self._program_engine(seed_from_python=True)
        data = pre_parsed + tail
        if data:
            self._native_input(data)

    def _program_engine(self, seed_from_python: bool = False) -> None:
        eng = self._engine
        pes, pause, raw = self.selector.native_routing()
        if not self.enable_video:
            pes = {p: k for p, k in pes.items() if k[0] != "video"}
        if not self.enable_audio:
            pes = {p: k for p, k in pes.items() if k[0] != "audio"}
        if not self.enable_caption:
            pes = {p: k for p, k in pes.items() if k[0] != "caption"}
        modes = {p: 1 for p in pes}
        modes.update({p: 3 for p in pause})
        modes.update({p: 2 for p in raw if p not in modes})
        for pid in set(self._engine_modes) - set(modes):
            eng.set_pid_mode(pid, 0)
        for pid, mode in modes.items():
            if self._engine_modes.get(pid) != mode:
                eng.set_pid_mode(pid, mode)
                if mode == 1:
                    if seed_from_python:
                        parser = self._parser_for(pes[pid])
                        if parser is not None:
                            eng.seed_pes(pid, parser._cc, bytes(parser._buf))
                            parser._buf.clear()
                    else:
                        eng.seed_pes(pid, 0, b"")
        self._engine_modes = modes
        self._engine_pes = pes
        eng.set_pcr_pid(self.system_clock.pcr_pid)

    def _parser_for(self, kind: tuple):
        if kind[0] == "video":
            return self.video_parser
        if kind[0] == "audio":
            return (self.audio_parsers[kind[1]]
                    if kind[1] < len(self.audio_parsers) else None)
        return self.caption_parser

    def _native_input(self, data: bytes) -> None:
        eng = self._engine
        done = eng.input(data)
        while True:
            self._drain_engine_events()
            if done:
                break
            done = self._native_resume()

    def _native_flush(self) -> None:
        eng = self._engine
        done = eng.flush()
        while not done:
            self._drain_engine_events()
            done = self._native_resume()
            if done:
                done = eng.flush()
        # note: pending unbounded-length PES units are NOT flushed — the
        # pure-Python path (like the reference) only emits a unit when the
        # next payload_unit_start arrives, so the trailing unit is dropped
        self._drain_engine_events()

    def _native_resume(self) -> bool:
        """After a pause event was handled, consume the control packet:
        skip it if its pid is still pause-mode (Python processed the PSI),
        otherwise route it under the new modes (video-PID swap)."""
        eng = self._engine
        # the pause event is always the last drained event; modes were
        # reprogrammed in _drain_engine_events
        if self._paused_pid is not None \
                and self._engine_modes.get(self._paused_pid, 0) != 3:
            eng.resume_packet()
        else:
            eng.skip_packet()
        self._paused_pid = None
        return eng.input()

    _paused_pid = None

    def _drain_engine_events(self) -> None:
        eng = self._engine
        clk = self.system_clock
        meta, payload = eng.take_events()
        for t, pid, off, ln, idx, extra in meta:
            t = int(t)
            pid = int(pid)
            idx = int(idx)
            if t == 2:  # PCR / adaptation-field anchor update
                clk.apply_af_event(idx, int(ln), int(extra))
            elif t == 0:  # assembled + validated PES unit
                kind = self._engine_pes.get(pid)
                if kind is None:
                    continue
                pes = PESPacket(bytearray(payload[off:off + ln]))
                if not pes.parse():
                    continue
                clock = clk.clock_at(idx)
                parser = self._parser_for(kind)
                if parser is not None:
                    parser.on_pes_packet(clock, pes)
            elif t == 1:  # raw PSI packet (TDT/TOT)
                pkt = TsPacket(payload[off:off + ln])
                if pkt.parse() and pkt.check():
                    self.selector.input_ts_packet(clk.clock_at(idx), pkt)
            elif t == 3:  # paused at a control packet (PAT/PMT/pending video)
                pkt = TsPacket(payload[off:off + ln])
                if pkt.parse() and pkt.check():
                    # the packet is not yet counted: index = current count
                    if pid == clk.pcr_pid:
                        clk.num_total_packets = idx
                        clk.input_ts_packet(pkt)
                        clk.num_total_packets = idx  # engine re-counts on skip
                    clock = clk.clock_at(idx)
                    self._suppress_stream = True
                    try:
                        self.selector.input_ts_packet(clock, pkt)
                    finally:
                        self._suppress_stream = False
                self._program_engine()
                self._paused_pid = pid
        # fold the engine's selected-stream counters into ours
        st, ss = eng.counter(3), eng.counter(4)
        self.num_total_packets += st - self._engine_counts[0]
        self.num_scramble_packets += ss - self._engine_counts[1]
        self._engine_counts = (st, ss)

    # -- batch routing ------------------------------------------------------------
    #
    # The reference buffers each packet *before* handing it to the phase
    # handler, so a rewind-and-replay triggered mid-stream covers exactly the
    # packets seen so far (TsSplitter.hpp:457-499). We keep that invariant
    # while processing vectorized batches by syncing the live batch into the
    # store lazily, just before each packet that could trigger a replay.

    def _on_live_batch(self, batch: PacketBatch) -> None:
        if self._pending_engine_tail is not None:
            # a mid-chunk engine handoff is staged: every later batch of
            # this chunk belongs to the engine too, in arrival order
            self._pending_engine_tail += bytes(batch.data)
            return
        self._live_batch = batch
        self._live_synced = 0
        try:
            pids = batch.pids
            i = 0
            n = batch.count
            while i < n:
                if self.init_phase == PCR_WAITING:
                    i = self._process_pcr_waiting(batch, pids, i, live=True)
                    continue
                if (self._engine is None and self._want_engine
                        and self.init_phase == INIT_FINISHED):
                    # init just completed mid-batch (PCR acquired, store
                    # replayed): stage the remaining packets for the
                    # native engine instead of the Python loop — the
                    # caller (input_ts_data) activates it once the
                    # packet parser unwinds
                    self._pending_engine_tail = bytearray(
                        batch.data[i * TS_PACKET_LENGTH:])
                    return
                i = self._process_selected(batch, pids, i, live=True)
            self._sync_store(n)
        finally:
            self._live_batch = None

    def _sync_store(self, upto_packets: int) -> None:
        """Append live-batch packets [synced, upto) to the rewind store."""
        if not self._buffering or self._live_batch is None:
            return
        if upto_packets > self._live_synced:
            self._store.extend(
                self._live_batch.data[
                    self._live_synced * TS_PACKET_LENGTH : upto_packets * TS_PACKET_LENGTH
                ]
            )
            self._live_synced = upto_packets
            excess = len(self._store) // TS_PACKET_LENGTH - MAX_BUFFERED_PACKETS
            if excess > 0:
                del self._store[: excess * TS_PACKET_LENGTH]

    def _process_pcr_waiting(self, batch, pids, start: int, live: bool) -> int:
        """Only PCR packets matter; skip everything else vectorized."""
        clk = self.system_clock
        idxs = np.flatnonzero(pids[start:] == clk.pcr_pid) + start
        base = clk.num_total_packets - start
        for i in idxs:
            i = int(i)
            if live:
                self._sync_store(i + 1)
            clk.num_total_packets = base + i
            pkt = batch.packet(i)
            if pkt.parse() and pkt.check():
                clk.input_ts_packet(pkt)
            else:
                clk.num_total_packets += 1
            if clk.pcr_received():
                self._finish_init()
                # _finish_init replayed the store; the clock count is now the
                # global packet index just past the current packet
                return i + 1
        clk.num_total_packets = base + batch.count
        return batch.count

    def _process_selected(self, batch, pids, start: int, live: bool) -> int:
        clk = self.system_clock
        sel = self.selector
        n = batch.count
        i = start
        while i < n:
            base = clk.num_total_packets - i
            version = sel.table_version
            interesting = set(sel.active_pids())
            if clk.pcr_pid != -1:
                interesting.add(clk.pcr_pid)
            mask = np.isin(pids[i:], np.fromiter(interesting, dtype=pids.dtype,
                                                 count=len(interesting)))
            idxs = np.flatnonzero(mask) + i
            done_through = n
            for j in idxs:
                j = int(j)
                pkt = batch.packet(j)
                if not (pkt.parse() and pkt.check()):
                    continue
                if live:
                    self._sync_store(j + 1)
                clk.num_total_packets = base + j
                clk.input_ts_packet(pkt)
                packet_clock = clk.get_clock(0)
                sel.input_ts_packet(packet_clock, pkt)
                if self.init_phase == PCR_WAITING:
                    # PMT just arrived: on_pmt_updated replayed the store
                    # through PCR detection; continue after this packet
                    return j + 1
                if sel.table_version != version:
                    done_through = j + 1
                    break  # PID table changed: recompute the prefilter
            clk.num_total_packets = base + done_through
            i = done_through
        return n

    # -- init phase machinery -----------------------------------------------------
    def on_pmt_updated(self, pcr_pid: int) -> None:
        if self.init_phase == PMT_WAITING:
            self.init_phase = PCR_WAITING
            self.system_clock.set_pcr_pid(pcr_pid)
            self.selector.reset_parser()
            self.system_clock.back_ts()
            self._replay(PCR_WAITING)

    def _finish_init(self) -> None:
        self.ctx.debug("PCR acquired; re-reading TS from the start")
        self.init_phase = INIT_FINISHED
        self.selector.reset_parser()
        self.system_clock.back_ts()
        start_clock = self.system_clock.get_clock(0)
        self.ctx.info("start clock: %d", start_clock)
        self.selector.set_start_clock(start_clock)
        self._replay(INIT_FINISHED)
        self._buffering = False
        self._store.clear()

    def _replay(self, phase: int) -> None:
        """Re-feed the rewind store through the current phase's path."""
        if not self._store:
            return
        batch = PacketBatch(memoryview(bytes(self._store)))
        pids = batch.pids
        i = 0
        while i < batch.count and self.init_phase == phase:
            if phase == PCR_WAITING:
                i = self._process_pcr_waiting(batch, pids, i, live=False)
            else:
                i = self._process_selected(batch, pids, i, live=False)

    # -- selector callbacks ---------------------------------------------------------
    def on_pid_select(self, tsid: int, sids: list[int]) -> int:
        self.ctx.info("[PAT update]")
        for i, sid in enumerate(sids):
            if self.prefered_service_id == sid:
                self.selected_service_id = sid
                self.ctx.info("selected service %d", sid)
                return i
        if self.prefered_service_id > 0:
            self.ctx.error(
                "requested service %d not found in %s",
                self.prefered_service_id,
                sids,
            )
        if not sids:
            return -1
        self.selected_service_id = sids[0]
        self.ctx.info("selected service %d (no preference given)", sids[0])
        return 0

    def on_pid_table_changed(self, video: PMTESInfo, audio: list[PMTESInfo],
                             caption: PMTESInfo) -> None:
        if self.enable_video or self.enable_audio:
            if video.stype == 0x02:
                self.video_parser.set_stream_format(VideoStreamFormat.MPEG2)
            elif video.stype == 0x1B:
                self.video_parser.set_stream_format(VideoStreamFormat.H264)
            elif video.stype == 0x24:
                self.video_parser.set_stream_format(VideoStreamFormat.H265)
            while len(self.audio_parsers) < len(audio):
                idx = len(self.audio_parsers)
                self.audio_parsers.append(
                    AudioFrameParser(self.ctx, self, idx, self._audio_decoder_factory)
                )
                self.ctx.info("added audio parser %d", idx)
            for idx, es in enumerate(audio):
                self.audio_parsers[idx].set_stream_type(es.stype)

    def _check_scramble(self, packet: TsPacket) -> bool:
        self.num_total_packets += 1
        if packet.transport_scrambling_control:
            self.num_scramble_packets += 1
            return False
        return True

    def on_video_packet(self, clock: int, packet: TsPacket) -> None:
        if self._suppress_stream:
            return  # the native engine will route this packet itself
        if self.enable_video and self._check_scramble(packet):
            self.video_parser.on_ts_packet(clock, packet)

    def on_audio_packet(self, clock: int, packet: TsPacket, audio_idx: int) -> None:
        if self._suppress_stream:
            return
        if self.enable_audio and self._check_scramble(packet):
            if audio_idx < len(self.audio_parsers):
                self.audio_parsers[audio_idx].on_ts_packet(clock, packet)

    def on_caption_packet(self, clock: int, packet: TsPacket) -> None:
        if self._suppress_stream:
            return
        if self.enable_caption and self._check_scramble(packet):
            self.caption_parser.on_ts_packet(clock, packet)

    # -- subclass interface -----------------------------------------------------------
    def on_video_pes_packet(self, clock, frames, packet) -> None:
        raise NotImplementedError

    def on_video_format_changed(self, fmt: VideoFormat) -> None:
        raise NotImplementedError

    def on_audio_pes_packet(self, audio_idx, clock, frames, packet) -> None:
        raise NotImplementedError

    def on_audio_format_changed(self, audio_idx, fmt: AudioFormat) -> None:
        raise NotImplementedError

    def on_caption_pes_packet(self, clock, captions, packet) -> None:
        pass

    def on_time(self, clock, jst_time) -> None:
        pass
