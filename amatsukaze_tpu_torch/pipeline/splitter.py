"""Demux-to-intermediates splitter feeding StreamReform.

Parity: AMTSplitter (Amatsukaze/TranscodeManager.hpp:28-343): consumes the TS
via TsSplitter, writes per-video-file intermediates, appends coded audio to
`audio.dat` and decoded PCM to `audio.wav`, and collects the frame/event/
caption/time lists that StreamReformInfo::prepare consumes. Intermediate
video is wrapped in MPEG2-PS (`i{n}.mpg`) by io.ps_writer, matching the
reference's intermediate format (readable by standard demuxers).

split() adds to the counters of ctx.trace: `split.ts_bytes`, and the
seconds `split.ps_write_s` (the PS writer and the intermediate's writes),
`split.audio_s` (the audio PES path and the wave decode, without its PS
writes) and `split.caption_s`.

The port's copy of amatsukaze_tpu/pipeline/splitter.py.
"""

from __future__ import annotations

import io
import os
import time

from ..reform.stream_reform import (
    FileAudioFrameInfo,
    FileVideoFrameInfo,
    StreamEvent,
    StreamEventType,
    StreamReformInfo,
)
from ..io.ps_writer import PsStreamWriter
from ..ts.splitter import TsSplitter
from ..types import AUDIO_CHANNEL_NAMES, VideoFormat


class AMTSplitter(TsSplitter):
    def __init__(self, ctx, settings, audio_decoder_factory=None,
                 caption_decoder=None):
        super().__init__(
            ctx,
            enable_video=True,
            enable_audio=True,
            enable_caption=settings.conf.subtitles,
            audio_decoder_factory=audio_decoder_factory,
            caption_decoder=caption_decoder,
        )
        self.settings = settings
        if settings.conf.service_id > 0:
            self.set_service_id(settings.conf.service_id)
        self._audio_file = open(settings.audio_file_path(), "wb")
        self._wave_file = open(settings.wave_file_path(), "wb")
        self._video_file = None
        self._ps_writer = PsStreamWriter(ctx, self._on_ps_data)
        self._video_stream_type = -1
        self._audio_stream_type = -1
        self._cur_video_format = VideoFormat()
        self.video_file_count = 0
        self._int_video_size = 0
        self.total_int_video_size = 0
        self._audio_file_size = 0
        self._wave_file_size = 0
        self.src_file_size = 0
        # seconds in the PS writer (all of it, and of the audio path's)
        self._ps_seconds = 0.0
        self._ps_audio_seconds = 0.0

        self.video_frame_list: list[FileVideoFrameInfo] = []
        self.audio_frame_list: list[FileAudioFrameInfo] = []
        self.stream_event_list: list[StreamEvent] = []
        self.caption_list: list = []
        self.time_list: list = []

    # -- main entry ---------------------------------------------------------
    def split(self) -> StreamReformInfo:
        self._read_all()
        self._close_files()
        trace = self.ctx.trace
        trace.add("split.ts_bytes", self.src_file_size)
        trace.add("split.ps_write_s", self._ps_seconds)
        trace.add("split.audio_s", self.audio_seconds - self._ps_audio_seconds)
        trace.add("split.caption_s", self.caption_seconds)
        self._print_interlace_stats()
        return StreamReformInfo(
            self.ctx,
            self.video_file_count,
            self.video_frame_list,
            self.audio_frame_list,
            self.caption_list,
            self.stream_event_list,
            self.time_list,
        )

    def _read_all(self, bufsize: int = 4 * 1024 * 1024) -> None:
        path = self.settings.conf.src_file_path
        self.src_file_size = os.path.getsize(path)
        with open(path, "rb") as f:
            while True:
                chunk = f.read(bufsize)
                if not chunk:
                    break
                self.input_ts_data(chunk)
        self.flush()

    def _close_files(self) -> None:
        self._audio_file.close()
        self._wave_file.close()
        if self._video_file:
            self._video_file.close()
            self._video_file = None

    def _print_interlace_stats(self) -> None:
        if not self.video_frame_list:
            self.ctx.error("no video frames")
            return
        from collections import Counter

        counts = Counter(f.pic.name for f in self.video_frame_list)
        self.ctx.info("[video frame statistics] %s", dict(counts))

    # -- TsSplitter callbacks ---------------------------------------------------
    def _on_ps_data(self, data: bytes) -> None:
        if self._video_file is not None:
            self._video_file.write(data)
            self._int_video_size += len(data)
            self.total_int_video_size += len(data)

    def on_video_pes_packet(self, clock, frames, packet) -> None:
        for frame in frames:
            info = FileVideoFrameInfo(
                pts=frame.pts, dts=frame.dts, is_gop_start=frame.is_gop_start,
                progressive=frame.progressive, pic=frame.pic, type=frame.type,
                coded_data_size=frame.coded_data_size, format=frame.format,
                file_offset=self._int_video_size,
            )
            self.video_frame_list.append(info)
        t0 = time.perf_counter()
        self._ps_writer.out_video_pes_packet(clock, frames, packet)
        self._ps_seconds += time.perf_counter() - t0

    def on_video_format_changed(self, fmt: VideoFormat) -> None:
        dar = fmt.get_dar()
        self.ctx.info(
            "[video format change] %dx%d (%d:%d) FPS: %s",
            fmt.width, fmt.height, dar[0], dar[1],
            f"{fmt.frame_rate_num}/{fmt.frame_rate_denom}"
            if fmt.fixed_frame_rate else "VFR",
        )
        if not self._cur_video_format.is_basic_equals(fmt):
            # size/fps change -> new intermediate file (must stay in sync
            # with StreamReform's sectioning, ref :253-259)
            if self._video_file:
                self._video_file.close()
            self._video_file = open(
                self.settings.int_video_file_path(self.video_file_count), "wb"
            )
            self.video_file_count += 1
            self._int_video_size = 0
            t0 = time.perf_counter()
            self._ps_writer.out_header(self._video_stream_type,
                                       self._audio_stream_type)
            self._ps_seconds += time.perf_counter() - t0
        self._cur_video_format = fmt
        self.stream_event_list.append(
            StreamEvent(StreamEventType.VIDEO_FORMAT_CHANGED,
                        frame_idx=len(self.video_frame_list))
        )

    def on_audio_pes_packet(self, audio_idx, clock, frames, packet) -> None:
        for frame in frames:
            info = FileAudioFrameInfo(
                pts=frame.pts,
                num_samples=frame.num_samples,
                format=frame.format,
                audio_idx=audio_idx,
                coded_data_size=len(frame.coded_data),
                wave_data_size=len(frame.decoded_data),
                file_offset=self._audio_file_size,
                wave_offset=self._wave_file_size,
            )
            self._audio_file.write(frame.coded_data)
            self._audio_file_size += len(frame.coded_data)
            if frame.decoded_data:
                self._wave_file.write(frame.decoded_data)
                self._wave_file_size += len(frame.decoded_data)
            self.audio_frame_list.append(info)
        if self.video_file_count > 0:
            t0 = time.perf_counter()
            self._ps_writer.out_audio_pes_packet(audio_idx, clock, frames,
                                                 packet)
            dt = time.perf_counter() - t0
            self._ps_seconds += dt
            self._ps_audio_seconds += dt

    def on_audio_format_changed(self, audio_idx, fmt) -> None:
        self.ctx.info(
            "[audio %d format change] channels: %s sample rate: %d",
            audio_idx, AUDIO_CHANNEL_NAMES.get(fmt.channels, "?"), fmt.sample_rate,
        )
        self.stream_event_list.append(
            StreamEvent(StreamEventType.AUDIO_FORMAT_CHANGED,
                        frame_idx=len(self.audio_frame_list),
                        audio_idx=audio_idx)
        )

    def on_caption_pes_packet(self, clock, captions, packet) -> None:
        self.caption_list.extend(captions)

    def on_pid_table_changed(self, video, audio, caption) -> None:
        super().on_pid_table_changed(video, audio, caption)
        self._video_stream_type = video.stype
        self._audio_stream_type = audio[0].stype if audio else -1
        self.stream_event_list.append(
            StreamEvent(StreamEventType.PID_TABLE_CHANGED,
                        frame_idx=len(self.video_frame_list),
                        num_audio=len(audio))
        )

    def on_time(self, clock, jst_time) -> None:
        self.time_list.append((clock, jst_time))
