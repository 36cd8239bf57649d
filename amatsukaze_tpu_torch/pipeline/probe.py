"""Probe modes: subtitles / audio-format / DRCS search.

Parity: detectSubtitleMain / detectAudioMain / searchDrcsMain and their
TsSplitter subclasses (Amatsukaze/TranscodeManager.hpp:868-1110): read the
middle 10-90% of the file with an early stop after max_frames video frames.

The port's copy of amatsukaze_tpu/pipeline/probe.py.
"""

from __future__ import annotations

import os

from ..ts.splitter import TsSplitter
from ..types import AUDIO_CHANNEL_NAMES


class _StopProbe(Exception):
    pass


class _ProbeSplitter(TsSplitter):
    def __init__(self, ctx, max_frames: int, **kw):
        super().__init__(ctx, **kw)
        self.max_frames = max_frames
        self.num_frames = 0

    def on_video_pes_packet(self, clock, frames, packet):
        self.num_frames += len(frames)
        if self.num_frames >= self.max_frames:
            raise _StopProbe()

    def on_video_format_changed(self, fmt):
        pass

    def on_audio_pes_packet(self, audio_idx, clock, frames, packet):
        pass

    def on_audio_format_changed(self, audio_idx, fmt):
        pass


class _SubtitleProbe(_ProbeSplitter):
    def __init__(self, ctx, max_frames, caption_decoder=None):
        super().__init__(ctx, max_frames, enable_video=True, enable_audio=False,
                         enable_caption=True, caption_decoder=caption_decoder)
        self.has_subtitles = False
        self.caption_pid_seen = False

    def on_caption_packet(self, clock, packet):
        # PID presence alone indicates a caption stream
        self.caption_pid_seen = True
        self.has_subtitles = True
        super().on_caption_packet(clock, packet)

    def on_caption_pes_packet(self, clock, captions, packet):
        self.has_subtitles = True


class _AudioProbe(_ProbeSplitter):
    def __init__(self, ctx, max_frames):
        super().__init__(ctx, max_frames, enable_video=True, enable_audio=True,
                         enable_caption=False)
        self.formats: list = []

    def on_audio_format_changed(self, audio_idx, fmt):
        self.formats.append((audio_idx, fmt))


def _probe_run(sp, path: str, max_frames: int) -> None:
    """Read from 10% into the file, up to 90% (ref :940-958)."""
    size = os.path.getsize(path)
    start = size // 10 // 188 * 188
    end = size * 9 // 10
    with open(path, "rb") as f:
        f.seek(start)
        pos = start
        try:
            while pos < end:
                chunk = f.read(4 * 1024 * 1024)
                if not chunk:
                    break
                pos += len(chunk)
                sp.input_ts_data(chunk)
            sp.flush()
        except _StopProbe:
            pass


def probe_subtitles(ctx, settings, caption_decoder=None) -> bool:
    sp = _SubtitleProbe(ctx, settings.conf.max_frames, caption_decoder)
    if settings.conf.service_id > 0:
        sp.set_service_id(settings.conf.service_id)
    _probe_run(sp, settings.conf.src_file_path, settings.conf.max_frames)
    return sp.has_subtitles


def probe_audio(ctx, settings) -> list[str]:
    sp = _AudioProbe(ctx, settings.conf.max_frames)
    if settings.conf.service_id > 0:
        sp.set_service_id(settings.conf.service_id)
    _probe_run(sp, settings.conf.src_file_path, settings.conf.max_frames)
    out = []
    for idx, fmt in sp.formats:
        name = AUDIO_CHANNEL_NAMES.get(fmt.channels, "?")
        out.append(f"audio{idx}: {name} {fmt.sample_rate}Hz")
    return out


def default_caption_decoder(ctx, settings):
    """The in-build ARIB decoder with the DRCS-dir convention shared
    with TranscodePipeline: unmapped bitmaps land beside the --drcs
    mapping file (ref searchDrcsMain + DRCSManager layout)."""
    from ..captions.b24 import CaptionDecoder

    drcs_dir = settings.conf.drcs_out_path
    if not drcs_dir and settings.conf.drcs_map_path:
        drcs_dir = os.path.dirname(
            os.path.abspath(settings.conf.drcs_map_path))
    return CaptionDecoder(ctx, drcs_out_dir=drcs_dir)


def search_drcs(ctx, settings, caption_decoder=None) -> None:
    """Scan the whole file for unmapped DRCS (ref searchDrcsMain :1102-1110)."""
    if caption_decoder is None:
        caption_decoder = default_caption_decoder(ctx, settings)
    sp = _SubtitleProbe(ctx, 1 << 30, caption_decoder)
    if settings.conf.service_id > 0:
        sp.set_service_id(settings.conf.service_id)
    with open(settings.conf.src_file_path, "rb") as f:
        while True:
            chunk = f.read(4 * 1024 * 1024)
            if not chunk:
                break
            sp.input_ts_data(chunk)
        sp.flush()
