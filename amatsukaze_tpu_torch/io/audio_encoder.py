"""Audio encode feed: stream reform-selected wave frames as WAV into the
audio encoder's stdin (ref Amatsukaze/AudioEncoder.hpp:36-106).

The port's copy of amatsukaze_tpu/io/audio_encoder.py.
"""

from __future__ import annotations

import os

from ..pipeline.settings import make_audio_encoder_args
from ..types import NUM_AUDIO_CHANNELS
from .process import SubProcess
from .wave import wave_header


def encode_audio(ctx, settings, reform, key, audio_index: int) -> str:
    """Encode one output file's audio track via the external encoder.
    Returns the output path."""
    conf = settings.conf
    out_path = settings.int_audio_file_path(key, audio_index)
    file = reform.get_encode_file(key)
    frame_indices = file.audio_frames[audio_index]
    fmt = reform.get_format(key).audio_format[audio_index]
    nch = NUM_AUDIO_CHANNELS.get(fmt.channels, 2)

    from ..pipeline.settings import resolve_audio_encoder_command

    args = make_audio_encoder_args(
        conf.audio_encoder, conf.audio_encoder_path,
        conf.audio_encoder_options, conf.audio_bitrate_kbps, out_path,
    )
    args = resolve_audio_encoder_command(args)
    ctx.info("%s", args)
    proc = SubProcess(args)
    wave_frames = reform.get_wave_input(frame_indices)
    total = sum(wf.wave_length for wf in wave_frames)
    proc.stdin.write(wave_header(nch, fmt.sample_rate, 16, total))
    with open(settings.wave_file_path(), "rb") as wav:
        for wf in wave_frames:
            if wf.wave_offset < 0:
                continue
            wav.seek(wf.wave_offset)
            proc.stdin.write(wav.read(wf.wave_length))
    rc = proc.join()
    if rc != 0:
        raise RuntimeError(f"audio encoder failed ({rc})")
    return out_path
