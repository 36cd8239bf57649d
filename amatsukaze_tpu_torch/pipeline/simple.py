"""Generic-file (`--mode g`) transcode: decode -> encode -> simple mux.

Parity: transcodeSimpleMain + AMTSimpleVideoEncoder
(Amatsukaze/TranscodeManager.hpp:832-865, Encoder.hpp:266-476): a plain
one-file transcode with no TS reform/CM analysis — decode frames (with RFF
expansion when the decoder flags pulldown), feed the encoder over y4m,
passthrough-encode the audio tracks, then mux a plain MP4. The decoder is
pluggable like the main pipeline's (ffmpeg subprocess when available).

The port's copy of amatsukaze_tpu/pipeline/simple.py.
"""

from __future__ import annotations

import json
import os

from ..io.muxer import SimpleMuxer
from ..io.process import DataPumpThread, SubProcess
from ..io.y4m import Y4MFormat, Y4MWriter
from ..types import EncodeFileKey, VideoFormat
from .settings import Settings, make_encoder_args


class SimpleTranscode:
    def __init__(self, ctx, settings: Settings, decoder=None,
                 muxer_runner=None):
        """decoder: callable(src_path) -> (VideoFormat, iterator of
        (Y, U, V) planes, audio_tracks: list of file paths)."""
        self.ctx = ctx
        self.settings = settings
        self.decoder = decoder
        self.muxer_runner = muxer_runner

    def run(self) -> dict:
        ctx, st = self.ctx, self.settings
        src = st.conf.src_file_path
        if src.endswith(".ts"):
            ctx.warn("generic mode is not recommended for TS files")
        if self.decoder is None:
            raise RuntimeError("no decoder available for generic mode")

        fmt, frames, audio_tracks = self.decoder(src)
        key = EncodeFileKey()
        args = make_encoder_args(
            st.conf.encoder, st.conf.encoder_path, st.conf.encoder_options,
            fmt, st.enc_video_file_path(key),
        )
        ctx.info("%s", args)
        from .settings import resolve_encoder_command

        args = resolve_encoder_command(args, st.conf.encoder)
        proc = SubProcess(args)
        writer = Y4MWriter(proc.stdin, Y4MFormat(
            width=fmt.width, height=fmt.height,
            fps_num=fmt.frame_rate_num, fps_den=fmt.frame_rate_denom,
            interlaced=not fmt.progressive,
            sar_num=fmt.sar_width, sar_den=fmt.sar_height,
        ))
        pump = DataPumpThread(lambda planes: writer.write_frame(*planes),
                              max_items=max(4, st.conf.num_encode_buffer_frames))
        n = 0
        for planes in frames:
            pump.put(planes)
            n += 1
        pump.join()
        rc = proc.join()
        if rc != 0:
            raise RuntimeError(f"encoder failed ({rc})")
        ctx.info("encoded %d frames", n)

        # audio tracks arrive as ready files; copy into the int-audio slots
        for i, path in enumerate(audio_tracks):
            dst = st.int_audio_file_path(key, i)
            if os.path.abspath(path) != os.path.abspath(dst):
                import shutil

                shutil.copyfile(path, dst)

        muxer = SimpleMuxer(ctx, st, runner=self.muxer_runner)
        muxer.mux(fmt, len(audio_tracks))

        report = {
            "srcpath": src,
            "outpath": st.out_file_path(key, key),
            "srcfilesize": os.path.getsize(src) if os.path.exists(src) else 0,
            "outfilesize": muxer.total_out_size,
        }
        if st.conf.out_info_json_path:
            with open(st.conf.out_info_json_path, "w") as f:
                json.dump(report, f)
        return report
