"""Final mux stage: gather the encoded video, audio tracks, captions,
chapters and timecodes for one output file and drive the external muxer.

Parity: AMTMuxder / AMTSimpleMuxder (ref Amatsukaze/Muxer.hpp:28-306).
The host-side orchestration is a straight behavioural match; nothing here
touches the device.

The port's copy of amatsukaze_tpu/io/muxer.py.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field

from ..pipeline.encoder_options import EncoderDeint, EncoderOptionInfo
from ..pipeline.settings import (
    NICOJK_TYPES,
    AudioEncoder,
    OutputFormat,
    Settings,
    make_muxer_args,
)
from ..ts.adts import DualMonoSplitter
from ..types import AudioChannels, EncodeFileKey, VideoFormat, VideoStreamFormat
from .process import SubProcess


@dataclass
class MuxResult:
    """Mux byproducts (ref EncodeFileOutput, Muxer.hpp:18-26)."""

    out_path: str = ""
    out_subs: list = field(default_factory=list)
    file_size: int = 0


def _run_command(cmd: str, show: bool) -> int:
    proc = SubProcess(cmd)
    proc.stdin.close()
    return proc.join()


class AudioCache:
    """Random access to the demuxed ADTS frames captured during the split
    phase (ref PacketCache over getAudioFilePath(), Muxer.hpp:37)."""

    def __init__(self, path: str, offsets: list[int]):
        self.path = path
        self.offsets = offsets

    def __getitem__(self, index: int) -> bytes:
        start = self.offsets[index]
        end = self.offsets[index + 1]
        with open(self.path, "rb") as f:
            f.seek(start)
            return f.read(end - start)


def _mul_div_fps(vfmt: VideoFormat, mul: int, div: int) -> None:
    vfmt.frame_rate_num = vfmt.frame_rate_num * mul // div


def adjust_video_format(vfmt: VideoFormat, eo_info: EncoderOptionInfo,
                        ctx=None) -> VideoFormat:
    """Reflect encoder-side decimation / deinterlacing in the container fps
    (ref Muxer.hpp:48-80)."""
    import copy

    vfmt = copy.deepcopy(vfmt)
    if eo_info.select_every > 1:
        _mul_div_fps(vfmt, 1, eo_info.select_every)
    if not vfmt.progressive:
        if eo_info.deint == EncoderDeint.D24P:
            _mul_div_fps(vfmt, 4, 5)
            vfmt.progressive = True
        elif eo_info.deint in (EncoderDeint.D30P, EncoderDeint.VFR):
            vfmt.progressive = True
        elif eo_info.deint == EncoderDeint.D60P:
            _mul_div_fps(vfmt, 2, 1)
            vfmt.progressive = True
    elif eo_info.deint != EncoderDeint.NONE and ctx is not None:
        ctx.warn("encoder input is progressive but the encoder options "
                 "request deinterlacing")
    return vfmt


class Muxer:
    """Gathers per-output-file elementary streams and runs the muxer
    command sequence (ref AMTMuxder, Muxer.hpp:28-245)."""

    def __init__(self, ctx, settings: Settings, reform,
                 aac_decoder_factory=None, runner=None):
        self.ctx = ctx
        self.settings = settings
        self.reform = reform
        self.aac_decoder_factory = aac_decoder_factory
        # runner(cmd: str, show: bool) -> int, replaceable for tests
        self.runner = runner or self._run

    def _run(self, cmd: str, show: bool) -> int:
        return _run_command(cmd, show)

    # ----------------------------------------------------------- audio
    def _write_audio_files(self, key: EncodeFileKey) -> list[str]:
        """Write per-track ADTS files, splitting dual-mono into two mono
        AAC streams when we are not re-encoding (ref Muxer.hpp:82-119)."""
        st = self.settings
        if st.conf.audio_encoder != AudioEncoder.NONE:
            return [st.int_audio_file_path(key, 0)]

        file = self.reform.get_encode_file(key)
        fmt = self.reform.get_format(key)
        cache = AudioCache(st.audio_file_path(),
                           self.reform.get_audio_file_offsets())
        audio_files: list[str] = []
        adst = 0
        for asrc, frame_list in enumerate(file.audio_frames):
            if not frame_list:
                continue
            is_dual_mono = (
                fmt.audio_format[asrc].channels == AudioChannels.CH_2LANG
            )
            if is_dual_mono and self.aac_decoder_factory is not None:
                self.ctx.info(
                    "audio %d-%d is dual-mono; splitting into two AAC files",
                    file.out_key.format, asrc)
                path0 = st.int_audio_file_path(key, adst)
                adst += 1
                path1 = st.int_audio_file_path(key, adst)
                adst += 1
                outs = [open(path0, "wb"), open(path1, "wb")]
                try:
                    splitter = _FileDualMonoSplitter(
                        self.ctx, self.aac_decoder_factory(), outs)
                    for frame_index in frame_list:
                        splitter.input_packet(cache[frame_index])
                finally:
                    for f in outs:
                        f.close()
                audio_files.extend([path0, path1])
            else:
                if is_dual_mono:
                    self.ctx.info(
                        "audio %d-%d is dual-mono but no AAC decoder is "
                        "available; keeping it unsplit",
                        file.out_key.format, asrc)
                path = st.int_audio_file_path(key, adst)
                adst += 1
                with open(path, "wb") as f:
                    for frame_index in frame_list:
                        f.write(cache[frame_index])
                audio_files.append(path)
        return audio_files

    # ----------------------------------------------------------- subs
    def _gather_subs(self, key: EncodeFileKey, nico_ok: bool,
                     result: MuxResult,
                     copy_out: bool = False) -> tuple[list[str], list[str]]:
        """MKV embeds ASS/SRT; MP4/M2TS copy ASS out as side files and embed
        only SRT (ref Muxer.hpp:134-167). `copy_out=True` forces the
        side-file behaviour for every format (used by the in-build remux
        path, which cannot embed subtitle tracks)."""
        st = self.settings
        file = self.reform.get_encode_file(key)
        is_mkv = st.conf.format == OutputFormat.MKV and not copy_out
        subs_files: list[str] = []
        subs_titles: list[str] = []

        if nico_ok:
            for jktype in st.nicojk_types:
                src = st.tmp_nicojk_ass_path(key, jktype)
                if is_mkv:
                    subs_files.append(src)
                    subs_titles.append(f"NicoJK{NICOJK_TYPES[jktype]}")
                else:
                    dst = st.out_ass_path(file.out_key, file.key_max, -1,
                                          jktype)
                    shutil.copyfile(src, dst)
                    result.out_subs.append(dst)

        for lang in range(len(file.caption_list)):
            src_ass = st.tmp_ass_path(key, lang)
            if is_mkv:
                subs_files.append(src_ass)
                subs_titles.append("ASS")
            else:
                dst = st.out_ass_path(file.out_key, file.key_max, lang)
                shutil.copyfile(src_ass, dst)
                result.out_subs.append(dst)
            src_srt = st.tmp_srt_path(key, lang)
            if os.path.exists(src_srt):
                if copy_out:
                    # in-build remux cannot embed tracks: SRT becomes an
                    # out-path side file like the ASS above
                    dst = st.out_sub_path(file.out_key, file.key_max, lang,
                                          ext=".srt")
                    shutil.copyfile(src_srt, dst)
                    result.out_subs.append(dst)
                else:
                    subs_files.append(src_srt)
                    subs_titles.append("SRT")
        return subs_files, subs_titles

    # ----------------------------------------------------------- meta
    def _write_m2ts_meta(self, key: EncodeFileKey, vfmt: VideoFormat,
                         video_file: str, audio_files: list[str],
                         subs_files: list[str]) -> str:
        """tsMuxeR meta file (ref Muxer.hpp:171-198)."""
        st = self.settings
        codec = {
            VideoStreamFormat.MPEG2: "V_MPEG-2",
            VideoStreamFormat.H264: "V_MPEG4/ISO/AVC",
            VideoStreamFormat.H265: "V_MPEGH/ISO/HEVC",
        }.get(vfmt.format, "V_MPEG-2")
        fps = vfmt.frame_rate_num / vfmt.frame_rate_denom
        lines = ["MUXOPT", f'{codec}, "{video_file}", fps={fps:.3f}']
        for apath in audio_files:
            lines.append(f'A_AAC, "{apath}"')
        for spath in subs_files:
            lines.append(
                f'S_TEXT/UTF8, "{spath}", fps={fps:.3f}, '
                f"video-width={vfmt.width}, video-height={vfmt.height}"
            )
        meta = st.m2ts_meta_path(key)
        with open(meta, "w") as f:
            f.write("\n".join(lines) + "\n")
        return meta

    # ----------------------------------------------------------- mux
    def mux(self, key: EncodeFileKey, eo_info: EncoderOptionInfo,
            nico_ok: bool, vfmt: VideoFormat, vfr_timing_fps: int = 30,
            timecode_path: str = "") -> MuxResult:
        """(ref AMTMuxder::mux, Muxer.hpp:40-225)."""
        st = self.settings
        file = self.reform.get_encode_file(key)
        result = MuxResult()

        vfmt = adjust_video_format(vfmt, eo_info, self.ctx)
        audio_files = self._write_audio_files(key)
        enc_video = st.enc_video_file_path(key)

        chapter_file = ""
        if st.conf.chapter:
            path = st.tmp_chapter_path(key)
            if os.path.exists(path):
                chapter_file = path

        subs_files, subs_titles = self._gather_subs(key, nico_ok, result)

        meta_file = ""
        if st.conf.format in (OutputFormat.M2TS, OutputFormat.TS):
            meta_file = self._write_m2ts_meta(key, vfmt, enc_video,
                                              audio_files, subs_files)

        # timelineeditor timescale: 60/120fps VFR timing scales the
        # media timescale (ref Muxer.hpp:201)
        timebase = (vfmt.frame_rate_num * (vfr_timing_fps // 30),
                    vfmt.frame_rate_denom)

        out_path = st.out_file_path(file.out_key, file.key_max)
        args = make_muxer_args(
            st.conf.format, st.conf.muxer_path, st.conf.timelineeditor_path,
            st.conf.mp4box_path, enc_video, vfmt, audio_files, out_path,
            st.vfr_tmp_file_path(key), chapter_file, timecode_path, timebase,
            subs_files, subs_titles, meta_file,
        )
        for cmd, show in args:
            self.ctx.info("%s", cmd)
            ret = self.runner(cmd, show)
            if ret != 0:
                raise RuntimeError(f"mux failed (exit code: {ret})")

        result.out_path = out_path
        if os.path.exists(out_path):
            result.file_size = os.path.getsize(out_path)
        return result


class _FileDualMonoSplitter(DualMonoSplitter):
    """DualMonoSplitter writing each mono stream to a file
    (ref SpDualMonoSplitter, Muxer.hpp:228-239)."""

    def __init__(self, ctx, decoder, files):
        super().__init__(ctx, decoder)
        self.files = files

    def on_out_frame(self, index: int, data: bytes) -> None:
        self.files[index].write(data)


class SimpleMuxer:
    """Plain video+audio MP4 mux for `--mode g` style simple runs
    (ref AMTSimpleMuxder, Muxer.hpp:247-306)."""

    def __init__(self, ctx, settings: Settings, runner=None):
        self.ctx = ctx
        self.settings = settings
        self.total_out_size = 0
        self.runner = runner or _run_command

    def mux(self, video_format: VideoFormat, audio_count: int) -> None:
        st = self.settings
        key = EncodeFileKey()
        audio_files = [st.int_audio_file_path(key, i)
                       for i in range(audio_count)]
        enc_video = st.enc_video_file_path(key)
        out_path = st.out_file_path(key, key)
        args = make_muxer_args(
            OutputFormat.MP4, st.conf.muxer_path,
            st.conf.timelineeditor_path, st.conf.mp4box_path, enc_video,
            video_format, audio_files, out_path, "", "", "", (0, 0), [], [],
            "",
        )
        self.ctx.info("[mux start]")
        self.ctx.info("%s", args[0][0])
        ret = self.runner(args[0][0], False)
        if ret != 0:
            raise RuntimeError(f"mux failed (muxer exit code: {ret})")
        self.total_out_size += os.path.getsize(out_path)
