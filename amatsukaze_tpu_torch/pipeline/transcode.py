"""End-to-end transcode orchestration.

Parity: transcodeMain (Amatsukaze/TranscodeManager.hpp:455-830) +
EncoderArgumentGenerator (:345-405) + MakeBitrateZones (:407-442):

  split -> scramble check -> DRCS check -> reform -> NicoJK -> per-video-file
  CM/logo analysis -> applyCMZones/genAudio -> captions/chapters per output
  file -> per-output-file filter+encode (y4m over the encoder's stdin via a
  bounded pump) -> mux -> JSON report (same field names as the reference's).

The port's counterpart of amatsukaze_tpu/pipeline/transcode.py. The host
orchestration is the JAX package's; the device work is the port's own:
the CM analysis is pipeline/cm_stage.py (one upload per luma batch feeds
the scene metrics and the logo kernel) and the filter is
pipeline/filter_stage.py, whose analysis step gives the output spec before
the encoder starts and whose output pass runs once per encoder pass.

Deliberate differences from the JAX pipeline:

- ensure_cuda_backend raises when no CUDA card is present (unless the
  caller passes device="cpu"); it never falls back to the CPU, and has no
  compile cache or tunnel logic;
- the scene metrics always run on the device with the logo scoring: no
  upload probe, no host twin, no AMATSUKAZE_SCENE_METRICS;
- the in-process encoder is recognised by this package's shim module
  (amatsukaze_tpu_torch.tools.x264_shim, what settings.py emits);
- the 10-bit rule is the filter stage's (output_frames), and the y4m
  header is written from the spec of the frames the stage emits (the
  port also resizes in mode "none" without a post chain).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.process import prefetch_iter
from ..models.cm_analyze import CMAnalyzer
from ..models.chapter import ChapterMaker, JlsElement, format_jls
from ..models.filter_graph import FilterGraph, build_post_chain
from ..models.lgd import load_lgd
from ..models.vfr import BitrateZone, adjust_vfr_bitrate, make_vfr_bitrate_zones
from ..reform.stream_reform import MPEG_CLOCK_HZ, StreamReformInfo
from ..types import CMType, EncodeFileKey
from ..utils.context import ErrorCounter, FormatError, NoDrcsMapError
from ..utils.device import resolve_device
from . import cm_stage
from .filter_stage import analyze_filter_stage, output_frames, pump_output
from .frame_source import SweepFrameCache
from .settings import Encoder, Settings, make_encoder_args

# the in-build x264 shim of this package (settings.resolve_encoder_command)
_SHIM_MODULE = __package__.rsplit(".", 1)[0] + ".tools.x264_shim"
# an output file's CM type -> filter_stage's cm_zones_mode
_CM_ZONES_MODE = {CMType.BOTH: "both", CMType.NONCM: "non_cm",
                  CMType.CM: "cm"}


def ensure_cuda_backend(ctx, device=None) -> torch.device:
    """The device the pipeline runs on: the CUDA card for None, else the
    one asked for ("cpu" runs the kernels' plain PyTorch versions, as the
    tests do). Raises RuntimeError when the card is asked for and none is
    present: the pipeline never falls back to the CPU by itself."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        ctx.info("device: %s", torch.cuda.get_device_name(dev))
    else:
        ctx.info("device: %s (the kernels' plain PyTorch versions)", dev)
    return dev


@dataclass
class OutFileResult:
    path: str = ""
    src_bitrate: float = 0.0
    target_bitrate: float = float("nan")
    file_size: int = 0
    subs: list = field(default_factory=list)


def source_bitrate_kbps(reform: StreamReformInfo, video_index: int) -> float:
    size, duration = reform.get_src_video_info(video_index)
    if duration <= 0:
        return 0.0
    return (size * 8 / 1000) / (duration / MPEG_CLOCK_HZ)


def make_bitrate_zones(time_codes, cmzones, settings: Settings, fps_num, fps_den):
    """(ref MakeBitrateZones :407-442)."""
    encoder_supports_vfr = settings.conf.encoder in (
        Encoder.QSVENC, Encoder.NVENC, Encoder.VCEENC,
    )
    if not time_codes or encoder_supports_vfr:
        return [
            BitrateZone(z.start_frame, z.end_frame, settings.conf.bitrate_cm)
            for z in cmzones
        ]
    zone_available = settings.conf.encoder in (Encoder.X264, Encoder.X265)
    if zone_available:
        return make_vfr_bitrate_zones(
            time_codes, cmzones, settings.conf.bitrate_cm,
            fps_num, fps_den, settings.conf.x265_time_factor, 0.05,
        )
    return []


class TranscodePipeline:
    """One `--mode ts` transcode (ref transcodeMain). `device`: None is the
    CUDA card, "cpu" the plain PyTorch versions (checked when run() starts).

    Each phase of run() is a span of ctx.trace (utils/perf.py), below the
    recording's root span where the caller opened one: `gate` (each wait at
    the phase scheduler), `split`, `reform.prepare`, `cm` (`cm.pass` /
    `cm.silence` / `cm.decide` per video file), `audio`, `captions`,
    `encode` (per encode file a `gate`, `filter.logo_match`,
    `filter.analysis`, `encode.spawn`, `filter.output`, `encode.drain`),
    then `mux`. The decoder's own next() calls add to the counters
    `decode.frames` and `decode.busy_s`; the in-build MPEG-2 decoder adds
    `decode.segments`, `decode.segment_frames` and `decode.serial_files`
    (pipeline/decoders.py: decode_mpeg2_segments). The report carries the
    trace under "trace"."""

    def __init__(self, ctx, settings: Settings, decoder_factory=None,
                 audio_decoder_factory=None, caption_decoder=None,
                 phase_scheduler=None, encoder_runner=None, muxer_runner=None,
                 nicojk_fetchers=None, device=None):
        self.ctx = ctx
        self.settings = settings
        self.device = device
        self.nicojk_fetchers = nicojk_fetchers or []
        self._nico_ok = False
        if decoder_factory is not None:
            def timed_factory(pipeline, video_index, _orig=decoder_factory):
                # the decoder's own time, on the thread that decodes
                return ctx.trace.timed_iter(_orig(pipeline, video_index),
                                            "decode")

            decoder_factory = timed_factory
        self.decoder_factory = decoder_factory
        if decoder_factory is not None:
            mb = settings.conf.frame_cache_mb
            if mb < 0:
                mb = SweepFrameCache.auto_budget_mb()
            if mb > 0:
                self._sweep_cache = SweepFrameCache(mb << 20)

                def cached_factory(pipeline, video_index,
                                   _orig=decoder_factory):
                    return self._sweep_cache.stream(
                        video_index,
                        lambda: _orig(pipeline, video_index))

                self.decoder_factory = cached_factory
        if audio_decoder_factory is None:
            # the in-build AAC-LC decoder (replaces libfaad): feeds the
            # CM-analysis wave stream and dual-mono element splitting.
            # Native C++ engine when a compiler is available, else the
            # pure-Python oracle.
            from ..audio.aac_native import make_decoder

            audio_decoder_factory = make_decoder
        self.audio_decoder_factory = audio_decoder_factory
        if caption_decoder is None and settings.conf.subtitles:
            # --subtitles without an injected decoder gets the in-build
            # ARIB decoder (the reference always has Caption.dll when
            # captions are enabled); unmapped DRCS bitmaps land next to
            # the mapping file, matching the server's drcs-dir layout
            # (<dir>/drcs_map.txt + <dir>/<md5>.bmp, ref DRCSManager).
            from .probe import default_caption_decoder

            caption_decoder = default_caption_decoder(ctx, settings)
        self.caption_decoder = caption_decoder
        self.phase = phase_scheduler or _NullPhases()
        self.encoder_runner = encoder_runner or _default_encoder_runner
        self.muxer_runner = muxer_runner or _default_muxer_runner
        self.logos = []
        for p in settings.conf.logo_path:
            try:
                self.logos.append((p, load_lgd(p)))
            except (OSError, ValueError):
                self.ctx.warn("cannot read logo: %s", p)
        self.erase_logos = []  # unconditional fade-1 erasure (--erase-logo)
        for p in settings.conf.erase_logo_path:
            try:
                self.erase_logos.append(load_lgd(p))
            except (OSError, ValueError):
                self.ctx.warn("cannot read erase-logo: %s", p)
        # per-encode-file Total/FilterWait/EncoderWait seconds
        # (ref Encoder.hpp:238-239)
        self.encode_stats: dict[int, dict] = {}
        # the filter stage of the file being encoded (encoder runners read
        # its output spec and run its output pass)
        self._active_stage = None
        self._active_spec = None

    # ------------------------------------------------------------------ main
    def _gate(self, phase: str) -> None:
        with self.ctx.trace.span("gate", phase=phase):
            self.phase.wait(phase)

    def run(self) -> dict:
        ctx, st = self.ctx, self.settings
        trace = ctx.trace
        self.device = ensure_cuda_backend(ctx, self.device)
        is_no_encode = st.conf.mode == "cm"

        self._gate("TSAnalyze")
        with trace.span("split") as split_span:
            from .splitter import AMTSplitter

            splitter = AMTSplitter(
                ctx, st, audio_decoder_factory=self.audio_decoder_factory,
                caption_decoder=self.caption_decoder,
            )
            reform = splitter.split()
            split_span.frames = len(splitter.video_frame_list)
        self._reform = reform  # decoders may need the format info
        ctx.info("TS analysis done: %.2f s", split_span.seconds)
        service_id = splitter.get_actual_service_id()
        self.actual_service_id = service_id
        num_total = splitter.num_total_packets
        num_scramble = splitter.num_scramble_packets
        total_int_video_size = splitter.total_int_video_size
        src_file_size = splitter.src_file_size

        if st.conf.dump_stream_info:
            reform.serialize(st.stream_info_path())

        # scramble check (ref :502-508)
        if num_total > 0:
            ratio = num_scramble / num_total
            if ratio > 0.01:
                ctx.error("%.2f%% of packets are scrambled", ratio * 100)
                if ratio > 0.3:
                    raise FormatError("too many scrambled packets")

        if not is_no_encode and not st.conf.ignore_no_drcs_map:
            if ctx.error_count(ErrorCounter.NO_DRCS_MAP) > 0:
                raise NoDrcsMapError("unmapped DRCS characters found")

        with trace.span("reform.prepare"):
            reform.prepare(st.conf.split_sub,
                           st.conf.audio_encoder.value != "none")

        # NicoJK comment acquisition (ref :521-538)
        nicojk = None
        self._nico_ok = False
        if not is_no_encode and st.conf.nicojk_mask:
            nico_span = trace.begin("nicojk")
            from ..captions.nicojk import NicoJK, parse_ch_sid

            ch_map = {}
            if st.conf.nico_conv_ch_sid_path and os.path.exists(
                    st.conf.nico_conv_ch_sid_path):
                with open(st.conf.nico_conv_ch_sid_path,
                          encoding="utf-8") as f:
                    ch_map = parse_ch_sid(f.read())
            fetchers = list(self.nicojk_fetchers)
            if (st.conf.nicojk18 and not fetchers
                    and st.conf.nico_conv_ch_sid_path):
                # --nicojk18: the in-build NicoJK18 HTTP client plays the
                # NicoJK18Client.exe role (ref NicoJK.hpp:131-154)
                from ..captions.nicojk18 import make_fetcher

                fetchers = [make_fetcher(st.conf.nico_conv_ch_sid_path)]
            nicojk = NicoJK(ctx, ch_map, fetchers=fetchers,
                            mask=st.conf.nicojk_mask)
            ctx.info("[fetching NicoJK comments]")
            src_duration, _ = reform.get_in_out_duration()
            self._nico_ok = nicojk.make_ass(
                service_id, reform.first_frame_time,
                int(src_duration / MPEG_CLOCK_HZ))
            if self._nico_ok:
                reform.set_nicojk_list(nicojk.get_dialogues())
            elif nicojk.failed and not st.conf.ignore_nicojk_error:
                raise RuntimeError("NicoJK comment acquisition failed")
            elif not nicojk.failed:
                ctx.info("no matching NicoJK channel")
            trace.end(nico_span)

        # per-video-file CM/logo analysis (ref :559-595)
        self._gate("CMAnalyze")
        with trace.span("cm") as cm_span:
            cm_results = [self._analyze_video_file(reform, v)
                          for v in range(reform.num_video_file)]
        ctx.info("CM analysis done: %.2f s", cm_span.seconds)

        for v, cma in enumerate(cm_results):
            zones = [(z.start_frame, z.end_frame) for z in cma.result.cmzones]
            reform.apply_cm_zones(v, zones, cma.result.divs)

        with trace.span("audio"):
            adiff = reform.gen_audio(st.cmtypes)

        keys = reform.get_out_file_keys()
        out_results = {k.key(): OutFileResult() for k in keys}

        # chapters (ref :627-645)
        if st.conf.chapter and not is_no_encode:
            with trace.span("chapters"):
                for v, cma in enumerate(cm_results):
                    elements = self._jls_elements(reform, v, cma)
                    maker = ChapterMaker(cma.result.trims, elements)
                    for key in keys:
                        if key.video != v:
                            continue
                        file = reform.get_encode_file(key)
                        fmt = reform.get_format(key).video_format
                        chapters = maker.file_chapters(
                            file.video_frames, fmt.frame_rate
                        )
                        if chapters:
                            with open(st.tmp_chapter_path(key), "w") as f:
                                f.write(ChapterMaker.format_chapters(
                                    chapters, fmt.frame_rate_num,
                                    fmt.frame_rate_denom))

        if is_no_encode:
            return self._report(reform, keys, out_results, cm_results,
                                src_file_size, total_int_video_size, 0, adiff,
                                nico_ok=False)

        # caption files per output (ref :635-660)
        captions_span = trace.begin("captions")
        from ..captions.formatters import (
            CaptionASSFormatter,
            CaptionSRTFormatter,
        )
        from ..captions.nicojk import NicoJKFormatter

        ctx.info("[writing caption files]")
        for key in keys:
            file = reform.get_encode_file(key)
            for lang, lines in enumerate(file.caption_list):
                ass = CaptionASSFormatter(ctx).generate(lines)
                srt = CaptionSRTFormatter(ctx).generate(lines)
                with open(st.tmp_ass_path(key, lang), "w",
                          encoding="utf-8") as f:
                    f.write(ass)
                if srt:
                    # an empty SRT (e.g. all-small captions) would fail the
                    # mux step, so skip the file entirely
                    with open(st.tmp_srt_path(key, lang), "w",
                              encoding="utf-8") as f:
                        f.write(srt)
            if self._nico_ok:
                for jktype in st.nicojk_types:
                    text = NicoJKFormatter().generate(
                        nicojk.headers.get(jktype, []),
                        file.nicojk_list[jktype])
                    with open(st.tmp_nicojk_ass_path(key, jktype), "w",
                              encoding="utf-8") as f:
                        f.write(text)
        trace.end(captions_span)

        # filter + encode per output file (ref :683-753)
        with trace.span("encode") as encode_span:
            for i, key in enumerate(keys):
                self._gate("Filter")
                self._encode_one(reform, key, cm_results[key.video],
                                 out_results[key.key()], i, len(keys))
        ctx.info("encode done: %.2f s", encode_span.seconds)

        # mux (ref :755-770)
        self._gate("Mux")
        total_out_size = 0
        with trace.span("mux"):
            for key in keys:
                res = out_results[key.key()]
                file = reform.get_encode_file(key)
                out_path = st.out_file_path(file.out_key, file.key_max)
                res.path = out_path
                self.muxer_runner(self, reform, key, res)
                if os.path.exists(out_path):
                    res.file_size = os.path.getsize(out_path)
                total_out_size += res.file_size

        return self._report(reform, keys, out_results, cm_results,
                            src_file_size, total_int_video_size,
                            total_out_size, adiff, nico_ok=False)

    # ------------------------------------------------------------- CM analysis
    def _open_frames(self, v: int):
        """open_frames() of video file `v` for the stages: a fresh decode,
        prefetched on a host thread."""
        depth = max(8, self.settings.conf.device_batch_frames)

        def open_frames():
            if self.decoder_factory is None:
                raise RuntimeError("no decoder available for filter analysis")
            return prefetch_iter(self.decoder_factory(self, v), depth=depth)

        return open_frames

    def _analyze_video_file(self, reform: StreamReformInfo,
                            v: int) -> cm_stage.CMStageResult:
        st = self.settings
        frames_meta = reform.get_filter_source_frames(v)
        num_frames = len(frames_meta)
        fmt = reform.formats[reform.format_start_index[v]].video_format
        fps = fmt.frame_rate if fmt.frame_rate_num else 29.97

        jls_script = None
        if st.conf.jls_cmd_path:
            # user-supplied join_logo_scp rule script (ref CMAnalyze.hpp
            # MakeJoinLogoScpArgs -incmd + free-form options)
            from ..models.jls_script import JlsScript

            jls_script = JlsScript.from_file(st.conf.jls_cmd_path,
                                             st.conf.jls_options)
            self.ctx.info("JL command file: %s", st.conf.jls_cmd_path)
        analyzer = CMAnalyzer(self.ctx, num_frames, fps,
                              loose_logo_detection=st.conf.loose_logo_detection,
                              jls_script=jls_script)
        cma = cm_stage.CMStageResult()

        if st.conf.trim_avs_path:
            with open(st.conf.trim_avs_path) as f:
                analyzer.input_trim_avs(f.readline())
            cma.result = analyzer.result
            return cma

        # the reference only pays the analysis decode pass when chapter
        # analysis is on (TranscodeManager.hpp:568 `isAnalyze =
        # isChapterEnabled() && numFrames >= 300`; logo matching lives
        # inside CMAnalyze). Mirror that gate — a plain transcode decodes
        # the source once, not twice — extended to every configuration
        # whose outputs need the pass: cm mode, configured logos (delogo
        # without --chapter is a deliberate superset), JL rule scripts,
        # and external chapter_exe/join_logo_scp tools.
        is_analyze = (st.conf.chapter or st.conf.mode == "cm"
                      or bool(self.logos) or bool(st.conf.jls_cmd_path)
                      or self._external_tool(st.conf.chapter_exe_path)
                      or self._external_tool(st.conf.jls_path))
        files = dict(scpos=st.tmp_chapter_exe_out_path(v),
                     logo_frames=st.tmp_logo_frame_path(v),
                     trim=st.tmp_trim_avs_path(v), div=st.tmp_div_path(v))

        if is_analyze and self.decoder_factory is not None and num_frames > 0:
            # ONE streaming pass over the decoded luma: each batch crosses
            # to the device once and feeds the scene metrics and the logo
            # kernel; nothing holds the whole sequence in host or device
            # memory
            cma = cm_stage.scan_video_file(
                self.ctx, self._open_frames(v), num_frames, fmt,
                [lg for _, lg in self.logos],
                pcm_s16=cm_stage.filter_source_pcm(reform, v,
                                                   st.wave_file_path()),
                no_delogo=st.conf.no_delogo,
                batch=max(8, st.conf.device_batch_frames),
                device=self.device, files=files,
                logo_names=[p for p, _ in self.logos])
            self.ctx.info(
                "[CM analysis] stream pass %.2fs (%d frames; decode, scene "
                "metrics and logo %.2fs)",
                cma.silence_span.t1 - cma.pass_span.t0, cma.num_frames,
                cma.pass_span.seconds)

        with self.ctx.trace.span("cm.decide"):
            # configured external tools take precedence over the in-process
            # engines (ref CMAnalyze.hpp:319-365: chapterExe + joinLogoScp
            # subprocesses with the reference file contracts)
            if self._external_tool(st.conf.chapter_exe_path):
                cma.scene_changes = self._run_chapter_exe(v)
                analyzer.result.scene_changes = list(cma.scene_changes)
            if self._external_tool(st.conf.jls_path):
                self._run_join_logo_scp(v, analyzer, cma.scene_changes)
            else:
                # the decision, with the trim AVS + div files (reference
                # file contract)
                cm_stage.decide(analyzer, cma, files)

            pid_changes = reform.get_pid_changed_list(v)
            if any(r > 0 for r in st.conf.pmt_cut_side_rate):
                analyzer.apply_pmt_cut(st.conf.pmt_cut_side_rate,
                                       pid_changes)
            cma.result = analyzer.result
        return cma

    @staticmethod
    def _external_tool(path: str) -> bool:
        import shutil as _shutil

        return bool(path) and (os.path.isfile(path)
                               or _shutil.which(path) is not None)

    def _run_chapter_exe(self, v: int) -> list[int]:
        """Spawn the configured chapter_exe (ref MakeChapterExeArgs +
        chapterExe, CMAnalyze.hpp:319-337): `-v <video> -o <out>` with
        stdout captured to the chapter-exe-out file, whose `SCPos:` lines
        are the scene-change list."""
        import shlex
        import subprocess

        from ..models.cm_analyze import parse_scene_changes_text

        st = self.settings
        cmd = [st.conf.chapter_exe_path,
               "-v", st.int_video_file_path(v),
               "-o", st.tmp_chapter_exe_path(v)]
        cmd += shlex.split(st.conf.chapter_exe_options)
        self.ctx.info("%s", " ".join(cmd))
        with open(st.tmp_chapter_exe_out_path(v), "wb") as out:
            rc = subprocess.call(cmd, stdout=out)
        if rc != 0:
            raise FormatError(f"chapter_exe returned error code {rc}")
        with open(st.tmp_chapter_exe_out_path(v)) as f:
            return parse_scene_changes_text(f.read())

    def _run_join_logo_scp(self, v: int, analyzer, scene_changes):
        """Spawn the configured join_logo_scp (ref MakeJoinLogoScpArgs +
        joinLogoScp, CMAnalyze.hpp:338-365) and read back its trim AVS
        and div outputs."""
        import shlex
        import subprocess

        st = self.settings
        cmd = [st.conf.jls_path]
        if self.logos and os.path.exists(st.tmp_logo_frame_path(v)):
            cmd += ["-inlogo", st.tmp_logo_frame_path(v)]
        if not os.path.exists(st.tmp_chapter_exe_path(v)):
            # no external chapter_exe ran: hand the in-process scene
            # changes to jls in the scpos file contract
            from ..models.cm_analyze import format_scene_changes_text

            with open(st.tmp_chapter_exe_path(v), "w") as f:
                f.write(format_scene_changes_text(scene_changes, []))
        cmd += ["-inscp", st.tmp_chapter_exe_path(v)]
        if st.conf.jls_cmd_path:  # the reference adds -incmd only when
            cmd += ["-incmd", st.conf.jls_cmd_path]  # a JL file is set
        cmd += ["-o", st.tmp_trim_avs_path(v),
                "-oscp", st.tmp_jls_path(v),
                "-odiv", st.tmp_div_path(v)]
        cmd += shlex.split(st.conf.jls_options)
        self.ctx.info("%s", " ".join(cmd))
        rc = subprocess.call(cmd)
        if rc != 0:
            raise FormatError(f"join_logo_scp returned error code {rc}")
        with open(st.tmp_trim_avs_path(v)) as f:
            analyzer.input_trim_avs(f.readline())
        from ..models.cm_analyze import normalize_divs

        divs = []
        if os.path.exists(st.tmp_div_path(v)):
            with open(st.tmp_div_path(v)) as f:
                divs = [int(s) for s in f.read().split() if s.strip()]
        analyzer.result.divs = normalize_divs(divs, analyzer.num_frames)
        return analyzer.result

    def _autovfr_section_opener(self, key, file):
        """Per-section frame stream for AutoVfr analysis. Sections decode
        independently (so they parallelise across host threads); when the
        intermediate is in-build-decodable MPEG2 and the frame mapping is
        identity, each section byte-seeks to its keyframe instead of
        decoding from zero (the AMTSource seek path)."""
        st = self.settings
        reform = self._reform
        meta = reform.get_filter_source_frames(key.video)
        wanted = sorted(set(file.video_frames))
        identity = wanted == list(range(len(meta)))
        seek_open = None
        if identity and meta:
            from ..types import VideoStreamFormat

            vfmt = reform.get_format(key).video_format.format
            try:
                ps = st.int_video_file_path(key.video)
                with open(ps, "rb") as f:
                    head = f.read(4)
                if head[:3] == b"\x00\x00\x01":  # MPEG PS/ES intermediate
                    if vfmt in (VideoStreamFormat.MPEG2,
                                VideoStreamFormat.UNKNOWN):
                        from ..video.native import (  # noqa: F401
                            NativeMpeg2Decoder,
                        )

                        from .decoders import mpeg2_ps_seek_opener

                        seek_open = mpeg2_ps_seek_opener(ps)
                    else:
                        # H.264 (IDR joins) / HEVC (IRAP joins, RASL
                        # dropped by the decoders)
                        from .decoders import annexb_ps_seek_opener

                        seek_open = annexb_ps_seek_opener(ps, vfmt)
            except (RuntimeError, OSError):
                seek_open = None

        def opener(start: int, end: int):
            start = max(0, start)
            if seek_open is not None:
                from .decoders import FormatSeekError

                key_idx = meta[start].key_frame
                try:
                    it = seek_open(key_idx, meta[key_idx].file_offset)
                    for i, planes in enumerate(it):
                        idx = key_idx + i
                        if idx >= end:
                            break
                        if idx >= start:
                            yield planes[0]
                    return
                except FormatSeekError:
                    # not a clean join (open-GOP H.264 recovery point):
                    # forward decode below
                    pass
            wanted_set = set(wanted)
            pos = 0
            for i, planes in enumerate(self.decoder_factory(self, key.video)):
                if i not in wanted_set:
                    continue
                if pos >= end:
                    break
                if pos >= start:
                    yield planes[0]
                pos += 1

        return opener

    def _jls_elements(self, reform, v,
                      cma: cm_stage.CMStageResult) -> list[JlsElement]:
        n = len(reform.get_filter_source_frames(v))
        fmt = reform.formats[reform.format_start_index[v]].video_format
        fps = fmt.frame_rate if fmt.frame_rate_num else 29.97
        elements = cm_stage.jls_elements(cma.result, n, fps)
        with open(self.settings.tmp_jls_path(v), "w") as f:
            f.write(format_jls(elements))
        return elements

    # ------------------------------------------------------------------ encode
    def _qp_source(self, key: EncodeFileKey, file):
        """Per-MB QP maps of the file's frames for the deblock post filter
        (the reference reads them from a patched decoder's frame props,
        AMTSource.hpp:371-404; here: ts/qp_extract), or None."""
        ctx, st = self.ctx, self.settings
        try:
            from ..ts.qp_extract import QpMapSource

            qsrc = QpMapSource.from_file(st.int_video_file_path(key.video))
            if len(qsrc):
                n_slices = qsrc.slices_ok + qsrc.slices_fallback
                if qsrc.slices_fallback and qsrc.full_parse:
                    ctx.warn(
                        "deblock: %d/%d slices used the slice-QP "
                        "fallback (VLC desync)", qsrc.slices_fallback,
                        n_slices)
                return qsrc.select(sorted(set(file.video_frames)))
            # non-MPEG2 source: FFmpeg's per-block QP export (H.264)
            # through the in-process bridge
            from ..ts.qp_extract import qp_map_source_from_avdec

            qsrc = qp_map_source_from_avdec(st.int_video_file_path(key.video))
            if qsrc is not None and len(qsrc):
                return qsrc.select(sorted(set(file.video_frames)))
            ctx.warn("deblock: no QP maps available for this "
                     "codec; deblock will be skipped")
        except OSError as e:
            ctx.warn("deblock: QP extraction failed: %s", e)
        return None

    def _encode_one(self, reform, key: EncodeFileKey,
                    cma: cm_stage.CMStageResult, res: OutFileResult,
                    index: int, total: int) -> None:
        ctx, st = self.ctx, self.settings
        file = reform.get_encode_file(key)
        fmt = reform.get_format(key).video_format
        num_frames = len(file.video_frames)
        if num_frames == 0:
            return

        src_bitrate = source_bitrate_kbps(reform, key.video)
        res.src_bitrate = src_bitrate
        if st.conf.auto_bitrate:
            target = st.conf.bitrate.target_bitrate(
                reform.get_video_stream_format(), src_bitrate
            )
            if key.cm == CMType.CM:
                target *= st.conf.bitrate_cm
            res.target_bitrate = target

        ctx.info("[encode start] %d/%d %s (%d frames)",
                 index + 1, total, key.cm.name, num_frames)
        self._gate("Encode")

        # filter analysis + output spec (ref AMTFilterSource,
        # FilteredSource.hpp:136-635 — the AVS multi-pass loop becomes a
        # declarative device pipeline): the decoded stream is erased with
        # the fades of its source frames, then the file's frames are kept
        mode = st.conf.filter_mode
        if mode in FilterGraph.KFM_FAMILY and self.decoder_factory is None:
            raise RuntimeError("no decoder available for filter analysis")
        if st.conf.filter_devices > 1:
            ctx.info("[filter] sharding over %d devices",
                     st.conf.filter_devices)
        qp_source = None
        if getattr(build_post_chain(st.conf.post_filter), "wants_qp", False):
            with ctx.trace.span("filter.qp_maps"):
                qp_source = self._qp_source(key, file)
        mb = st.conf.analysis_cache_mb
        stage = analyze_filter_stage(
            ctx, self._open_frames(key.video), num_frames, fmt, [], mode,
            batch=st.conf.device_batch_frames, device=self.device,
            kfm_ucf=st.conf.kfm_ucf, cm=cma, erase_logos=self.erase_logos,
            cm_zones_mode=_CM_ZONES_MODE[key.cm],
            analysis_cache_bytes=mb << 20 if mb >= 0 else None,
            timecode_path=st.enc_timecode_path(key),
            dump_path=(st.tmp_filter_dump_path(key) if st.conf.dump_filter
                       else None),
            post_filter=st.conf.post_filter, qp_source=qp_source,
            resize=((st.conf.resize_width, st.conf.resize_height)
                    if st.conf.resize_width and st.conf.resize_height
                    else None),
            open_section=(self._autovfr_section_opener(key, file)
                          if mode == FilterGraph.MODE_AUTOVFR else None),
            autovfr_parallel=st.conf.autovfr_parallel,
            autovfr_prefix=st.tmp_autovfr_prefix(key.video),
            filter_devices=st.conf.filter_devices,
            video_frames=file.video_frames)
        spec = stage.spec
        out_fmt = spec.out_format
        self._vfr_timing_fps = spec.vfr_timing_fps if spec.time_codes else 30
        self._active_stage = stage
        self._active_spec = spec

        bitrate_zones = make_bitrate_zones(
            spec.time_codes, stage.zones, st,
            fmt.frame_rate_num, fmt.frame_rate_denom,
        )
        if (spec.time_codes and st.conf.auto_bitrate
                and st.conf.encoder != Encoder.X264
                and not math.isnan(res.target_bitrate)):
            # VFR bitrate correction for non-VFR-aware encoders (only
            # x264 takes --tcfile-in): the encoder budgets bits against
            # its nominal fps while the real VFR duration is longer, so
            # the target scales by avg/nominal frame duration (ref
            # AdjustVFRBitrate FilteredSource.hpp:833-839 applied in
            # getOptions TranscodeSetting.hpp:1080-1083)
            res.target_bitrate *= adjust_vfr_bitrate(
                spec.time_codes, out_fmt.frame_rate_num,
                out_fmt.frame_rate_denom)

        passes = [1, 2] if st.conf.two_pass else [-1]
        try:
            for pass_index in passes:
                args = make_encoder_args(
                    st.conf.encoder, st.conf.encoder_path,
                    self._encoder_options(res, bitrate_zones, num_frames),
                    out_fmt, st.enc_video_file_path(key),
                    pass_index=pass_index,
                    stats_path=st.enc_stats_path(key),
                )
                if len(passes) > 1:
                    ctx.info("[encode pass %d/%d]", pass_index, len(passes))
                self.encoder_runner(self, reform, key, args)
        finally:
            # the analysis frame spill can hold GBs: release it with the
            # rest of the per-file state even when the encode failed
            self._active_stage = None
            self._active_spec = None

    def _encoder_options(self, res: OutFileResult, zones, num_frames) -> str:
        opts = self.settings.conf.encoder_options
        if not math.isnan(res.target_bitrate):
            opts += f" --bitrate {int(res.target_bitrate)}"
        for i, z in enumerate(zones or []):
            sep = "--zones " if i == 0 else "/"
            opts += f"{sep}{z.start_frame},{z.end_frame - 1},b={z.bitrate:.3g}"
        return opts.strip()

    # ------------------------------------------------------------------ report
    def _report(self, reform, keys, out_results, cm_results, src_file_size,
                int_video_size, total_out_size, adiff, nico_ok) -> dict:
        st = self.settings
        # the recording's root span ends with its report
        self.ctx.trace.close_root()
        in_dur, out_dur = reform.get_in_out_duration()
        report = {
            "srcpath": st.conf.src_file_path,
            "outfiles": [],
            "logofiles": [c.result.logopath for c in cm_results],
            "srcfilesize": src_file_size,
            "intvideofilesize": int_video_size,
            "outfilesize": total_out_size,
            "srcduration": round(in_dur / MPEG_CLOCK_HZ, 3),
            "outduration": round(out_dur / MPEG_CLOCK_HZ, 3),
            "audiodiff": adiff.to_json(),
            "error": self.ctx.error_json(),
            "cmanalyze": bool(st.conf.chapter),
            "nicojk": nico_ok,
            "trimavs": bool(st.conf.trim_avs_path),
            # Total/FilterWait/EncoderWait per encode file
            # (ref Encoder.hpp:238-239 log line)
            "encodewaits": [self.encode_stats.get(k.key(), {})
                            for k in keys],
            "trace": self.ctx.trace.to_json(),
        }
        for key in keys:
            file = reform.get_encode_file(key)
            res = out_results[key.key()]
            report["outfiles"].append({
                "path": st.out_file_path(file.out_key, file.key_max),
                "srcbitrate": int(res.src_bitrate),
                "outbitrate": -1 if math.isnan(res.target_bitrate)
                else int(res.target_bitrate),
                "outfilesize": res.file_size,
                "subs": res.subs,
            })
        if st.conf.out_info_json_path:
            with open(st.conf.out_info_json_path, "w") as f:
                json.dump(report, f, ensure_ascii=False)
        return report


class _NullPhases:
    def wait(self, phase: str) -> None:
        pass


class _InProcessEncoderSink:
    """In-build encode without the subprocess + y4m round-trip.

    When the encoder command resolves to the x264 shim (no external
    binary installed), the filtered planes go straight into the libx264
    bridge in this process — one pipe serialization + y4m parse less per
    frame. Real encoder binaries keep the reference architecture: y4m
    over stdin to a subprocess (ref Encoder.hpp:94-164).
    """

    def __init__(self, shim_argv: list[str], y4m_fmt):
        from ..tools.x264_shim import build_encoder, parse_args

        opts = parse_args(shim_argv)
        if not opts["out"]:
            raise RuntimeError("in-process encoder: no -o output path")
        interlaced = y4m_fmt.interlaced or opts["field_order"] is not None
        tff = (opts["field_order"] != "bff") if opts["field_order"] \
            else getattr(y4m_fmt, "tff", True)
        bits = getattr(y4m_fmt, "bits", 8)
        # Main10 pass-through: encode at 10 bits when the codec can
        native10 = bits == 10 and opts["codec"] in ("libx265", "libsvtav1")
        self._enc = build_encoder(
            opts, y4m_fmt.width, y4m_fmt.height, y4m_fmt.fps_num,
            y4m_fmt.fps_den, interlaced, tff,
            bit_depth=10 if native10 else 8)
        self._shift = 0 if native10 else max(bits - 8, 0)
        self._out = open(opts["out"], "wb")
        self.frames = 0

    def write_frame(self, y, u, v) -> None:
        if self._shift:
            rnd = 1 << (self._shift - 1)
            y = ((y + rnd) >> self._shift).clip(0, 255).astype(np.uint8)
            u = ((u + rnd) >> self._shift).clip(0, 255).astype(np.uint8)
            v = ((v + rnd) >> self._shift).clip(0, 255).astype(np.uint8)
        if self._enc.bit_depth > 8:
            for pkt in self._enc.encode(y, u, v):
                self._out.write(pkt)
        else:
            for pkt in self._enc.encode(_to_u8(y), _to_u8(u), _to_u8(v)):
                self._out.write(pkt)
        self.frames += 1

    def join(self) -> int:
        try:
            for pkt in self._enc.flush():
                self._out.write(pkt)
        finally:
            self._out.close()
        return 0


def _inprocess_encoder_argv(encoder_args: str) -> list[str] | None:
    """The shim argv when `encoder_args` invokes this package's in-build
    shim (resolve_encoder_command swapped a missing binary), else None."""
    import shlex

    try:
        parts = shlex.split(encoder_args)
    except ValueError:
        return None
    for i, p in enumerate(parts):
        if p == _SHIM_MODULE:
            if i > 0 and parts[i - 1] == "-m":
                return parts[i + 1:]
    return None


def _default_encoder_runner(pipeline: TranscodePipeline, reform,
                            key: EncodeFileKey, encoder_args: str) -> None:
    """Drive the encoder: the filter stage's output pass -> y4m -> stdin.

    Uses the bounded DataPumpThread so filtering overlaps encoder input
    (ref AMTFilterVideoEncoder::encode, Encoder.hpp:166-264). Runs once
    per encoder pass; with the analysis frame spill both passes read the
    retained frames.
    """
    trace = pipeline.ctx.trace
    spawn = trace.begin("encode.spawn")
    from ..io.process import DataPumpThread, SubProcess
    from ..io.y4m import Y4MFormat, Y4MWriter
    from ..utils.perf import FpsPrinter
    from .settings import resolve_encoder_command

    st = pipeline.settings
    if pipeline.decoder_factory is None:
        raise RuntimeError("no decoder available for encode stage")
    stage = pipeline._active_stage
    fg, spec = stage.graph, stage.spec
    out_fmt = spec.out_format
    encoder_args = resolve_encoder_command(encoder_args, st.conf.encoder)
    if stage.spill is not None:
        pipeline.ctx.info(
            "encode feed: analysis frame cache (%d frames, %.0f MB)",
            len(stage.spill.frames), stage.spill.nbytes / 1e6)
    # Main10 sources arrive as uint16: output_frames peeks the first frame
    # and says whether the stage keeps the 10 bits
    frames, bits = output_frames(stage)
    y4m_fmt = Y4MFormat(
        width=out_fmt.width, height=out_fmt.height,
        fps_num=out_fmt.frame_rate_num, fps_den=out_fmt.frame_rate_denom,
        interlaced=not out_fmt.progressive,
        sar_num=out_fmt.sar_width, sar_den=out_fmt.sar_height,
        colorspace="420p10" if bits == 10 else "420mpeg2",
    )
    shim_argv = _inprocess_encoder_argv(encoder_args)
    ep = st.conf.encoder_process
    use_subprocess = shim_argv is None or ep == 1 or (
        ep == -1 and (os.cpu_count() or 1) > 1)
    if not use_subprocess:
        # single-core host: the in-process sink skips the y4m pipe
        # round-trip (the encoder C call releases the GIL, so the
        # decode/filter threads still overlap it)
        proc = None
        writer = _InProcessEncoderSink(shim_argv, y4m_fmt)
    else:
        # the reference's stage-pipelined architecture: the encoder runs
        # in its own process fed y4m over stdin (Encoder.hpp:94-164) —
        # on a multi-core host decode/filter and encode overlap fully
        proc = SubProcess(encoder_args)
        writer = Y4MWriter(proc.stdin, y4m_fmt)
    # queue deep enough to ride out a full device batch round without
    # starving the encoder (ref Encoder.hpp's pump buffering), capped at
    # ~256 MB of frames so 4K sources don't blow host memory. The
    # device-batch depth is only needed when frames arrive in device
    # bursts (filter graph / logo eraser); on the plain path a deep queue
    # pins the decoder's planes.
    filtered = not (fg.mode == FilterGraph.MODE_NONE
                    and fg.post_chain is None)
    frame_bytes = max(1, out_fmt.width * out_fmt.height * 3 // 2
                      * (2 if bits == 10 else 1))
    pump_depth = st.conf.num_encode_buffer_frames
    if filtered or stage.eraser:
        pump_depth = max(pump_depth, st.conf.device_batch_frames)
    pump_depth = max(4, min(pump_depth, (256 << 20) // frame_bytes))
    pump = DataPumpThread(lambda planes: writer.write_frame(*planes),
                          max_items=pump_depth)
    # rolling encode-progress report (ref FpsPrinter
    # PerformanceUtil.hpp:57-124 feeding the worker console)
    done = [0]
    fpsp = FpsPrinter(interval_s=10.0, report=lambda fps: pipeline.ctx.info(
        "[encode] %d/%d frames, %.1f fps", done[0], spec.num_out_frames, fps))
    fpsp.start()
    trace.end(spawn)

    def sink(planes):
        pump.put(planes)
        done[0] += 1
        fpsp.update()

    try:
        pump_output(stage, frames, sink)
        with trace.span("encode.drain") as drain:
            pump.join()
            rc = writer.join() if proc is None else proc.join()
    except BaseException:
        if proc is not None:
            proc.kill()
        raise
    if rc != 0:
        raise RuntimeError(
            f"encoder failed ({rc}): "
            + "\n".join(proc.last_lines if proc is not None else [])
        )
    # encode-stage wait breakdown (ref Encoder.hpp:238-239 logs Total /
    # FilterWait / EncoderWait): consumer_wait = the encoder feed idling
    # for filtered frames, producer_wait = the filter blocked on a slow
    # encoder. Stored per encode file for the JSON report. Total runs from
    # the output pass's start to the encoder's exit.
    total = drain.t1 - stage.output_span.t0
    stats = {"total": round(total, 3),
             "filter_wait": round(pump.consumer_wait, 3),
             "encoder_wait": round(pump.producer_wait, 3)}
    pipeline.encode_stats[key.key()] = stats
    pipeline.ctx.info(
        "Total: %.2fs, FilterWait: %.2fs, EncoderWait: %.2fs",
        total, pump.consumer_wait, pump.producer_wait)


def _to_u8(plane: np.ndarray) -> np.ndarray:
    if plane.dtype == np.uint8:  # already rounded (on device)
        return plane
    return np.clip(np.floor(plane + 0.5), 0, 255).astype(np.uint8)


def _default_muxer_runner(pipeline: TranscodePipeline, reform,
                          key: EncodeFileKey, res: OutFileResult) -> None:
    """Run the external muxer when one is configured; without a muxer
    binary the bare encoded video stream becomes the output file
    (ref AMTMuxder::mux, Muxer.hpp:40-225)."""
    import shutil as _shutil

    from ..io.muxer import Muxer
    from .encoder_options import parse_encoder_option

    st = pipeline.settings
    file = reform.get_encode_file(key)
    out_path = st.out_file_path(file.out_key, file.key_max)
    if not _shutil.which(st.conf.muxer_path):
        enc_video = st.enc_video_file_path(key)
        if not os.path.exists(enc_video):
            return
        # in-build remux (libavformat): real mp4/mkv with audio + VFR
        # timestamps; bare-stream move only as the last resort
        try:
            from ..video.avdec import avdec_available, remux_files

            if not avdec_available():
                raise RuntimeError("no bridge")
            # produce the per-output audio tracks (incl. dual-mono
            # split) exactly like the external-muxer path would
            mux = Muxer(pipeline.ctx, st, reform,
                        aac_decoder_factory=pipeline.audio_decoder_factory)
            audios = [p for p in mux._write_audio_files(key)
                      if os.path.exists(p)]
            # caption/NicoJK side files (the in-build remux cannot embed
            # subtitle tracks, so every format gets the MP4-style ASS
            # side-file treatment; ref Muxer.hpp:134-167)
            from ..io.muxer import MuxResult

            mres = MuxResult()
            mux._gather_subs(
                key, bool(getattr(pipeline, "_nico_ok", False)), mres,
                copy_out=True)
            res.subs = mres.out_subs
            tc_path = st.enc_timecode_path(key)
            timecodes = None
            if os.path.exists(tc_path):
                with open(tc_path) as f:
                    timecodes = [float(line) for line in f
                                 if not line.startswith("#")]
            spec = getattr(pipeline, "_active_spec", None)
            fmt = (spec.out_format if spec is not None
                   else reform.get_format(key).video_format)
            remux_files(enc_video, audios, out_path,
                        fmt.frame_rate_num or 30000,
                        fmt.frame_rate_denom or 1001, timecodes)
            res.file_size = os.path.getsize(out_path)
            pipeline.ctx.info("[mux] in-build remux -> %s", out_path)
        except Exception as e:  # noqa: BLE001 - fall back to bare stream
            pipeline.ctx.warn("in-build remux unavailable (%s); writing "
                              "the bare stream", e)
            os.replace(enc_video, out_path)
        return
    eo_info = parse_encoder_option(st.conf.encoder, st.conf.encoder_options)
    timecode = st.enc_timecode_path(key)
    mux = Muxer(pipeline.ctx, st, reform,
                aac_decoder_factory=pipeline.audio_decoder_factory)
    result = mux.mux(
        key, eo_info, nico_ok=bool(getattr(pipeline, "_nico_ok", False)),
        vfmt=reform.get_format(key).video_format,
        vfr_timing_fps=getattr(pipeline, "_vfr_timing_fps", 30),
        timecode_path=timecode if os.path.exists(timecode) else "",
    )
    res.subs = result.out_subs
    res.file_size = result.file_size
