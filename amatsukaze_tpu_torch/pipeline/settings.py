"""Config + temp-file scheme + encoder/muxer argument builders.

Parity: Config / ConfigWrapper in the reference (Amatsukaze/TranscodeSetting.hpp:
502-1219): the temp-file naming scheme for every intermediate (:849-997), output
naming with `-{format}`, `_div{n}`, `-cm/-main` suffixes (:999-1030),
auto-bitrate `f*(a*src+b)` (:103-118, :1069-1140), per-encoder/muxer command
lines (makeEncoderArgs :132-216, makeAudioEncoderArgs :225-261,
makeMuxerArgs :263-377).

The port's copy of amatsukaze_tpu/pipeline/settings.py.
"""

from __future__ import annotations

import enum
import os
import random
import shutil
import string
from dataclasses import dataclass, field

from ..types import CMType, EncodeFileKey, VideoFormat, VideoStreamFormat


class Encoder(enum.Enum):
    X264 = "x264"
    X265 = "x265"
    QSVENC = "QSVEnc"
    NVENC = "NVEnc"
    VCEENC = "VCEEnc"
    SVTAV1 = "SVT-AV1"


class AudioEncoder(enum.Enum):
    NONE = "none"
    NEROAAC = "neroaac"
    QAAC = "qaac"
    FDKAAC = "fdkaac"


class OutputFormat(enum.Enum):
    MP4 = "mp4"
    MKV = "mkv"
    M2TS = "m2ts"
    TS = "ts"


@dataclass
class BitrateSetting:
    """Auto bitrate: target = (a * srcBitrate + b) * codec-factor
    (ref TranscodeSetting.hpp:103-118)."""

    a: float = 0.0
    b: float = 0.0
    h264: float = 1.0
    h265: float = 1.0

    def target_bitrate(self, fmt: VideoStreamFormat, src_bitrate: float) -> float:
        base = self.a * src_bitrate + self.b
        if fmt == VideoStreamFormat.H264:
            return base * self.h264
        if fmt == VideoStreamFormat.H265:
            return base * self.h265
        return base


NICOJK_TYPES = ("720S", "720T", "1080S", "1080T")


@dataclass
class Config:
    """All CLI options (ref Config POD, TranscodeSetting.hpp:502-577)."""

    work_dir: str = "./"
    mode: str = "ts"
    mode_args: str = ""
    src_file_path: str = ""
    out_video_path: str = ""  # no extension
    out_info_json_path: str = ""
    drcs_map_path: str = ""
    drcs_out_path: str = ""
    filter_script_path: str = ""
    post_filter_script_path: str = ""
    encoder: Encoder = Encoder.X264
    encoder_path: str = "x264"
    encoder_options: str = ""
    audio_encoder: AudioEncoder = AudioEncoder.NONE
    audio_encoder_path: str = ""
    audio_encoder_options: str = ""
    muxer_path: str = "muxer"
    timelineeditor_path: str = "timelineeditor"
    mp4box_path: str = "mp4box"
    nico_conv_ass_path: str = ""
    nico_conv_ch_sid_path: str = ""
    format: OutputFormat = OutputFormat.MP4
    split_sub: bool = False
    two_pass: bool = False
    auto_bitrate: bool = False
    chapter: bool = False
    subtitles: bool = False
    nicojk_mask: int = 0
    nicojk18: bool = False
    use_nicojk_log: bool = False
    bitrate: BitrateSetting = field(default_factory=BitrateSetting)
    bitrate_cm: float = 0.5
    x265_time_factor: float = 0.25
    service_id: int = -1
    audio_bitrate_kbps: int = 0
    num_encode_buffer_frames: int = 16
    # KFM analysis-pass frame spill cap in MB (-1 = auto: RAM/8 in
    # [256MB, 4GB]; 0 disables): lets the encode pass reuse the
    # analysis pass's decoded frames instead of a second source decode
    analysis_cache_mb: int = -1
    logo_path: list = field(default_factory=list)
    erase_logo_path: list = field(default_factory=list)
    ignore_no_logo: bool = False
    ignore_no_drcs_map: bool = False
    ignore_nicojk_error: bool = False
    pmt_cut_side_rate: tuple = (0.0, 0.0)
    loose_logo_detection: bool = False
    no_delogo: bool = False
    max_fade_length: int = 16
    jls_cmd_path: str = ""
    jls_options: str = ""
    chapter_exe_options: str = ""
    cm_out_mask: int = 1
    trim_avs_path: str = ""
    # probe-mode early stop; ref default 30*300 (AmatsukazeCLI.hpp:194).
    # 0 would stop probes on the FIRST video frame (probe_subtitles /
    # probe_audio then see nothing) — keep in sync with cli --max-frames
    max_frames: int = 9000
    # device settings (TPU-era replacement for DecoderSetting GPU choices)
    device_batch_frames: int = 32
    # in-build encoder placement when no external binary exists:
    # -1 = auto (dedicated encoder subprocess when the host has >1 CPU —
    # the reference's stage-pipelined architecture, Encoder.hpp:94-164:
    # decode/filter overlap the encoder across cores via the y4m pipe),
    # 0 = always in-process (one pipe serialization less; right for
    # single-core hosts), 1 = always a subprocess
    encoder_process: int = -1
    # multi-chip: shard this job's filter pass over the first N devices
    # of the mesh (parallel/sharded_filter); 1 = single device. The
    # TPU-native scale-up analog of the reference's per-item GPU index
    # (ResourceManager.cs:87-97) — one item across chips instead of one
    # GPU per item
    filter_devices: int = 1
    # decoded-frame reuse across pipeline sweeps (CM metrics -> filter
    # analysis -> encode feed): MB budget; -1 = auto (a quarter of
    # available RAM), 0 disables. The reference re-decodes per sweep.
    frame_cache_mb: int = -1
    # declarative filter graph mode (TPU-era replacement for the AVS filter
    # script; mirrors the GUI deinterlacer x fps matrix,
    # EncodeServerData.cs:106-119): none | yadif | yadif60 | qtgmc |
    # kfm_vfr | kfm_vfr30 | kfm_cfr24 | svp | autovfr
    filter_mode: str = "none"
    # AutoVfr section-parallel analysis width (ref AutoVfrParallel)
    autovfr_parallel: int = 2
    # KFM dirty-field replacement (ref KfmEnableUcf)
    kfm_ucf: bool = True
    # output resize (ref FilterSetting.EnableResize + BlackmanResize,
    # Misc.cs:1411-1414); 0 = keep source dimensions
    resize_width: int = 0
    resize_height: int = 0
    # post chain tokens: comma-separated from {nr, deband, edge}
    # (the reference's KTemporalNR/KDeband/KEdgeLevel GUI toggles)
    post_filter: str = ""
    # decoder backend selection (ref --mpeg2decoder/--h264decoder,
    # DECODER_TYPE in TranscodeSetting.hpp; QSV/CUVID map to "default"
    # here — hardware decode backends are CUDA-host concepts)
    mpeg2_decoder: str = "default"  # default | native | ffmpeg | cv2
    h264_decoder: str = "default"   # default | ffmpeg | cv2
    # accepted-for-compat external tool paths (in-build engines replace
    # chapter_exe / join_logo_scp / NicoConvASS; kept so reference
    # command lines keep working)
    chapter_exe_path: str = ""
    jls_path: str = ""
    affinity: str = ""
    # debug
    dump_stream_info: bool = False
    dump_filter: bool = False  # write filter-graph debug JSON per output
                               # (ref --dump-filter, FilteredSource.hpp:273)
    no_remove_tmp: bool = False
    print_prefix: bool = False


class TempDirectory:
    """Temp dir with a random suffix + cleanup (ref :418-481)."""

    def __init__(self, base: str, keep: bool = False):
        suffix = "".join(random.choices(string.ascii_lowercase + string.digits, k=8))
        self.path = os.path.join(base, f"amt{suffix}")
        os.makedirs(self.path, exist_ok=True)
        self.keep = keep

    def cleanup(self) -> None:
        if not self.keep:
            shutil.rmtree(self.path, ignore_errors=True)


def _cm_suffix(cm: CMType) -> str:
    return {CMType.BOTH: "", CMType.NONCM: "-main", CMType.CM: "-cm"}[cm]


class Settings:
    """ConfigWrapper equivalent: accessors + path factory."""

    def __init__(self, ctx, conf: Config, tmp_dir: TempDirectory | None = None):
        self.ctx = ctx
        self.conf = conf
        self.tmp = tmp_dir or TempDirectory(conf.work_dir, conf.no_remove_tmp)
        self.cmtypes = [
            CMType(i) for i in range(3) if conf.cm_out_mask & (1 << i)
        ]
        self.nicojk_types = [
            i for i in range(4) if conf.nicojk_mask & (1 << i)
        ]

    # -- temp paths (same names as the reference scheme :849-997) -------------
    def _t(self, name: str) -> str:
        path = os.path.join(self.tmp.path, name)
        self.ctx.register_tmp_file(path)
        return path

    def audio_file_path(self) -> str:
        return self._t("audio.dat")

    def wave_file_path(self) -> str:
        return self._t("audio.wav")

    def int_video_file_path(self, index: int) -> str:
        return self._t(f"i{index}.mpg")

    def stream_info_path(self) -> str:
        return self.conf.out_video_path + "-streaminfo.dat"

    def _key(self, key: EncodeFileKey) -> str:
        return f"{key.video}-{key.format}-{key.div}{_cm_suffix(key.cm)}"

    def enc_video_file_path(self, key: EncodeFileKey) -> str:
        return self._t(f"v{self._key(key)}.raw")

    def enc_timecode_path(self, key: EncodeFileKey) -> str:
        return self._t(f"v{self._key(key)}.timecode.txt")

    def duration_path(self, key: EncodeFileKey) -> str:
        return self._t(f"v{self._key(key)}.duration.txt")

    def enc_stats_path(self, key: EncodeFileKey) -> str:
        return self._t(f"s{self._key(key)}.log")

    def int_audio_file_path(self, key: EncodeFileKey, aindex: int) -> str:
        return self._t(
            f"a{key.video}-{key.format}-{key.div}-{aindex}{_cm_suffix(key.cm)}.aac"
        )

    def tmp_ass_path(self, key: EncodeFileKey, lang: int) -> str:
        return self._t(
            f"c{key.video}-{key.format}-{key.div}-{lang}{_cm_suffix(key.cm)}.ass"
        )

    def tmp_srt_path(self, key: EncodeFileKey, lang: int) -> str:
        return self._t(
            f"c{key.video}-{key.format}-{key.div}-{lang}{_cm_suffix(key.cm)}.srt"
        )

    def tmp_source_path(self, vindex: int) -> str:
        return self._t(f"amts{vindex}.dat")

    def tmp_logo_frame_path(self, vindex: int, logo_index: int = -1) -> str:
        if logo_index == -1:
            return self._t(f"logof{vindex}.txt")
        return self._t(f"logof{vindex}-{logo_index}.txt")

    def tmp_chapter_exe_path(self, vindex: int) -> str:
        return self._t(f"chapter_exe{vindex}.txt")

    def tmp_chapter_exe_out_path(self, vindex: int) -> str:
        return self._t(f"chapter_exe_o{vindex}.txt")

    def tmp_trim_avs_path(self, vindex: int) -> str:
        return self._t(f"trim{vindex}.avs")

    def tmp_jls_path(self, vindex: int) -> str:
        return self._t(f"jls{vindex}.txt")

    def tmp_div_path(self, vindex: int) -> str:
        return self._t(f"div{vindex}.txt")

    def tmp_autovfr_prefix(self, vindex: int) -> str:
        """Prefix for the AutoVfr flow's log/def files (ref Misc.cs:1369:
        AMT_TMP + '.autovfr*.log' / '.autovfr.def')."""
        return self._t(f"v{vindex}")

    def tmp_filter_dump_path(self, key: EncodeFileKey) -> str:
        return self._t(f"filter{self._key(key)}.json")

    def tmp_chapter_path(self, key: EncodeFileKey) -> str:
        return self._t(f"chapter{self._key(key)}.txt")

    def tmp_nicojk_ass_path(self, key: EncodeFileKey, jktype: int) -> str:
        return self._t(f"nicojk{self._key(key)}-{NICOJK_TYPES[jktype]}.ass")

    def vfr_tmp_file_path(self, key: EncodeFileKey) -> str:
        """Intermediate mux output before timelineeditor applies timecodes
        (ref getVfrTmpFilePath)."""
        return self._t(f"t{self._key(key)}.mp4")

    def m2ts_meta_path(self, key: EncodeFileKey) -> str:
        return self._t(f"t{self._key(key)}.meta")

    # -- output naming (ref :999-1030) -----------------------------------------
    def output_extension(self) -> str:
        return self.conf.format.value

    def out_file_path(self, key: EncodeFileKey, key_max: EncodeFileKey) -> str:
        s = self.conf.out_video_path
        if key.format > 0:
            s += f"-{key.format}"
        if key_max.div > 1:
            s += f"_div{key.div + 1}"
        s += _cm_suffix(key.cm)
        return f"{s}.{self.output_extension()}"

    def out_ass_path(self, key: EncodeFileKey, key_max: EncodeFileKey,
                     langidx: int, jktype: int = -1) -> str:
        return self.out_sub_path(key, key_max, langidx, jktype, ".ass")

    def out_sub_path(self, key: EncodeFileKey, key_max: EncodeFileKey,
                     langidx: int, jktype: int = -1,
                     ext: str = ".ass") -> str:
        s = self.conf.out_video_path
        if key.format > 0:
            s += f"-{key.format}"
        if key_max.div > 1:
            s += f"_div{key.div + 1}"
        s += _cm_suffix(key.cm)
        if langidx < 0:
            s += f"-nicojk{NICOJK_TYPES[jktype]}"
        elif langidx > 0:
            s += f"-{langidx}"
        return s + ext

    # -- bitrate ----------------------------------------------------------------
    def target_bitrate(self, fmt: VideoStreamFormat, src_bitrate_kbps: float) -> float:
        return self.conf.bitrate.target_bitrate(fmt, src_bitrate_kbps)


# ---------------------------------------------------------------------------
# command-line builders (host-side; the encoders/muxers stay subprocesses)
# ---------------------------------------------------------------------------

_COLOR_PRIM = {1: "bt709", 4: "bt470m", 5: "bt470bg", 6: "smpte170m",
               7: "smpte240m", 8: "film", 9: "bt2020"}
_TRANSFER = {1: "bt709", 4: "bt470m", 5: "bt470bg", 6: "smpte170m",
             7: "smpte240m", 8: "linear", 11: "xvycc", 14: "bt2020-10",
             15: "bt2020-12"}
_COLOR_MATRIX = {0: "GBR", 1: "bt709", 4: "fcc", 5: "bt470bg", 6: "smpte170m",
                 7: "smpte240m", 8: "YCgCo", 9: "bt2020nc", 10: "bt2020c"}


# the port's own encoder shims (tools/x264_shim.py, tools/aac_shim.py)
_TOOLS = __package__.rsplit(".", 1)[0] + ".tools"


def resolve_encoder_command(args: str, encoder: Encoder) -> str:
    """Swap a missing x264 binary for the in-build libx264 shim
    (tools/x264_shim over the FFmpeg bridge) so transcodes emit real
    H.264 with no external encoder installed. Non-x264 encoders and
    existing binaries pass through unchanged."""
    import shlex
    import shutil as _sh
    import sys as _sys

    try:
        head = shlex.split(args)[0]
    except (ValueError, IndexError):
        return args
    if _sh.which(head) or os.path.exists(head):
        return args
    codec = {Encoder.X264: "libx264", Encoder.X265: "libx265",
             Encoder.SVTAV1: "libsvtav1"}.get(encoder)
    if codec is None:
        return args
    try:
        from ..video.avdec import avdec_available

        if not avdec_available():
            return args
    except Exception:  # noqa: BLE001
        return args
    rest = shlex.join(shlex.split(args)[1:])
    return (f'"{_sys.executable}" -m {_TOOLS}.x264_shim '
            f"--shim-codec {codec} {rest}")


def make_encoder_args(
    encoder: Encoder,
    binpath: str,
    options: str,
    fmt: VideoFormat,
    outpath: str,
    timecodepath: str = "",
    vfr_timing_fps: int = 0,
    pass_index: int = -1,
    stats_path: str = "",
) -> str:
    """Per-encoder colorspace/interlace/y4m flags (ref makeEncoderArgs :132-216).
    pass_index 1/2 + stats_path drive two-pass rate control (x264/x265)."""
    parts = [f'"{binpath}"']
    if pass_index > 0 and encoder in (Encoder.X264, Encoder.X265):
        parts.append(f'--pass {pass_index} --stats "{stats_path}"')
    if encoder != Encoder.SVTAV1:
        if fmt.color_primaries != 2 and fmt.color_primaries in _COLOR_PRIM:
            parts.append(f"--colorprim {_COLOR_PRIM[fmt.color_primaries]}")
        if fmt.transfer_characteristics != 2 and fmt.transfer_characteristics in _TRANSFER:
            parts.append(f"--transfer {_TRANSFER[fmt.transfer_characteristics]}")
        if fmt.color_space != 2 and fmt.color_space in _COLOR_MATRIX:
            parts.append(f"--colormatrix {_COLOR_MATRIX[fmt.color_space]}")

    if encoder in (Encoder.X264, Encoder.QSVENC, Encoder.NVENC, Encoder.VCEENC):
        if not fmt.progressive:
            parts.append("--tff")
    elif encoder in (Encoder.X265, Encoder.SVTAV1):
        if not fmt.progressive:
            raise ValueError(f"{encoder.value} interlaced output is not supported")

    if encoder == Encoder.SVTAV1:
        parts.append(f'{options} -b "{outpath}"')
    else:
        parts.append(f'{options} -o "{outpath}"')

    if encoder == Encoder.X264:
        parts.append("--stitchable")
        parts.append("--demuxer y4m -")
    elif encoder == Encoder.X265:
        parts.append("--no-opt-qp-pps --no-opt-ref-list-length-pps")
        parts.append("--y4m --input -")
    elif encoder in (Encoder.QSVENC, Encoder.NVENC, Encoder.VCEENC):
        parts.append("--format raw --y4m -i -")
    elif encoder == Encoder.SVTAV1:
        parts.append("-i stdin")

    if timecodepath and encoder == Encoder.X264:
        num = fmt.frame_rate_num * (vfr_timing_fps // 30)
        den = fmt.frame_rate_denom
        parts.append(f'--tcfile-in "{timecodepath}" --timebase {den}/{num}')

    return " ".join(parts)


def resolve_audio_encoder_command(args: str) -> str:
    """Swap a missing external AAC encoder for the in-build libavcodec
    shim (tools/aac_shim); existing binaries pass through unchanged."""
    import shlex
    import shutil as _sh
    import sys as _sys

    try:
        head = shlex.split(args)[0]
    except (ValueError, IndexError):
        return args
    if _sh.which(head) or os.path.exists(head):
        return args
    try:
        from ..video.avdec import avdec_available

        if not avdec_available():
            return args
    except Exception:  # noqa: BLE001
        return args
    rest = shlex.join(shlex.split(args)[1:])
    return (f'"{_sys.executable}" -m {_TOOLS}.aac_shim '
            f"{rest}")


def make_audio_encoder_args(encoder: AudioEncoder, binpath: str, options: str,
                            kbps: int, outpath: str) -> str:
    """(ref makeAudioEncoderArgs :225-261)."""
    parts = [f'"{binpath}" {options}']
    if kbps:
        flag = {AudioEncoder.NEROAAC: "-br", AudioEncoder.QAAC: "-a",
                AudioEncoder.FDKAAC: "-b"}.get(encoder)
        if flag:
            parts.append(f"{flag} {kbps * 1000} ")
    if encoder == AudioEncoder.NEROAAC:
        parts.append(f'-if - -of "{outpath}"')
    else:
        parts.append(f'-o "{outpath}" -')
    return " ".join(parts)


def make_muxer_args(
    fmt: OutputFormat,
    binpath: str,
    timelineeditor_path: str,
    mp4box_path: str,
    in_video: str,
    video_format: VideoFormat,
    in_audios: list[str],
    outpath: str,
    tmpoutpath: str,
    chapterpath: str = "",
    timecodepath: str = "",
    timebase: tuple[int, int] = (0, 0),
    in_subs: list[str] | None = None,
    subs_titles: list[str] | None = None,
    metapath: str = "",
) -> list[tuple[str, bool]]:
    """Muxer command sequences (ref makeMuxerArgs :263-377).

    Returns [(command, show_output)]. mp4 = L-SMASH muxer -> timelineeditor
    (timecodes) -> mp4box (chapter/SRT); mkv = mkvmerge; ts/m2ts = tsMuxeR.
    """
    in_subs = in_subs or []
    subs_titles = subs_titles or []
    ret: list[tuple[str, bool]] = []

    if fmt == OutputFormat.MP4:
        need_chapter = bool(chapterpath)
        need_timecode = bool(timecodepath)
        need_subs = bool(in_subs)
        parts = [f'"{binpath}"']
        if video_format.fixed_frame_rate:
            parts.append(
                f'-i "{in_video}?fps={video_format.frame_rate_num}/'
                f'{video_format.frame_rate_denom}"'
            )
        else:
            parts.append(f'-i "{in_video}"')
        for a in in_audios:
            parts.append(f'-i "{a}"')
        if need_chapter and not need_timecode:
            parts.append(f'--chapter "{chapterpath}"')
            need_chapter = False
        parts.append("--optimize-pd")
        dst = tmpoutpath if need_timecode else outpath
        parts.append(f'-o "{dst}"')
        ret.append((" ".join(parts), False))

        if need_timecode:
            ret.append((
                f'"{timelineeditor_path}" --track 1 --timecode "{timecodepath}"'
                f" --media-timescale {timebase[0]}"
                f" --media-timebase {timebase[1]}"
                f' "{dst}" "{outpath}"',
                False,
            ))

        if need_chapter or need_subs:
            parts = [f'"{mp4box_path}"']
            for sub, title in zip(in_subs, subs_titles):
                if title == "SRT":  # mp4 takes SRT only
                    parts.append(f'-add "{sub}#:name={title}"')
            if need_chapter:
                parts.append(f'-chap "{chapterpath}"')
            parts.append(f'"{outpath}"')
            ret.append((" ".join(parts), True))

    elif fmt == OutputFormat.MKV:
        parts = [f'"{binpath}"']
        if chapterpath:
            parts.append(f'--chapters "{chapterpath}"')
        parts.append(f'-o "{outpath}"')
        if timecodepath:
            parts.append(f'--timestamps "0:{timecodepath}"')
        parts.append(f'"{in_video}"')
        for a in in_audios:
            parts.append(f'"{a}"')
        for sub, title in zip(in_subs, subs_titles):
            parts.append(f'--track-name "0:{title}" "{sub}"')
        ret.append((" ".join(parts), True))

    else:  # M2TS / TS via tsMuxeR
        ret.append((f'"{binpath}" "{metapath}" "{outpath}"', True))

    return ret
