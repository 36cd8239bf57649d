"""Output-timeline reconstruction: the "truth" of the pipeline.

Parity: StreamReformInfo in the reference (Amatsukaze/StreamReform.hpp:211-1502).
Decision-identical behaviours preserved:

- 33-bit PTS wrap-around unwrap via signed-32-bit deltas (makeModifiedPTS,
  ref :1053-1083)
- stream-event sectioning into output formats with a 3 s tolerance
  (ref :678-771), splitSub main-format merging (ref :794-833)
- RFF/pulldown expansion of coded frames into filter frames: TFF_RFF kept
  single, FRAME_DOUBLING/TRIPLING duplicated, BFF half-frame delay
  (ref :841-908)
- output-file enumeration EncodeFileKey{video,format,div,cm} (ref :953-1051)
- audio reform: per-output audio frame selection tracking drift, skipping
  overlaps (>1/2 frame early), duplicating into gaps (>=3/4 frame),
  re-searching on lost sync, with AudioDiffInfo stats (ref :1131-1417)
- fake-CFR wave stream for CM analysis (ref :1177-1219)
- caption/NicoJK time mapping to output frames (ref :1428-1501)
- binary serialize/deserialize for resume/tests (ref :454-480)

All times are 90 kHz doubles, as in the reference (a 59.94fps frame duration
is not integral in 90 kHz).

The port's copy of amatsukaze_tpu/reform/stream_reform.py.
"""

from __future__ import annotations

import bisect
import calendar
import enum
import math
import struct
from dataclasses import dataclass, field

from ..types import (
    AudioFormat,
    AudioChannels,
    CMType,
    EncodeFileKey,
    PictureType,
    VideoFormat,
    VideoFrameInfo,
    VideoStreamFormat,
    FrameType,
)
from ..utils.context import AMTContext, ErrorCounter, FormatError

MPEG_CLOCK_HZ = 90_000
CHANGE_TOLERANCE = 3 * MPEG_CLOCK_HZ  # merge events closer than 3 s (ref :676)


class StreamEventType(enum.IntEnum):
    NONE = 0
    PID_TABLE_CHANGED = 1
    VIDEO_FORMAT_CHANGED = 2
    AUDIO_FORMAT_CHANGED = 3


@dataclass
class StreamEvent:
    type: StreamEventType
    frame_idx: int = 0  # video or audio frame number
    audio_idx: int = 0  # AUDIO_FORMAT_CHANGED only
    num_audio: int = 0  # PID_TABLE_CHANGED only


@dataclass
class FileVideoFrameInfo(VideoFrameInfo):
    file_offset: int = 0


@dataclass
class FileAudioFrameInfo:
    pts: int = -1
    num_samples: int = 0
    format: AudioFormat = field(default_factory=AudioFormat)
    audio_idx: int = 0
    coded_data_size: int = 0
    wave_data_size: int = 0
    file_offset: int = 0
    wave_offset: int = -1


@dataclass
class CaptionDuration:
    start_pts: float = 0.0
    end_pts: float = 0.0


@dataclass
class OutVideoFormat:
    format_id: int = -1
    video_file_id: int = -1
    video_format: VideoFormat = field(default_factory=VideoFormat)
    audio_format: list = field(default_factory=list)


@dataclass
class AudioDiffInfo:
    """Audio drift statistics (ref StreamReform.hpp:86-137)."""

    sum_pts_diff: float = 0.0
    total_src_frames: int = 0
    total_audio_frames: int = 0
    total_unique_audio_frames: int = 0
    max_pts_diff: float = 0.0
    max_pts_diff_pos: float = 0.0
    base_pts: float = 0.0

    def avg_diff_seconds(self) -> float:
        if self.total_audio_frames == 0:
            return 0.0
        return (self.sum_pts_diff / self.total_audio_frames) / MPEG_CLOCK_HZ

    def max_diff_seconds(self) -> float:
        return self.max_pts_diff / MPEG_CLOCK_HZ

    def to_json(self) -> dict:
        not_included = self.total_src_frames - self.total_unique_audio_frames
        return {
            "totalsrcframes": self.total_src_frames,
            "totaloutframes": self.total_audio_frames,
            "totaloutuniqueframes": self.total_unique_audio_frames,
            "notincludedper": not_included * 100 / self.total_src_frames
            if self.total_src_frames
            else 0.0,
            "avgdiff": self.avg_diff_seconds() * 1000,
            "maxdiff": self.max_diff_seconds() * 1000,
            "maxdiffpos": (self.max_pts_diff_pos - self.base_pts) / MPEG_CLOCK_HZ
            if self.max_pts_diff > 0
            else 0.0,
        }


@dataclass
class FilterSourceFrame:
    """One filter-input frame after RFF expansion (ref StreamReform.hpp:145-155)."""

    half_delay: bool = False
    frame_index: int = 0  # DTS-order coded frame index
    pts: float = 0.0
    frame_duration: float = 0.0
    frame_pts: int = 0
    file_offset: int = 0
    key_frame: int = 0
    cm_type: CMType = CMType.NONCM


@dataclass
class FilterAudioFrame:
    frame_index: int = 0
    wave_offset: int = -1
    wave_length: int = 0


@dataclass
class OutCaptionLine:
    start: float = 0.0
    end: float = 0.0
    line: object = None


@dataclass
class NicoJKLine:
    start: float = 0.0
    end: float = 0.0
    line: str = ""


NICOJK_MAX = 4


@dataclass
class EncodeFileOutput:
    """Per-output-file metadata (ref EncodeFileInput, StreamReform.hpp:200-209)."""

    key: EncodeFileKey = field(default_factory=EncodeFileKey)
    out_key: EncodeFileKey = field(default_factory=EncodeFileKey)
    key_max: EncodeFileKey = field(default_factory=EncodeFileKey)
    duration: float = 0.0
    video_frames: list = field(default_factory=list)  # filter-frame indices
    audio_frames: list = field(default_factory=list)  # per-audio lists of src indices
    caption_list: list = field(default_factory=list)  # per-lang lists of OutCaptionLine
    nicojk_list: list = field(default_factory=lambda: [[] for _ in range(NICOJK_MAX)])


@dataclass
class _AudioState:
    time: float = 0.0
    lost_pts: float = -1.0
    last_frame: int = -1


class _OutFileState:
    __slots__ = ("format_id", "time", "audio_state", "audio_frame_list")

    def __init__(self, format_id: int, num_audio: int):
        self.format_id = format_id
        self.time = 0.0
        self.audio_state = [_AudioState() for _ in range(num_audio)]
        self.audio_frame_list = [[] for _ in range(num_audio)]


def unwrap_pts_sequence(first_mod_pts: int, pts_list) -> list[float]:
    """33-bit wrap-around unwrap via signed-32-bit deltas (ref :1053-1083)."""
    out = []
    prev = first_mod_pts
    for pts in pts_list:
        d = (pts - prev) & 0xFFFFFFFF
        if d >= 1 << 31:
            d -= 1 << 32
        mod = prev + d
        out.append(float(mod))
        prev = mod
    return out


class StreamReformInfo:
    def __init__(
        self,
        ctx: AMTContext,
        num_video_file: int,
        video_frame_list: list[FileVideoFrameInfo],
        audio_frame_list: list[FileAudioFrameInfo],
        caption_item_list: list,
        stream_event_list: list[StreamEvent],
        time_list: list,  # [(clock27M, JSTTime)]
    ):
        self.ctx = ctx
        self.num_video_file = num_video_file
        self.video_frame_list = video_frame_list
        self.audio_frame_list = audio_frame_list
        self.caption_item_list = caption_item_list
        self.stream_event_list = stream_event_list
        self.time_list = time_list

        self.nicojk_list = [[] for _ in range(NICOJK_MAX)]
        self.is_encode_audio = False
        self.is_vfr = False
        self.has_rff = False
        self.src_total_duration = 0.0
        self.out_total_duration = 0.0
        self.first_frame_time: int | None = None  # unix time

        # computed
        self.modified_pts: list[float] = []  # [DTS order]
        self.modified_audio_pts: list[float] = []
        self.modified_caption_pts: list[float] = []
        self.audio_frame_duration: list[float] = []
        self.ordered_video_frame: list[int] = []  # [PTS order] -> [DTS order]
        self.data_pts: list[float] = []
        self.stream_event_pts: list[float] = []
        self.caption_duration: list[CaptionDuration] = []
        self.index_audio_frame_list: list[list[int]] = []
        self.formats: list[OutVideoFormat] = []
        # starts empty: the first VIDEO_FORMAT_CHANGED appends index 0
        self.format_start_index: list[int] = []
        self.file_format_id: list[int] = []
        self.file_format_start_index: list[int] = []
        self.filter_frame_list: list[list[FilterSourceFrame]] = []
        self.filter_audio_frame_list: list[list[FilterAudioFrame]] = []
        self.filter_src_size: list[int] = []
        self.filter_src_duration: list[float] = []
        self.file_divs: list[list[int]] = []
        self.frame_format_id: list[int] = []
        self.out_file_keys: list[EncodeFileKey] = []
        self.out_files: dict[int, EncodeFileOutput] = {}
        self.audio_file_offsets: list[int] = []

    # ------------------------------------------------------------------ public
    def prepare(self, split_sub: bool, is_encode_audio: bool = False) -> None:
        """Step 1: build the timeline model (ref :237-241)."""
        self.is_encode_audio = is_encode_audio
        self._reform_main(split_sub)
        self._gen_wave_audio_stream()

    def set_nicojk_list(self, nicojk_list) -> None:
        start = self.data_pts[0]
        self.nicojk_list = [
            [NicoJKLine(s.start + start, s.end + start, s.line) for s in lst]
            for lst in nicojk_list
        ]

    def apply_cm_zones(self, video_file_index: int, cm_zones, divs: list[int]) -> None:
        """Step 2, after CM analysis. cm_zones: [(startFrame, endFrame)]
        in filter-frame indices (ref :264-275)."""
        frames = self.filter_frame_list[video_file_index]
        for start, end in cm_zones:
            for i in range(start, min(end, len(frames))):
                frames[i].cm_type = CMType.CM
        self.file_divs[video_file_index] = list(divs)

    def gen_audio(self, cmtypes: list[CMType]) -> AudioDiffInfo:
        """Step 3, before encoding (ref :279-283)."""
        self._calc_size_and_time(cmtypes)
        self._gen_caption_stream()
        return self._gen_audio_stream()

    # ----------------------------------------------------------------- queries
    def get_video_stream_format(self) -> VideoStreamFormat:
        return self.video_frame_list[0].format.format

    def get_pid_changed_list(self, video_file_index: int) -> list[int]:
        """PMT-change points as filter-frame indices (ref :296-315)."""
        frames = self.filter_frame_list[video_file_index]
        keys = [self.data_pts[f.frame_index] for f in frames]
        ret: list[int] = []
        for ev, pts in zip(self.stream_event_list, self.stream_event_pts):
            if ev.type == StreamEventType.PID_TABLE_CHANGED:
                idx = bisect.bisect_left(keys, pts)
                if not ret or ret[-1] != idx:
                    ret.append(idx)
        return ret

    def get_main_video_file_index(self) -> int:
        sizes = [len(l) for l in self.filter_frame_list]
        return sizes.index(max(sizes)) if sizes else 0

    def get_filter_source_frames(self, video_file_index: int):
        return self.filter_frame_list[video_file_index]

    def get_filter_source_audio_frames(self, video_file_index: int):
        return self.filter_audio_frame_list[video_file_index]

    def get_encode_file(self, key: EncodeFileKey) -> EncodeFileOutput:
        return self.out_files[key.key()]

    def get_num_encoders(self, video_file_index: int) -> int:
        return (
            self.file_format_start_index[video_file_index + 1]
            - self.file_format_start_index[video_file_index]
        )

    def get_video_frame_info(self, frame_index: int) -> FileVideoFrameInfo:
        return self.video_frame_list[frame_index]

    def get_encoder_index(self, frame_index: int) -> int:
        file_id = self.frame_format_id[frame_index]
        fmt = self.formats[self.file_format_id[file_id]]
        return file_id - self.format_start_index[fmt.video_file_id]

    def get_format(self, key: EncodeFileKey) -> OutVideoFormat:
        file_id = self.file_format_start_index[key.video] + key.format
        return self.formats[self.file_format_id[file_id]]

    def get_out_file_keys(self) -> list[EncodeFileKey]:
        return self.out_file_keys

    def get_src_video_info(self, video_file_index: int):
        return (
            self.filter_src_size[video_file_index],
            self.filter_src_duration[video_file_index],
        )

    def get_audio_file_offsets(self):
        return self.audio_file_offsets

    def get_in_out_duration(self):
        return self.src_total_duration, self.out_total_duration

    def get_wave_input(self, frame_list: list[int]) -> list[FilterAudioFrame]:
        return [
            FilterAudioFrame(
                frame_index=i,
                wave_offset=self.audio_frame_list[i].wave_offset,
                wave_length=self.audio_frame_list[i].wave_data_size,
            )
            for i in frame_list
        ]

    # ------------------------------------------------------------------- core
    def _reform_main(self, split_sub: bool) -> None:
        if not self.video_frame_list:
            raise FormatError("no video frames")
        if not self.audio_frame_list:
            raise FormatError("no audio frames")
        if (
            not self.stream_event_list
            or self.stream_event_list[0].type != StreamEventType.PID_TABLE_CHANGED
        ):
            raise FormatError("invalid stream event data")

        # VFR detection (not yet supported, as in the reference :573-575)
        self.is_vfr = any(
            not f.format.fixed_frame_rate for f in self.video_frame_list
        )
        if self.is_vfr:
            raise FormatError("VFR input is not supported")

        # unwrap each component's start PTS against the video start
        start_ptss = [self.video_frame_list[0].pts, self.audio_frame_list[0].pts]
        if self.caption_item_list:
            start_ptss.append(self.caption_item_list[0].pts)
        mod_starts = []
        prev = start_ptss[0]
        for pts in start_ptss:
            d = (pts - prev) & 0xFFFFFFFF
            if d >= 1 << 31:
                d -= 1 << 32
            prev = prev + d
            mod_starts.append(prev)

        self.modified_pts = self._make_modified_pts(
            mod_starts[0], [f.pts for f in self.video_frame_list]
        )
        self.modified_audio_pts = self._make_modified_pts(
            mod_starts[1], [f.pts for f in self.audio_frame_list]
        )
        self.modified_caption_pts = (
            self._make_modified_pts(
                mod_starts[2], [c.pts for c in self.caption_item_list]
            )
            if self.caption_item_list
            else []
        )

        self.audio_frame_duration = [
            f.num_samples * MPEG_CLOCK_HZ / f.format.sample_rate
            for f in self.audio_frame_list
        ]

        self.ordered_video_frame = sorted(
            range(len(self.video_frame_list)), key=lambda i: self.modified_pts[i]
        )

        # dataPTS: running minimum of future PTS (stream position <-> PTS)
        n = len(self.video_frame_list)
        self.data_pts = [0.0] * n
        cur_min = math.inf
        cur_max = 0.0
        for i in range(n - 1, -1, -1):
            cur_min = min(cur_min, self.modified_pts[i])
            cur_max = max(cur_max, self.modified_pts[i])
            self.data_pts[i] = cur_min

        # caption durations: shown until the next clear (ref :640-655)
        self.caption_duration = [CaptionDuration() for _ in self.caption_item_list]
        cur_end = self.data_pts[-1]
        for i in range(len(self.caption_item_list) - 1, -1, -1):
            item = self.caption_item_list[i]
            mod = self.modified_caption_pts[i] + item.wait_time * (MPEG_CLOCK_HZ // 1000)
            if item.line is not None:
                self.caption_duration[i] = CaptionDuration(mod, cur_end)
            else:
                self.caption_duration[i] = CaptionDuration(mod, mod)
                cur_end = mod

        # stream-event PTS
        end_pts = cur_max + 1
        self.stream_event_pts = []
        for ev in self.stream_event_list:
            pts = -1.0
            if ev.type in (
                StreamEventType.PID_TABLE_CHANGED,
                StreamEventType.VIDEO_FORMAT_CHANGED,
            ):
                pts = (
                    end_pts
                    if ev.frame_idx >= len(self.video_frame_list)
                    else self.data_pts[ev.frame_idx]
                )
            elif ev.type == StreamEventType.AUDIO_FORMAT_CHANGED:
                pts = (
                    end_pts
                    if ev.frame_idx >= len(self.audio_frame_list)
                    else self.modified_audio_pts[ev.frame_idx]
                )
            self.stream_event_pts.append(pts)

        # section the stream into output formats (ref :678-771)
        section_format_list: list[int] = []
        start_pts_list: list[float] = []
        cur_audio_formats: list[AudioFormat] = []
        cur_format = OutVideoFormat()
        state = {"start_pts": -1.0, "cur_from_pts": -1.0, "cur_video_from_pts": -1.0}

        self.ctx.info("[format switch analysis]")

        def add_section():
            self._register_or_get_format(cur_format)
            section_format_list.append(cur_format.format_id)
            start_pts_list.append(state["cur_from_pts"])
            if state["start_pts"] == -1:
                state["start_pts"] = state["cur_from_pts"]
            self.ctx.info(
                "%.2f -> %d",
                (state["cur_from_pts"] - state["start_pts"]) / 90000.0,
                cur_format.format_id,
            )
            state["cur_from_pts"] = -1.0
            state["cur_video_from_pts"] = -1.0

        for ev, pts in zip(self.stream_event_list, self.stream_event_pts):
            if pts >= end_pts:
                continue  # no video frames after this event
            if (
                state["cur_from_pts"] != -1
                and cur_format.video_file_id >= 0
                and state["cur_from_pts"] + CHANGE_TOLERANCE < pts
            ):
                add_section()
            if ev.type == StreamEventType.PID_TABLE_CHANGED:
                if len(cur_audio_formats) < ev.num_audio:
                    cur_audio_formats += [AudioFormat()] * (
                        ev.num_audio - len(cur_audio_formats)
                    )
                if len(cur_format.audio_format) != ev.num_audio:
                    cur_format.audio_format = list(cur_audio_formats[: ev.num_audio])
                    if state["cur_from_pts"] == -1:
                        state["cur_from_pts"] = pts
            elif ev.type == StreamEventType.VIDEO_FORMAT_CHANGED:
                new_fmt = self.video_frame_list[ev.frame_idx].format
                if not cur_format.video_format.is_basic_equals(new_fmt):
                    # size/fps change -> new intermediate video file
                    cur_format.video_file_id += 1
                    self.format_start_index.append(len(self.formats))
                cur_format.video_format = new_fmt
                if state["cur_video_from_pts"] != -1:
                    # consecutive video format changes cannot merge
                    add_section()
                state["cur_from_pts"] = state["cur_video_from_pts"] = self.data_pts[
                    ev.frame_idx
                ]
            elif ev.type == StreamEventType.AUDIO_FORMAT_CHANGED:
                if ev.audio_idx >= len(cur_format.audio_format):
                    raise FormatError(
                        "audio idx exceeds numAudio of the previous table change"
                    )
                fmt = self.audio_frame_list[ev.frame_idx].format
                cur_format.audio_format[ev.audio_idx] = fmt
                cur_audio_formats[ev.audio_idx] = fmt
                if state["cur_from_pts"] == -1:
                    state["cur_from_pts"] = pts
        if state["cur_from_pts"] != -1:
            add_section()
        start_pts_list.append(end_pts)
        self.format_start_index.append(len(self.formats))

        # frame -> section mapping
        out_format_frames = [0] * len(self.formats)
        frame_section_id = [0] * n
        for i in range(n):
            pts = self.modified_pts[i]
            section_id = bisect.bisect_right(start_pts_list, pts) - 1
            if section_id >= len(section_format_list):
                raise RuntimeError(
                    f"sectionId {section_id} exceeds section count at frame {i}"
                )
            frame_section_id[i] = section_id
            out_format_frames[section_format_list[section_id]] += 1

        # section -> output-file mapping (splitSub merges non-main formats)
        section_file_list = [0] * len(section_format_list)
        if split_sub:
            main_format_id = out_format_frames.index(max(out_format_frames))
            self.file_format_start_index = [0]
            main_file_id = -1
            next_file_id = 0
            video_id = 0
            for i, sec_fmt in enumerate(section_format_list):
                vid = self.formats[sec_fmt].video_file_id
                if video_id != vid:
                    self.file_format_start_index.append(next_file_id)
                    video_id = vid
                if sec_fmt == main_format_id:
                    if main_file_id == -1:
                        main_file_id = next_file_id
                        next_file_id += 1
                        self.file_format_id.append(main_format_id)
                    section_file_list[i] = main_file_id
                else:
                    section_file_list[i] = next_file_id
                    next_file_id += 1
                    self.file_format_id.append(sec_fmt)
            self.file_format_start_index.append(len(self.file_format_id))
        else:
            section_file_list = list(section_format_list)
            self.file_format_id = list(range(len(self.formats)))
            self.file_format_start_index = list(self.format_start_index)

        self.frame_format_id = [
            section_file_list[frame_section_id[i]] for i in range(n)
        ]

        # filter-input frame lists with RFF expansion (ref :841-908)
        self.filter_frame_list = [[] for _ in range(self.num_video_file)]
        for video_id in range(self.num_video_file):
            lst = self.filter_frame_list[video_id]
            key_frame = -1
            fmt = self.formats[self.format_start_index[video_id]].video_format
            time_per_frame = fmt.frame_rate_denom * MPEG_CLOCK_HZ / fmt.frame_rate_num

            for i in range(n):
                ordered = self.ordered_video_frame[i]
                format_id = self.file_format_id[self.frame_format_id[ordered]]
                if self.formats[format_id].video_file_id != video_id:
                    continue
                m_pts = self.modified_pts[ordered]
                src = self.video_frame_list[ordered]
                if src.is_gop_start:
                    key_frame = len(lst)
                if key_frame == -1:
                    continue  # drop frames before the first keyframe

                def base_frame(pts, half_delay=False):
                    return FilterSourceFrame(
                        half_delay=half_delay,
                        frame_index=i,
                        pts=pts,
                        frame_duration=time_per_frame,
                        frame_pts=int(m_pts),
                        file_offset=src.file_offset,
                        key_frame=key_frame,
                        cm_type=CMType.NONCM,
                    )

                pic = src.pic
                if pic in (PictureType.FRAME, PictureType.TFF, PictureType.TFF_RFF):
                    lst.append(base_frame(m_pts))
                elif pic == PictureType.FRAME_DOUBLING:
                    lst.append(base_frame(m_pts))
                    lst.append(base_frame(m_pts + time_per_frame))
                elif pic == PictureType.FRAME_TRIPLING:
                    lst.append(base_frame(m_pts))
                    lst.append(base_frame(m_pts + time_per_frame))
                    lst.append(base_frame(m_pts + 2 * time_per_frame))
                elif pic == PictureType.BFF:
                    lst.append(base_frame(m_pts - time_per_frame / 2, half_delay=True))
                elif pic == PictureType.BFF_RFF:
                    lst.append(base_frame(m_pts - time_per_frame / 2, half_delay=True))
                    lst.append(base_frame(m_pts + time_per_frame / 2))

        # per-audio-index source frame lists
        num_max_audio = max(
            [1] + [len(f.audio_format) for f in self.formats]
        )
        self.index_audio_frame_list = [[] for _ in range(num_max_audio)]
        for i, af in enumerate(self.audio_frame_list):
            if af.audio_idx < num_max_audio:
                self.index_audio_frame_list[af.audio_idx].append(i)

        # audio file offsets (for the wave cache)
        self.audio_file_offsets = [f.file_offset for f in self.audio_frame_list]
        last = self.audio_frame_list[-1]
        self.audio_file_offsets.append(last.file_offset + last.coded_data_size)

        # totals + first frame wall-clock time
        self.src_total_duration = self.data_pts[-1] - self.data_pts[0]
        if self.time_list:
            clock, jst = self.time_list[0]
            diff32 = clock // 300 - int(self.data_pts[0])
            diff32 = ((diff32 & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000  # int32
            diff = diff32 / MPEG_CLOCK_HZ
            y, mo, d = jst.get_day()
            h, mi, s = jst.get_time()
            # JST = GMT+9; rewind to the first video frame
            t = calendar.timegm((y, mo, d, h - 9, mi, s, 0, 0, 0))
            self.first_frame_time = t - round(diff)

        self.file_divs = [[] for _ in range(self.num_video_file)]

    def _make_modified_pts(self, first_mod: int, pts_list: list[int]) -> list[float]:
        if not pts_list:
            return []
        for i, pts in enumerate(pts_list):
            if pts == -1:
                raise FormatError(f"missing PTS at frame {i}; cannot process")
        out = unwrap_pts_sequence(first_mod, pts_list)
        for i in range(1, len(out)):
            if out[i] - out[i - 1] < -60 * MPEG_CLOCK_HZ:
                self.ctx.incr(ErrorCounter.NON_CONTINUOUS_PTS)
                self.ctx.warn(
                    "PTS went backwards; audio may not sync. [%d] %.0f -> %.0f",
                    i, out[i - 1], out[i],
                )
        return out

    def _register_or_get_format(self, fmt: OutVideoFormat) -> None:
        for i in range(self.format_start_index[-1], len(self.formats)):
            if self._is_equal_format(self.formats[i], fmt):
                fmt.format_id = i
                return
        fmt.format_id = len(self.formats)
        self.formats.append(
            OutVideoFormat(
                format_id=fmt.format_id,
                video_file_id=fmt.video_file_id,
                video_format=fmt.video_format,
                audio_format=list(fmt.audio_format),
            )
        )

    def _is_equal_format(self, a: OutVideoFormat, b: OutVideoFormat) -> bool:
        if a.video_format != b.video_format:
            return False
        if self.is_encode_audio:
            return True
        return a.audio_format == b.audio_format

    # ------------------------------------------------------------ size & time
    def _calc_size_and_time(self, cmtypes: list[CMType]) -> None:
        for i in range(self.num_video_file):
            if not self.file_divs[i]:
                self.file_divs[i] = [0, len(self.filter_frame_list[i])]

        self.out_file_keys = []
        for video in range(self.num_video_file):
            for fmt in range(self.get_num_encoders(video)):
                for div in range(len(self.file_divs[video]) - 1):
                    for cmtype in cmtypes:
                        self.out_file_keys.append(
                            EncodeFileKey(video, fmt, div, cmtype)
                        )

        self.filter_src_size = [0] * self.num_video_file
        self.filter_src_duration = [0.0] * self.num_video_file
        file_format_duration = [0.0] * len(self.file_format_id)
        n = len(self.video_frame_list)
        for i in range(n):
            ordered = self.ordered_video_frame[i]
            frame = self.video_frame_list[ordered]
            file_format = self.frame_format_id[ordered]
            format_id = self.file_format_id[file_format]
            video_id = self.formats[format_id].video_file_id
            nxt = self.ordered_video_frame[i + 1] if i + 1 < n else -1
            duration = self._get_source_frame_duration(ordered, nxt)
            self.filter_src_size[video_id] += frame.coded_data_size
            self.filter_src_duration[video_id] += duration
            file_format_duration[file_format] += duration

        max_id = file_format_duration.index(max(file_format_duration))
        format_out_index = [0] * len(self.file_format_id)
        cnt = 1
        for i in range(len(format_out_index)):
            if i != max_id:
                format_out_index[i] = cnt
                cnt += 1

        self.out_files = {}
        for key in self.out_file_keys:
            file = EncodeFileOutput()
            file.key = key
            format_id = self.file_format_start_index[key.video] + key.format
            file.out_key = EncodeFileKey(
                0,
                format_out_index[format_id],
                key.div,
                CMType.BOTH if key.cm == cmtypes[0] else key.cm,
            )
            file.key_max = EncodeFileKey(
                0, len(self.file_format_id), len(self.file_divs[key.video]) - 1, key.cm
            )
            frame_list = self.filter_frame_list[key.video]
            start = self.file_divs[key.video][key.div]
            end = self.file_divs[key.video][key.div + 1]
            file.video_frames = [
                i
                for i in range(start, end)
                if format_id == self.frame_format_id[frame_list[i].frame_index]
                and (key.cm == CMType.BOTH or key.cm == frame_list[i].cm_type)
            ]
            file.duration = sum(
                frame_list[i].frame_duration for i in file.video_frames
            )
            self.out_files[key.key()] = file

        self.out_total_duration = sum(
            self.out_files[k.key()].duration for k in self.out_file_keys
        )

    def _get_source_frame_duration(self, index: int, next_index: int) -> float:
        frame = self.video_frame_list[index]
        format_id = self.file_format_id[self.frame_format_id[index]]
        fmt = self.formats[format_id].video_format
        frame_diff = fmt.frame_rate_denom * MPEG_CLOCK_HZ / fmt.frame_rate_num
        if self.is_vfr:
            if next_index == -1:
                return 0.0
            return self.modified_pts[next_index] - self.modified_pts[index]
        mul = {
            PictureType.TFF_RFF: 1.5,
            PictureType.BFF_RFF: 1.5,
            PictureType.FRAME_DOUBLING: 2.0,
            PictureType.FRAME_TRIPLING: 3.0,
        }.get(frame.pic)
        if mul is not None:
            self.has_rff = True
            return frame_diff * mul
        return frame_diff

    # ------------------------------------------------------------------ audio
    def _gen_audio_stream(self) -> AudioDiffInfo:
        # per-output-file audio selection
        for key in self.out_file_keys:
            format_id = self.file_format_start_index[key.video] + key.format
            file = self.out_files[key.key()]
            src_frames = self.filter_frame_list[key.video]
            audio_formats = self.formats[self.file_format_id[format_id]].audio_format
            state = _OutFileState(format_id, len(audio_formats))
            for vf in file.video_frames:
                frame = src_frames[vf]
                self._add_video_frame(
                    state, audio_formats, frame.pts, frame.frame_duration, None
                )
            file.audio_frames = state.audio_frame_list

        # second pass for drift statistics
        adiff = AudioDiffInfo(
            total_src_frames=len(self.audio_frame_list), base_pts=self.data_pts[0]
        )
        states = [
            _OutFileState(i, len(self.formats[self.file_format_id[i]].audio_format))
            for i in range(len(self.file_format_id))
        ]
        for video_id in range(self.num_video_file):
            for frame in self.filter_frame_list[video_id]:
                file_format = self.frame_format_id[frame.frame_index]
                audio_formats = self.formats[
                    self.file_format_id[file_format]
                ].audio_format
                self._add_video_frame(
                    states[file_format],
                    audio_formats,
                    frame.pts,
                    frame.frame_duration,
                    adiff,
                )
        return adiff

    def _gen_wave_audio_stream(self) -> None:
        """Fake-CFR single-track wave streams for CM analysis (ref :1177-1219)."""
        self.ctx.info("[building wave audio for CM analysis]")
        self.filter_audio_frame_list = [[] for _ in range(self.num_video_file)]
        for video_id in range(self.num_video_file):
            state = _OutFileState(-1, 1)
            frames = self.filter_frame_list[video_id]
            fmt = self.formats[self.format_start_index[video_id]]
            time_per_frame = (
                fmt.video_format.frame_rate_denom
                * MPEG_CLOCK_HZ
                / fmt.video_format.frame_rate_num
            )
            for frame in frames:
                end_pts = frame.pts + time_per_frame
                state.time += time_per_frame
                audio_state = state.audio_state[0]
                if audio_state.time < state.time:
                    duration = state.time - audio_state.time
                    self._fill_audio_frames(
                        state, 0, None, end_pts - duration, duration, None
                    )
            self.filter_audio_frame_list[video_id] = [
                FilterAudioFrame(
                    frame_index=i,
                    wave_offset=self.audio_frame_list[i].wave_offset,
                    wave_length=self.audio_frame_list[i].wave_data_size,
                )
                for i in state.audio_frame_list[0]
            ]

    def _add_video_frame(self, state, audio_formats, pts, duration, adiff) -> None:
        end_pts = pts + duration
        state.time += duration
        for i, afmt in enumerate(audio_formats):
            audio_state = state.audio_state[i]
            if audio_state.time >= state.time:
                continue  # enough audio already
            audio_duration = state.time - audio_state.time
            audio_pts = end_pts - audio_duration
            fmt = None if self.is_encode_audio else afmt
            self._fill_audio_frames(state, i, fmt, audio_pts, audio_duration, adiff)

    def _fill_audio_frames(self, file, index, fmt, pts, duration, adiff) -> None:
        state = file.audio_state[index]
        frame_list = self.index_audio_frame_list[index]

        pts, duration = self._fill_audio_frames_in_order(
            file, index, fmt, pts, duration, adiff
        )
        if duration <= 0:
            return

        # lost the sync point: binary-search a restart position (ref :1298-1317)
        def frame_starts_before(frame_index: int) -> bool:
            mod = self.modified_audio_pts[frame_index]
            return mod + self.audio_frame_duration[frame_index] / 2 < pts

        lo, hi = 0, len(frame_list)
        while lo < hi:
            mid = (lo + hi) // 2
            if frame_starts_before(frame_list[mid]):
                lo = mid + 1
            else:
                hi = mid
        if lo != len(frame_list):
            if state.lost_pts != pts:
                state.lost_pts = pts
                if adiff is not None:
                    self.ctx.debug(
                        "lost audio sync point at %.3f for file %d-%d; re-searching",
                        (pts - self.data_pts[0]) / MPEG_CLOCK_HZ, file.format_id, index,
                    )
            state.last_frame = lo - 1
            self._fill_audio_frames_in_order(file, index, fmt, pts, duration, adiff)

    def _fill_audio_frames_in_order(self, file, index, fmt, pts, duration, adiff):
        state = file.audio_state[index]
        out_list = file.audio_frame_list[index]
        frame_list = self.index_audio_frame_list[index]
        nskipped = 0

        i = state.last_frame + 1
        while i < len(frame_list):
            frame_index = frame_list[i]
            frame = self.audio_frame_list[frame_index]
            mod_pts = self.modified_audio_pts[frame_index]
            frame_duration = self.audio_frame_duration[frame_index]

            if mod_pts >= pts + duration:
                # starts after our window
                if mod_pts >= pts + frame_duration - frame_duration / 4:
                    # off by >= 3/4 frame: stop here
                    break
            if mod_pts + frame_duration / 2 < pts:
                # more than half a frame early: skip
                nskipped += 1
                i += 1
                continue
            if fmt is not None and frame.format != fmt:
                i += 1
                continue

            # duplicate into gaps of >= 3/4 frame (ref :1367)
            nframes = int(max(1.0, ((mod_pts - pts) + frame_duration / 4) / frame_duration))

            if adiff is not None:
                if nframes > 1:
                    self.ctx.debug(
                        "gap at audio %d-%d: inserting %d frame(s)",
                        file.format_id, index, nframes - 1,
                    )
                if nskipped > 0:
                    self.ctx.debug(
                        "audio %d-%d: skipped %d frame(s)", file.format_id, index, nskipped
                    )
                    nskipped = 0
                adiff.total_unique_audio_frames += 1

            for _ in range(nframes):
                if adiff is not None:
                    diff = abs(mod_pts - pts)
                    if adiff.max_pts_diff < diff:
                        adiff.max_pts_diff = diff
                        adiff.max_pts_diff_pos = pts
                    adiff.sum_pts_diff += diff
                    adiff.total_audio_frames += 1
                out_list.append(frame_index)
                state.time += frame_duration
                pts += frame_duration
                duration -= frame_duration

            state.last_frame = i
            if duration <= 0:
                return pts, duration
            i += 1
        return pts, duration

    # ---------------------------------------------------------------- captions
    def _gen_caption_stream(self) -> None:
        self.ctx.info("[building captions]")
        for key in self.out_file_keys:
            file = self.out_files[key.key()]
            src_frames = self.filter_frame_list[key.video]
            frames = file.video_frames
            frame_keys = [src_frames[f].pts for f in frames]

            def get_frame_index(pts: float) -> int:
                return bisect.bisect_left(frame_keys, pts)

            src_pts = [f.pts for f in src_frames]

            def contains_pts(pts: float) -> bool:
                idx = bisect.bisect_left(src_pts, pts)
                if idx < len(src_frames):
                    j = bisect.bisect_left(frames, idx)
                    if j < len(frames) and frames[j] == idx:
                        return True
                return False

            frame_times = [0.0]
            for f in frames:
                frame_times.append(frame_times[-1] + src_frames[f].frame_duration)

            file.caption_list = []
            for i, item in enumerate(self.caption_item_list):
                if item.line is None:
                    continue
                dur = self.caption_duration[i]
                start = get_frame_index(dur.start_pts)
                end = get_frame_index(dur.end_pts)
                if start < end:
                    lang = item.lang_index
                    while len(file.caption_list) <= lang:
                        file.caption_list.append([])
                    file.caption_list[lang].append(
                        OutCaptionLine(frame_times[start], frame_times[end], item.line)
                    )

            file.nicojk_list = [[] for _ in range(NICOJK_MAX)]
            for t in range(NICOJK_MAX):
                for item in self.nicojk_list[t]:
                    if contains_pts(item.start):
                        file.nicojk_list[t].append(
                            NicoJKLine(
                                frame_times[get_frame_index(item.start)],
                                frame_times[get_frame_index(item.end)],
                                item.line,
                            )
                        )

    # -------------------------------------------------------------- serialize
    MAGIC = b"AMTR"
    VERSION = 1

    def serialize(self, path: str) -> None:
        """Binary dump of the parser outputs, for resume and cross-checks
        (ref :454-465)."""
        with open(path, "wb") as f:
            f.write(self.MAGIC)
            f.write(struct.pack("<ii", self.VERSION, self.num_video_file))
            f.write(struct.pack("<i", len(self.video_frame_list)))
            for v in self.video_frame_list:
                fmt = v.format
                f.write(
                    struct.pack(
                        "<qq??BBiq iiiiiiii BBB??",
                        v.pts, v.dts, v.is_gop_start, v.progressive,
                        int(v.pic), int(v.type), v.coded_data_size, v.file_offset,
                        int(fmt.format), fmt.width, fmt.height,
                        fmt.display_width, fmt.display_height,
                        fmt.sar_width, fmt.sar_height, fmt.frame_rate_num,
                        fmt.color_primaries, fmt.transfer_characteristics,
                        fmt.color_space, fmt.progressive, fmt.fixed_frame_rate,
                    )
                )
                f.write(struct.pack("<i", fmt.frame_rate_denom))
            f.write(struct.pack("<i", len(self.audio_frame_list)))
            for a in self.audio_frame_list:
                f.write(
                    struct.pack(
                        "<qiiiiiqq",
                        a.pts, a.num_samples, int(a.format.channels),
                        a.format.sample_rate, a.audio_idx, a.coded_data_size,
                        a.file_offset, a.wave_offset,
                    )
                )
                f.write(struct.pack("<i", a.wave_data_size))
            f.write(struct.pack("<i", len(self.stream_event_list)))
            for e in self.stream_event_list:
                f.write(
                    struct.pack("<iiii", int(e.type), e.frame_idx, e.audio_idx, e.num_audio)
                )
            f.write(struct.pack("<i", len(self.time_list)))
            for clock, jst in self.time_list:
                f.write(struct.pack("<qQ", clock, jst.time))

    @classmethod
    def deserialize(cls, ctx: AMTContext, path: str) -> "StreamReformInfo":
        from ..ts.psi import JSTTime

        with open(path, "rb") as f:
            if f.read(4) != cls.MAGIC:
                raise FormatError("bad reform file magic")
            version, num_video_file = struct.unpack("<ii", f.read(8))
            if version != cls.VERSION:
                raise FormatError("bad reform file version")
            (nv,) = struct.unpack("<i", f.read(4))
            videos = []
            for _ in range(nv):
                vals = struct.unpack(
                    "<qq??BBiq iiiiiiii BBB??", f.read(struct.calcsize("<qq??BBiq iiiiiiii BBB??"))
                )
                (den,) = struct.unpack("<i", f.read(4))
                fmt = VideoFormat(
                    format=VideoStreamFormat(vals[8]), width=vals[9], height=vals[10],
                    display_width=vals[11], display_height=vals[12],
                    sar_width=vals[13], sar_height=vals[14], frame_rate_num=vals[15],
                    frame_rate_denom=den, color_primaries=vals[16],
                    transfer_characteristics=vals[17], color_space=vals[18],
                    progressive=vals[19], fixed_frame_rate=vals[20],
                )
                videos.append(
                    FileVideoFrameInfo(
                        pts=vals[0], dts=vals[1], is_gop_start=vals[2],
                        progressive=vals[3], pic=PictureType(vals[4]),
                        type=FrameType(vals[5]),
                        coded_data_size=vals[6], format=fmt, file_offset=vals[7],
                    )
                )
            (na,) = struct.unpack("<i", f.read(4))
            audios = []
            for _ in range(na):
                vals = struct.unpack("<qiiiiiqq", f.read(struct.calcsize("<qiiiiiqq")))
                (wds,) = struct.unpack("<i", f.read(4))
                audios.append(
                    FileAudioFrameInfo(
                        pts=vals[0], num_samples=vals[1],
                        format=AudioFormat(channels=AudioChannels(vals[2]), sample_rate=vals[3]),
                        audio_idx=vals[4], coded_data_size=vals[5],
                        file_offset=vals[6], wave_offset=vals[7], wave_data_size=wds,
                    )
                )
            (ne,) = struct.unpack("<i", f.read(4))
            events = []
            for _ in range(ne):
                t, fi, ai, na_ = struct.unpack("<iiii", f.read(16))
                events.append(StreamEvent(StreamEventType(t), fi, ai, na_))
            (nt,) = struct.unpack("<i", f.read(4))
            times = []
            for _ in range(nt):
                clock, raw = struct.unpack("<qQ", f.read(16))
                times.append((clock, JSTTime(raw)))
        return cls(ctx, num_video_file, videos, audios, [], events, times)
