"""Pluggable frame decoders.

The reference decodes intermediates with its own FFmpeg integration
(Amatsukaze/ReaderWriterFFmpeg.hpp, AMTSource.hpp). Here decode is a factory
`(pipeline, video_index) -> iterator[(Y, U, V)]`:

- FfmpegDecoder: shells out to an `ffmpeg` binary when one exists
- Mpeg2Decoder: the in-build ISO 13818-2 decoder (the video package),
  native C++ engine with a pure-Python fallback — makes MPEG2 broadcast
  sources fully standalone (no external decoder binary)
- NullDecoder: synthesises grey frames with the reform-derived format (lets
  the full pipeline run end-to-end in environments without a decoder)

The port's copy of amatsukaze_tpu/pipeline/decoders.py, with one repair:
decode_h264_ps_file and annexb_ps_seek_opener crop the in-build H.264
decoders' frames to the SPS's frame cropping rectangle. Neither the native
engine nor the pure-Python oracle crops (both return whole macroblocks:
1088 lines for a 1080-line broadcast), so in the JAX package a cropped
H.264 source stops in the filter stage on frames taller than its format.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def default_decoder_factory():
    """Auto decoder: ffmpeg when a binary exists (any codec), else the
    in-build MPEG2 decoder (the dominant broadcast TS case)."""
    return auto_decoder_factory


def _is_4k(fmt) -> bool:
    """UHD-class coded size (>= 4x the 1080p pixel budget's midpoint)."""
    return fmt.width >= 3000 or fmt.height >= 1600


def auto_decoder_factory(pipeline, video_index: int):
    from ..types import VideoStreamFormat

    fmt = pipeline_format(pipeline, video_index)
    is_mpeg2 = fmt.format in (VideoStreamFormat.MPEG2,
                              VideoStreamFormat.UNKNOWN)
    conf = pipeline.settings.conf
    choice = conf.mpeg2_decoder if is_mpeg2 else conf.h264_decoder
    if choice == "native":
        if is_mpeg2:
            return mpeg2_decoder_factory(pipeline, video_index)
        if fmt.format == VideoStreamFormat.H264:
            return h264ref_decoder_factory(pipeline, video_index)
        if fmt.format == VideoStreamFormat.H265:
            return h265ref_decoder_factory(pipeline, video_index)
    if choice == "ffmpeg":
        return ffmpeg_decoder_factory(pipeline, video_index)
    if choice == "avlib":
        return avlib_decoder_factory(pipeline, video_index)
    if choice == "cv2":
        return cv2_decoder_factory(pipeline, video_index)
    # default: ffmpeg binary > in-build MPEG2 > in-process libav > cv2 >
    # in-build H.264/HEVC (bit-exact, last resort for zero-binary setups).
    # 4K policy (ARCHITECTURE.md "4K HEVC decode policy"): the in-build
    # HEVC engine is bit-exact but single-threaded (~14 fps 4K Main10 on
    # one core), so >=2160p-class sources must ride libavcodec — an
    # explicit "native" choice on a 4K source is honoured but warned.
    if choice == "native" and _is_4k(fmt):
        pipeline.ctx.warn(
            "in-build decoder forced for a %dx%d source; expect well "
            "below realtime on 4K — the libav bridge is the supported "
            "4K path", fmt.width, fmt.height)
    if shutil.which("ffmpeg"):
        return ffmpeg_decoder_factory(pipeline, video_index)
    if is_mpeg2:
        return mpeg2_decoder_factory(pipeline, video_index)
    if avlib_available():  # H.264/H.265: system libavcodec in-process
        return avlib_decoder_factory(pipeline, video_index)
    if cv2_available():  # OpenCV's bundled FFmpeg (BGR trip)
        return cv2_decoder_factory(pipeline, video_index)
    if _is_4k(fmt):
        pipeline.ctx.warn(
            "no libav bridge/ffmpeg for a %dx%d source; decoding 4K with "
            "the in-build engine (bit-exact, well below realtime)",
            fmt.width, fmt.height)
    if fmt.format == VideoStreamFormat.H264:
        return h264ref_decoder_factory(pipeline, video_index)
    if fmt.format == VideoStreamFormat.H265:
        return h265ref_decoder_factory(pipeline, video_index)
    raise RuntimeError(
        f"no decoder available for {fmt.format.name} video "
        "(no ffmpeg binary, libav bridge, or cv2; the in-build decoders "
        "handle MPEG2, H.264 and HEVC)")


def avlib_available() -> bool:
    from ..video.avdec import avdec_available

    return avdec_available()


def avlib_decoder_factory(pipeline, video_index: int):
    """Decode the intermediate with the in-process FFmpeg bridge
    (native/avdec.cpp): exact YUV planes, any libavcodec codec."""
    from ..video.avdec import decode_file_av

    path = pipeline.settings.int_video_file_path(video_index)
    return decode_file_av(path)


def mpeg2_decoder_factory(pipeline, video_index: int):
    """Decode the PS intermediate with the in-build MPEG-2 decoder: as
    consecutive key-frame segments on worker threads where the file's
    frames prove it safe (mpeg2_segment_plan), else as one stream."""
    path = pipeline.settings.int_video_file_path(video_index)
    reform = getattr(pipeline, "_reform", None)
    segments = None
    if reform is not None:
        segments = mpeg2_segment_plan(
            path, reform.get_filter_source_frames(video_index),
            pipeline.settings.conf.device_batch_frames)
    return decode_mpeg2_segments(path, segments, trace=pipeline.ctx.trace)


def h264ref_decoder_factory(pipeline, video_index: int):
    """Decode the PS intermediate with the in-build H.264 decoder:
    the native C++ engine (native/h264dec.cpp) when the library is
    built, else the pure-Python oracle (video/h264_ref.py) — both
    bit-exact vs libavcodec (tests/test_h264_decode.py,
    test_h264_native.py)."""
    path = pipeline.settings.int_video_file_path(video_index)
    return decode_h264_ps_file(path)


def _open_h264_inbuild(es_head: bytes = b""):
    """Native engine when available (progressive, interlaced MBAFF AND
    PAFF field pictures), else the pure-Python oracle."""
    del es_head  # sniffing no longer needed: the C++ engine covers PAFF
    try:
        from ..video.native import NativeH264Decoder, h264_native_available

        if h264_native_available():
            return NativeH264Decoder()
    except Exception:
        pass
    from ..video.h264_ref import H264RefDecoder

    return H264RefDecoder()


def decode_h264_ps_file(path: str, is_ps: bool = True):
    """Stream (Y, U, V) frames from a PS/Annex-B file through the
    in-build H.264 decoder, feeding whole NALs per block, cropped to the
    frame cropping rectangle of the file's first SPS."""
    crop = []

    def open_decoder(es_head: bytes):
        crop.append(h264_crop(es_head))
        return _open_h264_inbuild(es_head)

    for planes in _decode_annexb_ps_file(path, open_decoder, is_ps):
        yield crop_planes(planes, crop[0]) if crop[0] else planes


def h264_crop(es: bytes):
    """(top, bottom, left, right) luma samples that the first SPS in an
    Annex B head crops (7.4.2.1.1: CropUnitX/Y from the chroma format and
    frame_mbs_only_flag), or None when it crops nothing or has no SPS."""
    from ..video.h264_ref import ebsp_to_rbsp, parse_sps, split_annexb

    for nal in split_annexb(es):
        if nal and nal[0] & 0x1F == 7:
            sps = parse_sps(ebsp_to_rbsp(nal[1:]))
            if not any(sps.crop):
                return None
            sub_w, sub_h = {1: (2, 2), 2: (2, 1)}.get(sps.chroma_format_idc,
                                                      (1, 1))
            uy = sub_h * (2 - sps.frame_mbs_only)
            left, right, top, bottom = sps.crop
            return top * uy, bottom * uy, left * sub_w, right * sub_w
    return None


def crop_planes(planes, crop):
    """Views of (Y, U, V) without `crop`'s (top, bottom, left, right) luma
    samples; the chroma planes lose as many at their own scale."""
    top, bottom, left, right = crop
    y = planes[0]
    out = [y[top:y.shape[0] - bottom, left:y.shape[1] - right]]
    for c in planes[1:]:
        sy, sx = y.shape[0] // c.shape[0], y.shape[1] // c.shape[1]
        out.append(c[top // sy:c.shape[0] - bottom // sy,
                     left // sx:c.shape[1] - right // sx])
    return tuple(out)


def h265ref_decoder_factory(pipeline, video_index: int):
    """Decode the PS intermediate with the in-build HEVC decoder
    (video/h265_ref.py, bit-exact vs libavcodec in
    tests/test_h265_decode.py). Beyond reference parity: the upstream
    decodes HEVC only through FFmpeg (ReaderWriterFFmpeg.hpp:355)."""
    path = pipeline.settings.int_video_file_path(video_index)
    return decode_h265_ps_file(path)


def _open_h265_inbuild(es_head: bytes = b""):
    """Native engine (native/h265dec.cpp) when the library is built,
    else the pure-Python oracle — both bit-exact vs libavcodec
    (tests/test_h265_decode.py, test_h265_native.py)."""
    del es_head
    try:
        from ..video.native import NativeH265Decoder, h265_native_available

        if h265_native_available():
            return NativeH265Decoder()
    except Exception:
        pass
    from ..video.h265_ref import H265RefDecoder

    return H265RefDecoder()


def decode_h265_ps_file(path: str, is_ps: bool = True):
    """Stream (Y, U, V) frames from a PS/Annex-B file through the
    in-build HEVC decoder, feeding whole NALs per block."""
    return _decode_annexb_ps_file(path, _open_h265_inbuild, is_ps)


def _decode_annexb_ps_file(path: str, open_decoder, is_ps: bool):
    from ..ts.qp_extract import extract_ps_video_es

    dec = None
    ps_pend = b""
    pend = b""
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            if is_ps:
                ps_pend += block
                es, used = extract_ps_video_es(ps_pend, return_consumed=True)
                ps_pend = ps_pend[used:]
            else:
                es = block
            pend += es
            if dec is None:
                dec = open_decoder(pend)
            # feed up to the last complete NAL (keep the open tail)
            cut = pend.rfind(b"\x00\x00\x01")
            if cut > 0:
                for fr in dec.decode(pend[:cut]):
                    yield fr[0], fr[1], fr[2]
                pend = pend[cut:]
    if is_ps and ps_pend:
        pend += extract_ps_video_es(ps_pend)
    if dec is None:
        dec = open_decoder(pend)
    for fr in dec.decode(pend) + dec.flush():
        yield fr[0], fr[1], fr[2]


def cv2_available() -> bool:
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        return False


def cv2_decoder_factory(pipeline, video_index: int):
    """Decode the intermediate with OpenCV's bundled FFmpeg (in-process;
    no external binary). Used for codecs the in-build decoder doesn't
    cover (H.264/H.265 TS sources)."""
    path = pipeline.settings.int_video_file_path(video_index)
    return decode_file_cv2(path)


def decode_file_cv2(path: str):
    """(Y, U, V) frames via cv2.VideoCapture. cv2 only exposes BGR
    output for coded video, so planes go through one BGR round-trip
    (lossless luma is NOT guaranteed — ±2 conversion noise)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 cannot open {path}")
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            h, w = bgr.shape[:2]
            i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
            y = i420[:h]
            u = i420[h:h + h // 4].reshape(h // 2, w // 2)
            v = i420[h + h // 4:].reshape(h // 2, w // 2)
            yield y, u, v
    finally:
        cap.release()


def decode_mpeg2_ps_file(path: str, is_ps: bool = True):
    """Stream (Y, U, V) frames from an MPEG2 PS/ES file using the native
    engine (pure-Python oracle as fallback)."""
    from ..ts.qp_extract import iter_picture_chunks_file
    from ..video import Mpeg2RefDecoder

    try:
        from ..video.native import NativeMpeg2Decoder

        dec = NativeMpeg2Decoder()
    except RuntimeError:
        dec = Mpeg2RefDecoder()
    for chunk in iter_picture_chunks_file(path, is_ps=is_ps):
        for fr in dec.decode_picture(chunk):
            yield fr.y, fr.u, fr.v
    for fr in dec.flush():
        yield fr.y, fr.u, fr.v


# -- the MPEG-2 decode in key-frame segments ---------------------------------
#
# The native engine parallelises only across the slices of one picture, so
# the in-build factory also decodes stretches of the stream that start at
# key frames on worker threads. Every segmented decode of the process takes
# its workers and the frames it holds out of one budget (_BUDGET), so that
# pipelines that decode at once share the host's cores and memory.

def _leading_frames(path: str, is_ps: bool):
    """The frames that the file's first picture displays after: the
    leading B pictures of its open GOP, which a join at that picture drops
    and the one-stream decode yields. None where the file does not open
    with an I picture after a sequence header."""
    from ..ts.qp_extract import iter_picture_chunks_file

    chunks = iter_picture_chunks_file(path, is_ps, read_chunk=1 << 20)
    try:
        first = next(chunks, b"")
        hdr = _picture_header(first)
        if hdr is None or hdr[1] != 1 or not (
                0 <= first.find(b"\x00\x00\x01\xb3")
                < first.find(b"\x00\x00\x01\x00")):
            return None
        i_temporal = hdr[0]
        lead = set()
        for chunk in chunks:  # as mpeg2_ps_seek_opener's join skips them
            hdr = _picture_header(chunk)
            if hdr is None or (hdr[0] == i_temporal and hdr[1] != 3):
                continue  # no picture; the I frame's second field
            if hdr[1] != 3 or hdr[0] >= i_temporal:
                break
            lead.add(hdr[0])  # a field pair shares its temporal_reference
        return len(lead)
    finally:
        chunks.close()


def mpeg2_segment_plan(path: str, frames_meta, min_frames: int,
                       is_ps: bool = True):
    """[(file offset, frames)] of the segments of a segmented decode, in
    order, that together yield the one-stream decode's frames, or None
    where the file cannot be proven to decode the same that way.

    Proven means: the native engine is there; the file opens with an I
    picture after a sequence header, so it opens with its first key frame
    and the frames it displays before it are that picture's leading B
    pictures (`_leading_frames`: L of them, which the one-stream decode
    yields and the reform drops); and the filter source frames step
    through the coded frames in display order one at a time (each
    `frame_index` the one before it or the next: a frame repeated by its
    repeat_first_field flag appears more than once, none is left out). So
    filter frame j is decoded frame L + frame_index[j] - frame_index[0]
    (frame_index counts over every video file: a second file's starts
    after the first's). A decode that joins the stream at
    key frame k (mpeg2_ps_seek_opener) yields the one-stream decode's
    frames from k's on; the leading B pictures of k's GOP belong to the
    segment before. Segments are cut at the first key frame at least
    `min_frames` decoded frames after the previous cut, as long as
    `min_frames` remain; a long file has more of them, each as long. The
    first segment decodes from the file's start, the last to its end.
    None where that gives fewer than two."""
    if not frames_meta:
        return None
    f0 = frames_meta[0].frame_index
    if any(not 0 <= b.frame_index - a.frame_index <= 1
           for a, b in zip(frames_meta, frames_meta[1:])):
        return None
    total = frames_meta[-1].frame_index - f0 + 1
    min_frames = max(1, min_frames)
    if total < 2 * min_frames:
        return None
    try:
        from ..video.native import native_available

        lead = _leading_frames(path, is_ps) if native_available() else None
    except (OSError, RuntimeError):
        return None
    if lead is None:
        return None
    cuts = [(0, 0)]  # (decoded frame, file offset)
    for j, m in enumerate(frames_meta):
        d = lead + m.frame_index - f0
        if (m.key_frame == j and d - cuts[-1][0] >= min_frames
                and lead + total - d >= min_frames
                and m.file_offset > cuts[-1][1]):
            cuts.append((d, m.file_offset))
    if len(cuts) < 2:
        return None
    ends = [d for d, _ in cuts[1:]] + [lead + total]
    return [(off, end - d) for (d, off), end in zip(cuts, ends)]


def _slice_threads() -> int:
    """The threads each native MPEG-2 decoder starts per picture, read as
    native/mpeg2dec.cpp reads them: AMATSUKAZE_DECODE_THREADS, else the
    hardware's concurrency."""
    env = os.environ.get("AMATSUKAZE_DECODE_THREADS", "")
    if env:
        lead = re.match(r"\s*[+-]?\d+", env)  # what atoi reads
        return max(1, int(lead.group()) if lead else 0)
    return max(1, os.cpu_count() or 1)


def decode_worker_budget() -> int:
    """How many segment workers the whole process may run at once: two
    decoders' slice threads for each core it may run on. On an 8-core H100
    host at 4 slice threads, 4 workers decoded the benchmark's recordings
    faster than 2 or 3 (PERF.md, section 6); no other slice-thread count
    was measured."""
    return max(1, 2 * len(os.sched_getaffinity(0)) // _slice_threads())


# The decoded frames that the segmented decodes of the process hold at
# most: 600 MB at 1440x1080 4:2:0, enough for 4 workers on segments of 45
# frames (a sequence header every 15 frames, a batch of 32).
_HELD_FRAMES = 256


class _DecodeBudget:
    """The segment workers running in the process and the frames their
    decodes hold, against decode_worker_budget() and _HELD_FRAMES."""

    def __init__(self):
        self._lock = threading.Lock()
        self.workers = 0
        self.frames = 0

    def take(self, segments: int, longest: int):
        """(workers, frames) for a decode of `segments` segments of at
        most `longest` frames: as many workers as both budgets leave, at
        most one a segment, or (0, 0) where that is fewer than two. A
        decode of W workers holds at most (W + 1) x `longest` frames."""
        with self._lock:
            n = min(segments, decode_worker_budget() - self.workers,
                    (_HELD_FRAMES - self.frames) // max(1, longest) - 1)
            if n < 2:
                return 0, 0
            held = (n + 1) * longest
            self.workers += n
            self.frames += held
            return n, held

    def give(self, workers: int, frames: int) -> None:
        with self._lock:
            self.workers -= workers
            self.frames -= frames


_BUDGET = _DecodeBudget()


def decode_mpeg2_segments(path: str, segments, is_ps: bool = True,
                          trace=None):
    """Stream (Y, U, V) frames of an MPEG-2 PS/ES file in display order,
    exactly as decode_mpeg2_ps_file yields them, decoding the `segments`
    that mpeg2_segment_plan gives on worker threads.

    W workers, as many as the process's budget leaves (_BUDGET), at most
    one a segment. Each decodes one segment into a list with its own
    NativeMpeg2Decoder: the first with decode_mpeg2_ps_file, the others
    from their key frame with mpeg2_ps_seek_opener. The segments are handed
    out in order, at most W at a time beyond the one being yielded, so the
    frames held are at most (W + 1) x the longest segment, L: 225 frames
    for W = 4 and L = 45 (a sequence header every 15 frames, a batch of
    32). Closing the generator stops the running segments at their next
    frame, cancels the others and waits for the workers; a worker's
    exception re-raises here. A segment that gives fewer frames than its
    plan (a stream that does not join as the plan proved) stops the
    workers, and one stream decodes the rest.

    With no plan or fewer than two workers free it is decode_mpeg2_ps_file.
    `trace` (utils/perf.py), when given, counts `decode.segments` and
    `decode.segment_frames` (the segments the workers decoded and the
    frames they gave) and `decode.serial_files` (a file decoded as one
    stream, or finished as one)."""
    workers, held = (_BUDGET.take(len(segments), max(n for _, n in segments))
                     if segments else (0, 0))
    if not workers:
        if trace is not None:
            trace.add("decode.serial_files", 1)
        yield from decode_mpeg2_ps_file(path, is_ps)
        return
    opener = mpeg2_ps_seek_opener(path, is_ps, read_chunk=1 << 20)
    stop = threading.Event()

    def decode(s: int) -> list:
        offset, want = segments[s]
        last = s == len(segments) - 1
        frames = (opener(0, offset) if s else
                  decode_mpeg2_ps_file(path, is_ps))
        out = []
        try:
            for planes in frames:
                if stop.is_set():
                    break
                out.append(planes)
                if len(out) == want and not last:
                    break
        finally:
            frames.close()
        return out

    pool = ThreadPoolExecutor(workers, thread_name_prefix="mpeg2-segment")
    pending = collections.deque(pool.submit(decode, s)
                                for s in range(workers))
    yielded = done = 0
    short = False
    try:
        for s, (_, want) in enumerate(segments):
            frames = pending.popleft().result()
            if s + workers < len(segments):
                pending.append(pool.submit(decode, s + workers))
            if len(frames) < want:  # the stream ended before the plan
                short = True
                break
            done += 1
            for planes in frames:
                yielded += 1
                yield planes
    finally:
        stop.set()
        pool.shutdown(wait=True, cancel_futures=True)
        _BUDGET.give(workers, held)
        if trace is not None:
            trace.add("decode.segments", done)
            trace.add("decode.segment_frames", yielded)
    if short:
        if trace is not None:
            trace.add("decode.serial_files", 1)
        for j, planes in enumerate(decode_mpeg2_ps_file(path, is_ps)):
            if j >= yielded:
                yield planes


def annexb_ps_seek_opener(path: str, fmt, is_ps: bool = True):
    """Byte-seek opener for CachedFrameSource over an H.264/HEVC PS/ES
    intermediate (the AMTSource byte-seek path for the AVC/HEVC codecs;
    the MPEG2 twin is mpeg2_ps_seek_opener below). Decoding joins the
    stream at the keyframe offset: H.264 restarts cleanly at an IDR
    (broadcast AVC uses periodic IDR); HEVC restarts at any IRAP — the
    decoders drop RASL leading pictures on a CRA join (8.1.3), so the
    first output is the keyframe itself. Returns None when the keyframe
    at offset 0 is not a clean join point (open-GOP H.264 recovery
    points), letting the caller fall back to forward decode."""
    from ..ts.qp_extract import extract_ps_video_es
    from ..types import VideoStreamFormat

    is_hevc = fmt == VideoStreamFormat.H265

    def _first_vcl_ok(es_head: bytes) -> bool:
        pos = 0
        for _ in range(64):
            i = es_head.find(b"\x00\x00\x01", pos)
            if i < 0 or i + 4 > len(es_head):
                return False
            b0 = es_head[i + 3]
            if is_hevc:
                t = (b0 >> 1) & 0x3F
                if t < 32:  # first VCL NAL must be an IRAP
                    return 16 <= t <= 21
            else:
                t = b0 & 0x1F
                if t in (1, 5):  # first coded slice must be IDR
                    return t == 5
            pos = i + 3
        return False

    def open_decoder(es_head: bytes):
        """The decoder and the H.264 SPS crop (see decode_h264_ps_file)."""
        if is_hevc:
            return _open_h265_inbuild(es_head), None
        return _open_h264_inbuild(es_head), h264_crop(es_head)

    def out(fr, crop):
        return crop_planes(fr[:3], crop) if crop else (fr[0], fr[1], fr[2])

    def opener(key_index: int, file_offset: int):
        del key_index  # outputs start at the keyframe by construction
        dec = crop = None
        ps_pend = b""
        pend = b""
        checked = False
        with open(path, "rb") as f:
            f.seek(file_offset)
            while True:
                block = f.read(1 << 20)
                if not block:
                    break
                if is_ps:
                    ps_pend += block
                    es, used = extract_ps_video_es(ps_pend,
                                                   return_consumed=True)
                    ps_pend = ps_pend[used:]
                else:
                    es = block
                pend += es
                if not checked and len(pend) >= 4096:
                    if not _first_vcl_ok(pend):
                        raise FormatSeekError("not a clean join point")
                    checked = True
                if dec is None and checked:
                    dec, crop = open_decoder(pend)
                cut = pend.rfind(b"\x00\x00\x01")
                if dec is not None and cut > 0:
                    for fr in dec.decode(pend[:cut]):
                        yield out(fr, crop)
                    pend = pend[cut:]
        if is_ps and ps_pend:
            pend += extract_ps_video_es(ps_pend)
        if not checked and not _first_vcl_ok(pend):
            raise FormatSeekError("not a clean join point")
        if dec is None:
            dec, crop = open_decoder(pend)
        for fr in dec.decode(pend) + dec.flush():
            yield out(fr, crop)

    return opener


class FormatSeekError(RuntimeError):
    """The keyframe at the seek offset is not a clean decode join."""


def _picture_header(chunk: bytes):
    """(temporal_reference, coding_type) from a per-picture chunk, or
    None. ISO 13818-2 6.2.3: 10-bit temporal_reference then 3-bit
    picture_coding_type right after the 00 00 01 00 start code."""
    i = chunk.find(b"\x00\x00\x01\x00")
    if i < 0 or i + 6 > len(chunk):
        return None
    b0, b1 = chunk[i + 4], chunk[i + 5]
    return (b0 << 2) | (b1 >> 6), (b1 >> 3) & 7


def mpeg2_ps_seek_opener(path: str, is_ps: bool = True,
                         read_chunk: int = 8 << 20):
    """Byte-seek opener for CachedFrameSource over an MPEG2 PS/ES
    intermediate: `opener(key_index, file_offset)` decodes from the
    keyframe at `file_offset` and yields display-order frames starting
    at filter index `key_index` (ref AMTSource.hpp:736-773 byte-seek +
    skip-until-keyframe; the leading B pictures of an open GOP reference
    the previous GOP and are dropped, matching isFrameReady's
    keyFramePTS gate at :600-612). The file is read `read_chunk` bytes
    at a time."""
    from ..ts.qp_extract import iter_picture_chunks_file
    from ..video import Mpeg2RefDecoder

    def opener(key_index: int, file_offset: int):
        try:
            from ..video.native import NativeMpeg2Decoder

            dec = NativeMpeg2Decoder()
        except RuntimeError:
            dec = Mpeg2RefDecoder()
        i_seen = False
        i_temporal = 0
        skipping_lead_b = False
        for chunk in iter_picture_chunks_file(path, is_ps=is_ps,
                                              read_chunk=read_chunk,
                                              start_offset=file_offset):
            hdr = _picture_header(chunk)
            if hdr is None:
                continue
            temporal, ctype = hdr
            if not i_seen:
                if ctype != 1:  # wait for the seek target's I picture
                    continue
                i_seen = True
                i_temporal = temporal
                skipping_lead_b = True
            elif skipping_lead_b:
                # open-GOP leading B pictures display before the I and
                # reference the previous (unavailable) GOP
                if ctype == 3 and temporal < i_temporal:
                    continue
                # a field-coded I frame's second field comes before them
                skipping_lead_b = temporal == i_temporal and ctype != 3
            for fr in dec.decode_picture(chunk):
                yield fr.y, fr.u, fr.v
        for fr in dec.flush():
            yield fr.y, fr.u, fr.v

    return opener


def ffmpeg_decoder_factory(pipeline, video_index: int):
    """Decode the intermediate ES with an external ffmpeg as yuv420p."""
    st = pipeline.settings
    path = st.int_video_file_path(video_index)
    fmt = pipeline_format(pipeline, video_index)
    w, h = fmt.width, fmt.height
    cmd = [
        "ffmpeg", "-v", "error", "-i", path,
        "-f", "rawvideo", "-pix_fmt", "yuv420p", "-",
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    ysize, csize = w * h, (w // 2) * (h // 2)
    try:
        while True:
            raw = proc.stdout.read(ysize + 2 * csize)
            if len(raw) < ysize + 2 * csize:
                break
            y = np.frombuffer(raw, np.uint8, ysize).reshape(h, w)
            u = np.frombuffer(raw, np.uint8, csize, ysize).reshape(h // 2, w // 2)
            v = np.frombuffer(raw, np.uint8, csize, ysize + csize).reshape(
                h // 2, w // 2
            )
            yield y, u, v
    finally:
        proc.stdout.close()
        proc.wait()


def pipeline_format(pipeline, video_index: int):
    reform = getattr(pipeline, "_reform", None)
    if reform is not None:
        return reform.formats[reform.format_start_index[video_index]].video_format
    raise RuntimeError("pipeline has no reform info yet")


class NullDecoderFactory:
    """Synthesises deterministic frames (for tests / decoderless runs)."""

    def __init__(self, level: int = 128):
        self.level = level

    def __call__(self, pipeline, video_index: int):
        reform = pipeline._reform
        fmt = reform.formats[
            reform.format_start_index[video_index]
        ].video_format
        n = len(reform.get_filter_source_frames(video_index))
        w, h = fmt.width or 64, fmt.height or 48
        y = np.full((h, w), self.level, np.uint8)
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.full((h // 2, w // 2), 128, np.uint8)
        for i in range(n):
            yield y, u, v


def ffmpeg_generic_decoder(src_path: str):
    """Generic-mode decoder: probe + decode any container via ffmpeg
    (ref AMTSimpleVideoEncoder's FFmpeg input, Encoder.hpp:266-476).

    Returns (VideoFormat, frame iterator of (Y, U, V), audio track files).
    """
    import json as _json
    import subprocess
    import tempfile

    from ..types import VideoFormat

    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-print_format", "json", "-show_streams",
         src_path],
        capture_output=True, text=True, check=True,
    )
    streams = _json.loads(probe.stdout)["streams"]
    vstreams = [s for s in streams if s["codec_type"] == "video"]
    astreams = [s for s in streams if s["codec_type"] == "audio"]
    if not vstreams:
        raise RuntimeError("no video stream")
    vs = vstreams[0]
    num, den = (int(x) for x in vs["r_frame_rate"].split("/"))
    fmt = VideoFormat(width=int(vs["width"]), height=int(vs["height"]),
                      frame_rate_num=num, frame_rate_denom=den,
                      progressive=vs.get("field_order", "progressive")
                      == "progressive", fixed_frame_rate=True)
    w, h = fmt.width, fmt.height

    def frames():
        cmd = ["ffmpeg", "-v", "error", "-i", src_path, "-map", "0:v:0",
               "-f", "rawvideo", "-pix_fmt", "yuv420p", "-"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        fsize = w * h * 3 // 2
        while True:
            buf = proc.stdout.read(fsize)
            if len(buf) < fsize:
                break
            arr = np.frombuffer(buf, np.uint8)
            y = arr[: w * h].reshape(h, w)
            u = arr[w * h: w * h + w * h // 4].reshape(h // 2, w // 2)
            v = arr[w * h + w * h // 4:].reshape(h // 2, w // 2)
            yield y, u, v
        proc.wait()

    audio_files = []
    for i, _ in enumerate(astreams):
        path = tempfile.mktemp(suffix=f".a{i}.aac")
        subprocess.run(["ffmpeg", "-v", "error", "-y", "-i", src_path,
                        "-map", f"0:a:{i}", "-c", "copy", "-f", "adts", path],
                       check=True)
        audio_files.append(path)
    return fmt, frames(), audio_files


def iter_ts_video_es(path: str, read_chunk: int = 4 << 20):
    """Stream the first video program's elementary stream out of a TS
    file: PAT -> PMT -> video PID -> PES payload concatenation. A light
    standalone demux for decode-only consumers (logo scan wizard,
    generic mode) — the full pipeline keeps using AMTSplitter."""
    from ..ts.packet import TsPacketParser
    from ..ts.pes import PesParser
    from ..ts.psi import PAT, PMT, PsiParser

    state = {"pmt_pid": -1, "video_pid": -1, "stype": 0}
    chunks: list[bytes] = []

    class _Pat(PsiParser):
        def on_psi_section(self, clock, section):
            pat = PAT(section)
            if pat.parse() and pat.elems:
                for prog, pid in pat.elems:
                    if prog != 0:
                        state["pmt_pid"] = pid
                        break

    class _Pmt(PsiParser):
        def on_psi_section(self, clock, section):
            pmt = PMT(section)
            if pmt.check() and pmt.parse():
                for el in pmt.elems:
                    if el.stream_type in (0x01, 0x02):  # MPEG-1/2 video
                        state["video_pid"] = el.elementary_pid
                        state["stype"] = el.stream_type
                        return

    class _Pes(PesParser):
        def on_pes_packet(self, clock, pkt):
            chunks.append(bytes(pkt.data[pkt.payload_offset:]))

    pat, pmt, pes = _Pat(), _Pmt(), _Pes()

    class _Parser(TsPacketParser):
        def on_ts_packets(self, batch):
            for pkt in batch:
                if not pkt.parse():
                    continue
                pid = pkt.pid
                if pid == 0:
                    pat.on_ts_packet(-1, pkt)
                elif pid == state["pmt_pid"]:
                    pmt.on_ts_packet(-1, pkt)
                elif pid == state["video_pid"] and pid >= 0:
                    pes.on_ts_packet(-1, pkt)

    parser = _Parser()
    with open(path, "rb") as f:
        while True:
            data = f.read(read_chunk)
            if not data:
                break
            parser.input_ts(data)
            if chunks:
                yield from chunks
                chunks.clear()
    parser.flush()
    pes.flush()
    yield from chunks


def decode_ts_video_file(path: str):
    """(Y, U, V) frames straight from a broadcast TS file using the
    in-build demux + MPEG-1/2 decoder (no external binary)."""
    from ..ts.qp_extract import iter_picture_chunks_stream
    from ..video import Mpeg2RefDecoder

    try:
        from ..video.native import NativeMpeg2Decoder

        dec = NativeMpeg2Decoder()
    except RuntimeError:
        dec = Mpeg2RefDecoder()
    for chunk in iter_picture_chunks_stream(iter_ts_video_es(path)):
        for fr in dec.decode_picture(chunk):
            yield fr.y, fr.u, fr.v
    for fr in dec.flush():
        yield fr.y, fr.u, fr.v


def inbuild_generic_decoder(src_path: str):
    """Standalone analog of ffmpeg_generic_decoder for MPEG TS/PS/ES
    sources: (VideoFormat, frame iterator, audio files=[]). Used when no
    ffmpeg binary exists (logo scan wizard, simple mode)."""
    with open(src_path, "rb") as f:
        head = f.read(4 << 20)

    if _looks_like_ts(head):
        first = b""
        for chunk in iter_ts_video_es(src_path):
            first += chunk
            if len(first) > (1 << 20):
                break
        fmt = _sniff_mpeg_format(first)

        def frames():
            yield from decode_ts_video_file(src_path)
    else:
        from ..ts.qp_extract import extract_ps_video_es

        es_head = extract_ps_video_es(head) or head
        fmt = _sniff_mpeg_format(es_head)

        def frames():
            yield from decode_mpeg2_ps_file(
                src_path, is_ps=b"\x00\x00\x01\xba" in head[:4096])
    return fmt, frames(), []


def _looks_like_ts(head: bytes) -> bool:
    n = 0
    for off in range(0, min(len(head), 188 * 8), 188):
        if head[off:off + 1] == b"\x47":
            n += 1
    return n >= 6


def _sniff_mpeg_format(es: bytes):
    """VideoFormat from the first sequence header in an MPEG-1/2 ES."""
    from ..types import VideoFormat, VideoStreamFormat

    i = es.find(b"\x00\x00\x01\xb3")
    if i < 0 or i + 8 > len(es):
        return VideoFormat(width=0, height=0)
    w = (es[i + 4] << 4) | (es[i + 5] >> 4)
    h = ((es[i + 5] & 0xF) << 8) | es[i + 6]
    frc = es[i + 7] & 0xF
    rates = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001),
             5: (30, 1), 6: (50, 1), 7: (60000, 1001), 8: (60, 1)}
    num, den = rates.get(frc, (30000, 1001))
    return VideoFormat(
        format=VideoStreamFormat.MPEG2,
        width=w, height=h, frame_rate_num=num, frame_rate_denom=den,
        progressive=False, fixed_frame_rate=True)


def avlib_generic_decoder(src_path: str):
    """Generic-mode decoder over the in-process libav bridge: any
    container/codec FFmpeg can open (the true analog of
    ffmpeg_generic_decoder, minus audio extraction)."""
    from ..types import VideoFormat, VideoStreamFormat
    from ..video.avdec import AvVideoDecoder

    dec = AvVideoDecoder(src_path)
    fmt = VideoFormat(
        format=VideoStreamFormat.H264 if dec.codec_id == 27 else
        VideoStreamFormat.MPEG2,
        width=dec.width, height=dec.height,
        frame_rate_num=dec.fps_num, frame_rate_denom=dec.fps_den,
        sar_width=dec.sar[0] or 1, sar_height=dec.sar[1] or 1,
        progressive=not dec.interlaced, fixed_frame_rate=True)
    return fmt, dec.frames(), []
