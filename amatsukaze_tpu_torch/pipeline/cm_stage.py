"""The CM analysis pass of one video file: scene metrics and logo scores
from one streaming pass over the decoded luma, silence from the PCM, the CM
decision and the JLS elements of the chapters.

Counterpart of the in-process path of TranscodePipeline._analyze_video_file
(amatsukaze_tpu/pipeline/transcode.py:383-616), _detect_silence (:691-720)
and _jls_elements (:793-805):

    cm = run_cm_analysis(ctx, open_frames, num_frames, fmt, logos,
                         pcm_s16=pcm)
    cm.result.trims, cm.result.cmzones, cm.jls_elements

The port's pipeline/transcode.py calls its two steps, scan_video_file and
decide, itself: between them come the external chapter_exe/join_logo_scp
tools, and its temp files carry the video index in their names.

Each batch of luma frames crosses to the device once, as uint8: the scene
metrics run on it (with the previous batch's last frame as the carry) and
the logo matcher slices its windows from the same tensor. Batch k's results
come down only after batch k+1's work is enqueued. The decisions are the
JAX package's host code (models/cm_analyze.py, jls_script.py, chapter.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..models.chapter import JlsElement, format_jls
from ..models.cm_analyze import (CMAnalyzer, CMAnalyzeResult,
                                 format_scene_changes_text, format_trim_avs)
from ..models.filter_graph import normalize_u8
from ..models.logo import LogoFrameMatcher
from ..ops import cm as cm_ops
from ..utils.batching import batched, pad_tail
from ..utils.device import resolve_device, to_device, to_host

# the reference's AMTAnalyzeLogo fade sweep, from which the erase fades come;
# without an erase the two end points are enough to pick the logo
FADE_STEPS = 11
FADE_STEPS_NO_DELOGO = 2
# silence: 10 ms windows of the interleaved stereo 48 kHz PCM whose RMS is
# under 1% of full scale, at least 0.3 s long (transcode.py:710-717)
PCM_RATE = 48000
SILENCE_THRESHOLD = 0.01
SILENCE_MIN_WINDOWS = 30
# the files written with `out_dir` (the reference's file contracts, named
# as its temp files are, without the video index)
FILES = dict(scpos="chapter_exe_o.txt", logo_frames="logof.txt",
             trim="trim.avs", div="div.txt", jls="jls.txt")


@dataclass
class CMStageResult:
    """What the CM pass of one video file found. scan_video_file fills
    the fields of the streaming pass; `result` and `jls_elements` are set
    by the decision that follows."""
    matcher: LogoFrameMatcher | None = None
    best_logo: int = -1  # -1 without logos
    fade: np.ndarray | None = None  # per-frame erase fade; None under no_delogo
    scene_changes: list = field(default_factory=list)
    silence: list = field(default_factory=list)  # [start, end) frame spans
    logo_spans: list | None = None  # logo-on [start, end) frame spans
    # trims, divs, cmzones, scene_changes, logopath
    result: CMAnalyzeResult | None = None
    jls_elements: list = field(default_factory=list)
    num_frames: int = 0  # frames the pass saw
    logo_ratio: float = 0.0
    logo_path: str = ""  # the chosen logo's name in the CM result
    # scan_video_file's spans of ctx.trace: `cm.pass`, `cm.silence`
    pass_span: object = None
    silence_span: object = None


def luma_pass(ys, num_frames: int, batch: int, device,
              matcher: LogoFrameMatcher | None = None,
              scene_metrics: bool = True, trace=None):
    """One streaming pass over at most `num_frames` luma planes (uint8, or
    what normalize_u8 takes), in batches of `batch` (the tail padded to the
    steady shape). With scene metrics each batch crosses to the device
    whole, once; without, only the matcher's window region does. The
    matcher (begun by the caller, ended after this) scores the same device
    tensor. Returns (frames seen, diffs [N] float32, histograms [N, 32]
    float32); the two arrays are None without scene metrics. `trace`: the
    recording's (utils/perf.Trace), whose open span sums the pass's waits
    on `ys` (`input_wait_s`) and which counts the copies' bytes."""
    device = resolve_device(device)
    diffs, hists = [], []
    pending = None  # the previous batch's metrics, still on the device
    carry = None  # the previous batch's last frame, on the device
    count = 0

    def fetch():
        nonlocal pending
        if pending is not None:
            d, h, n_real = pending
            pending = None
            diffs.append(to_host(d[:n_real], trace))
            hists.append(to_host(h[:n_real], trace))

    def frames():
        nonlocal count
        it = iter(ys if trace is None else trace.waited(ys))
        while count < num_frames:
            y = next(it, None)
            if y is None:
                return
            count += 1
            yield normalize_u8(y)

    for chunk in batched(frames(), batch):
        arr, n_real = pad_tail(chunk, batch)
        if scene_metrics:
            luma, origin = to_device(arr, device, trace), (0, 0)
            d, h = cm_ops.scene_metrics_batch(
                luma, luma[0] if carry is None else carry)
            carry = luma[n_real - 1]
        else:
            luma, origin = matcher.upload_windows(arr)
        if matcher is not None:
            matcher.scan_batch(luma, n_real, origin)
        fetch()
        if scene_metrics:
            pending = (d, h, n_real)
    fetch()
    if not scene_metrics:
        return count, None, None
    if not diffs:
        return count, np.zeros(0, np.float32), np.zeros((0, cm_ops.BINS),
                                                        np.float32)
    return count, np.concatenate(diffs), np.concatenate(hists)


def detect_silence(pcm_s16, fps: float, device,
                   trace=None) -> list[tuple[int, int]]:
    """Silent spans in frames of interleaved stereo 48 kHz int16 PCM
    (transcode.py:691-720): RMS of 10 ms windows on the device, the
    run-length pass on the host, window units to frames by fps / 100."""
    if pcm_s16 is None or len(pcm_s16) == 0:
        return []
    pcm = np.asarray(pcm_s16, np.int16).astype(np.float32) / 32768.0
    window = PCM_RATE * 2 // 100
    usable = len(pcm) // window * window
    if usable == 0:
        return []
    rms = cm_ops.audio_rms_windows(
        to_device(pcm[:usable], resolve_device(device), trace), window)
    spans = cm_ops.detect_silence(to_host(rms, trace), SILENCE_THRESHOLD,
                                  SILENCE_MIN_WINDOWS)
    to_frames = fps / 100.0
    return [(int(s * to_frames), int(e * to_frames)) for s, e in spans]


def filter_source_pcm(reform, video_index: int, wave_path: str):
    """The wave file's PCM of one video file's filter-source audio frames
    (StreamReformInfo.get_filter_source_audio_frames), as interleaved
    int16, or None without audio (transcode.py:691-709)."""
    wave_frames = reform.get_filter_source_audio_frames(video_index)
    if not wave_frames or not os.path.exists(wave_path):
        return None
    chunks = []
    with open(wave_path, "rb") as f:
        for wf in wave_frames:
            if wf.wave_offset < 0 or wf.wave_length <= 0:
                continue
            f.seek(wf.wave_offset)
            chunks.append(f.read(wf.wave_length))
    if not chunks:
        return None
    return np.frombuffer(b"".join(chunks), np.int16)


def jls_elements(result: CMAnalyzeResult, num_frames: int,
                 fps: float) -> list[JlsElement]:
    """The spans between trims and divs, in whole seconds
    (transcode.py:793-805)."""
    bounds = sorted(set([0, num_frames] + result.trims + result.divs))
    return [JlsElement(a, b, int(round((b - a) / fps)))
            for a, b in zip(bounds, bounds[1:]) if b > a]


def cm_files(out_dir: str | None) -> dict:
    """The paths of the FILES in `out_dir` (none without one)."""
    if out_dir is None:
        return {}
    return {k: os.path.join(out_dir, v) for k, v in FILES.items()}


def _write(files: dict, name: str, text: str) -> None:
    if name in files:
        with open(files[name], "w") as f:
            f.write(text)


def scan_video_file(ctx, open_frames, num_frames: int, fmt, logos: list,
                    pcm_s16=None, no_delogo: bool = False, batch: int = 32,
                    device=None, files: dict | None = None,
                    logo_names: list | None = None) -> CMStageResult:
    """The streaming pass of the CM analysis (transcode.py:427-592): scene
    metrics and logo scores from one pass over at most `num_frames` luma
    planes, the logo choice and its fade curve, then the silence of
    `pcm_s16`. files: FILES names -> paths; the scene-change and logo-frame
    files are written where named. logo_names: what the result calls each
    logo (the JAX pipeline names the .lgd file); by default its header
    name. The pass up to the logo choice is the span `cm.pass` of
    ctx.trace, the silence `cm.silence` (the result keeps both)."""
    files = files or {}
    scan = CMStageResult()
    fps = fmt.frame_rate if fmt.frame_rate_num else 29.97
    trace = ctx.trace
    with trace.span("cm.pass", frames=num_frames) as scan.pass_span:
        _scan_luma(ctx, scan, open_frames, num_frames, fmt, fps, logos,
                   no_delogo, batch, device, files, logo_names)
    with trace.span("cm.silence") as scan.silence_span:
        scan.silence = detect_silence(pcm_s16, fps, device, trace)
    return scan


def _scan_luma(ctx, scan: CMStageResult, open_frames, num_frames: int, fmt,
               fps: float, logos: list, no_delogo: bool, batch: int, device,
               files: dict, logo_names) -> None:
    """scan_video_file's luma pass, scene changes and logo choice."""
    if logos:
        scan.matcher = LogoFrameMatcher(ctx, logos, device=device)
        # the 11-step fade sweep feeds both matching and the per-frame
        # erase fades (ref AMTAnalyzeLogo's NUM_FADE)
        scan.matcher.begin_scan(fmt.width, fmt.height, fps,
                                FADE_STEPS_NO_DELOGO if no_delogo
                                else FADE_STEPS)
    scan.num_frames, diffs, hists = luma_pass(
        (planes[0] for planes in open_frames()), num_frames, batch, device,
        scan.matcher, trace=ctx.trace)
    matcher = scan.matcher
    if matcher is not None:
        matcher.end_scan()
    if len(diffs):
        corr = cm_ops.histogram_correlation_from_hists(hists)
        scan.scene_changes = cm_ops.detect_scene_changes(diffs, corr)
        _write(files, "scpos",
               format_scene_changes_text(scan.scene_changes, []))
    if matcher is not None and scan.num_frames:
        best = scan.best_logo = matcher.select_logo()
        if "logo_frames" in files:
            matcher.write_result(files["logo_frames"])
        scan.logo_spans = [(iv.s_best, iv.e_best + 1)
                           for iv in matcher.intervals()]
        scan.logo_ratio = matcher.logo_ratio
        scan.logo_path = (logo_names[best] if logo_names is not None
                          else logos[best].header.name or f"logo{best}")
        if not no_delogo:
            scan.fade = matcher.fade_curve()


def decide(analyzer: CMAnalyzer, scan: CMStageResult,
           files: dict | None = None) -> CMAnalyzeResult:
    """The CM decision from what the pass found, and its trim and div
    files where `files` names them (transcode.py:603-611)."""
    files = files or {}
    result = analyzer.analyze(scan.logo_spans, scan.logo_ratio,
                              scan.logo_path, scan.scene_changes,
                              scan.silence)
    _write(files, "trim", format_trim_avs(result.trims) + "\n")
    _write(files, "div", "\n".join(str(d) for d in result.divs[:-1]) + "\n")
    return result


def run_cm_analysis(ctx, open_frames, num_frames: int, fmt, logos: list,
                    pcm_s16=None, jls_script=None, jls_options=None,
                    loose_logo_detection: bool = False,
                    no_delogo: bool = False, pid_changes=None,
                    pmt_cut_side_rate=(0, 0), batch: int = 32, device=None,
                    out_dir: str | None = None) -> CMStageResult:
    """CM analysis of one video file: scan_video_file, decide, the PMT cut
    and the JLS elements.

    open_frames() returns an iterator of (Y, U, V) planes; only Y is read.
    logos: candidate LogoData (may be empty); the result names the chosen
    one by its header name. pcm_s16: the file's audio, interleaved stereo
    48 kHz int16, or None. jls_script: a models.jls_script.JlsScript that
    drives the decision in place of JlsDecider. pid_changes: the frames
    where the PMT changed, for apply_pmt_cut when a pmt_cut_side_rate is
    > 0. With `out_dir`, the scene-change, logo-frame, trim, div and JLS
    files are written there (FILES)."""
    device = resolve_device(device)
    fps = fmt.frame_rate if fmt.frame_rate_num else 29.97
    files = cm_files(out_dir)
    analyzer = CMAnalyzer(ctx, num_frames, fps, jls_options=jls_options,
                          loose_logo_detection=loose_logo_detection,
                          jls_script=jls_script)
    cma = CMStageResult()
    if num_frames > 0:
        cma = scan_video_file(ctx, open_frames, num_frames, fmt, logos,
                              pcm_s16, no_delogo, batch, device, files)
    with ctx.trace.span("cm.decide"):
        decide(analyzer, cma, files)
        if any(r > 0 for r in pmt_cut_side_rate):
            analyzer.apply_pmt_cut(pmt_cut_side_rate,
                                   list(pid_changes or []))
        cma.result = analyzer.result
        cma.jls_elements = jls_elements(analyzer.result, num_frames, fps)
        _write(files, "jls", format_jls(cma.jls_elements))
    return cma
