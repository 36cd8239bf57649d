"""Scene-change and silence detection (chapter_exe-class capability).

Counterpart of amatsukaze_tpu/ops/cm.py: per-frame scene metrics (mean
absolute difference to the previous frame, 32-bin normalised luma
histogram) and audio RMS windows on the device; the run-length and
threshold decisions on the host (numpy), unchanged from the JAX package.
Plain PyTorch: the reference computes these outside any Pallas kernel.

Exactness. The histogram counts are exact integers, and the normalised
histogram is count / total in float32 with the total a tensor (the card
divides by a Python scalar through its reciprocal), so it is bit-equal to
the JAX package's on every device. The frame difference is summed in
int64 and divided in float64 before the cast to float32, so it is the same
on the card and on the CPU (the JAX package sums in float32: within rtol
1e-5 of this).
"""

from __future__ import annotations

import numpy as np
import torch

BINS = 32
BIN_SHIFT = 3  # uint8 value >> 3 = JAX's clip(int(v / 8.0), 0, 31)


def scene_change_scores(frames: torch.Tensor) -> torch.Tensor:
    """Per-frame scene-change score against the previous frame: mean
    absolute difference, [B] float32; the first frame scores 0. frames:
    [B, H, W] luma (widened to float32)."""
    x = frames.float()
    d = (x[1:] - x[:-1]).abs().mean(dim=(-2, -1))
    return torch.cat([d.new_zeros(1), d])


def _binned_hist(frames: torch.Tensor, bins: int = BINS) -> torch.Tensor:
    """Normalised per-frame luma histograms [B, bins] float32: one
    bincount over frame * bins + bin for the whole batch."""
    b = frames.shape[0]
    if frames.dtype == torch.uint8 and bins == BINS:
        idx = (frames >> BIN_SHIFT).int()
    else:
        idx = (frames.float() / (256.0 / bins)).int().clamp(0, bins - 1)
    frame = torch.arange(b, dtype=torch.int32,
                         device=frames.device).view(b, 1, 1) * bins
    hist = torch.bincount((idx + frame).flatten(),
                          minlength=b * bins).view(b, bins).float()
    return hist / hist.sum(dim=-1, keepdim=True).clamp_min(1.0)


def histogram_correlation(frames: torch.Tensor,
                          bins: int = BINS) -> torch.Tensor:
    """Luma-histogram correlation with the previous frame [B] (first = 1),
    for bounded batches; a sequence streams through scene_metrics_batch and
    histogram_correlation_from_hists."""
    hist = _binned_hist(frames, bins)
    prev = torch.cat([hist[:1], hist[:-1]])
    num = (hist * prev).sum(-1)
    den = torch.sqrt((hist * hist).sum(-1) * (prev * prev).sum(-1))
    corr = num / den.clamp_min(1e-12)
    corr[0] = 1.0
    return corr


def scene_metrics_batch(frames_u8: torch.Tensor, prev_frame: torch.Tensor):
    """Streaming per-batch scene metrics with a carry across batches.

    frames_u8: [B, H, W] uint8 luma on the device; prev_frame: [H, W], the
    previous batch's last frame (the batch's own frame 0 for the first
    batch, so that its score is 0). Returns (diffs [B] float32, normalised
    histograms [B, 32] float32), still on the device."""
    cur = frames_u8.to(torch.int16)
    prev = torch.cat([prev_frame.to(torch.int16)[None], cur[:-1]])
    total = (cur - prev).abs().sum(dim=(-2, -1), dtype=torch.int64)
    n_px = torch.tensor(frames_u8.shape[-2] * frames_u8.shape[-1],
                        dtype=torch.float64, device=frames_u8.device)
    diffs = (total.double() / n_px).float()
    return diffs, _binned_hist(frames_u8, BINS)


def histogram_correlation_from_hists(hists) -> np.ndarray:
    """Host-side correlation over per-frame histograms [N, bins]."""
    h = np.asarray(hists, np.float32)
    prev = np.concatenate([h[:1], h[:-1]])
    num = (h * prev).sum(-1)
    den = np.sqrt((h * h).sum(-1) * (prev * prev).sum(-1))
    corr = num / np.maximum(den, 1e-12)
    if len(corr):
        corr[0] = 1.0
    return corr


def audio_rms_windows(pcm: torch.Tensor, window: int) -> torch.Tensor:
    """RMS per non-overlapping window of interleaved/mono samples.
    pcm: [N] float32, N a multiple of `window`. Returns [N / window]."""
    x = pcm.reshape(-1, window)
    return torch.sqrt((x * x).mean(dim=-1))


def detect_silence(rms, threshold: float,
                   min_windows: int) -> list[tuple[int, int]]:
    """Host-side run-length pass: silent spans [start, end) in window units
    lasting at least min_windows."""
    quiet = np.asarray(rms) < threshold
    spans = []
    start = None
    for i, q in enumerate(quiet):
        if q and start is None:
            start = i
        elif not q and start is not None:
            if i - start >= min_windows:
                spans.append((start, i))
            start = None
    if start is not None and len(quiet) - start >= min_windows:
        spans.append((start, len(quiet)))
    return spans


def detect_scene_changes(scores, hist_corr, diff_threshold: float = 30.0,
                         corr_threshold: float = 0.85) -> list[int]:
    """Host-side cut decision: frames where the pixel difference is high
    AND the histogram correlation is low."""
    s = np.asarray(scores)
    c = np.asarray(hist_corr)
    return [int(i) for i in
            np.flatnonzero((s > diff_threshold) & (c < corr_threshold))]
