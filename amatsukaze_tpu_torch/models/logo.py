"""Logo frame matching (LogoFrame).

Counterpart of LogoFrameMatcher in amatsukaze_tpu/models/logo.py (ref
LogoScan.hpp:1521-1836): score every frame against every candidate logo
at a sweep of fade steps, select the logo by erase residual, smooth the
scores into logo on/off intervals and derive the per-frame erase fade.
The per-pixel scoring runs on the device through the logo_eval kernel;
the decisions are host-side numpy, unchanged from the JAX package.
LogoAnalyzer (logo generation) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import logo as ops
from ..ops import logo_eval
from ..ops.logo_ref import LogoEvalRef
from ..utils.batching import pad_tail
from ..utils.device import resolve_device
from .lgd import LogoData

THRESH = 0.2  # |score| below this = indeterminate (ref LogoScan.hpp:1536)


@dataclass
class LogoInterval:
    """One logo-on interval (a `S`/`E` pair in the logoframe file)."""

    s_best: int
    s_start: int
    s_end: int
    e_best: int
    e_start: int
    e_end: int


class LogoFrameMatcher:
    """Evaluate frames against candidate logos + emit on/off intervals
    (ref LogoFrame :1521-1836)."""

    def __init__(self, ctx, logos: list[LogoData], maskratio=0.1,
                 device=None):
        self.ctx = ctx
        self.logos = logos
        self.device = resolve_device(device)
        self.params = []
        for lg in logos:
            da = ops.batched_deint_logo(torch.from_numpy(lg.a_y)).numpy()
            db = ops.batched_deint_logo(torch.from_numpy(lg.b_y)).numpy()
            ref = LogoEvalRef(da, db, maskratio=maskratio)
            self.params.append(ops.LogoEvalParams.from_ref(ref, self.device))
        self.eval_results: np.ndarray | None = None  # [N, nlogos, F]
        self.num_frames = 0
        self.fps = 30
        self.best_logo = -1
        self.logo_ratio = 0.0

    def _deint_eval(self, params, window: np.ndarray,
                    fades: torch.Tensor) -> np.ndarray:
        """DeintY + EvaluateLogo: uint8 windows [B, H, W] x fades [F] ->
        [B, F]. The window crosses to the device as uint8 and widens there."""
        w = torch.from_numpy(np.ascontiguousarray(window)).to(self.device)
        d = ops.batched_deint_y(w.float())
        return logo_eval.evaluate_logo(params, d, 255.0, fades).cpu().numpy()

    def scan_frames(self, frames_iter, width, height, fps, batch=32,
                    fade_steps: int = 2):
        """frames_iter yields full Y planes (uint8). Evaluates every frame
        against every valid logo at `fade_steps` fade levels spanning [0, 1]
        (2 = the matcher's on/off pair; 11 = the reference's AMTAnalyzeLogo
        sweep used to derive per-frame erase fades)."""
        self.fps = int(round(fps))
        self.fade_steps = fade_steps
        fades = torch.from_numpy(
            np.linspace(0.0, 1.0, fade_steps).astype(np.float32)
        ).to(self.device)
        results = []
        pend = []

        def flush():
            if not pend:
                return
            # pad the tail to the steady batch shape: every launch then
            # runs at the one geometry the kernel is measured at
            batch_np, n_real = pad_tail(pend, batch)
            out = np.empty((n_real, len(self.logos), fade_steps), np.float32)
            for li, (lg, params) in enumerate(zip(self.logos, self.params)):
                h = lg.header
                if h.imgw != width or h.imgh != height:
                    out[:, li, :] = 0.0
                    out[:, li, -1] = -1.0
                    continue
                window = batch_np[:, h.imgy : h.imgy + h.h,
                                  h.imgx : h.imgx + h.w]
                out[:, li] = self._deint_eval(params, window, fades)[:n_real]
            results.append(out)
            pend.clear()

        for y in frames_iter:
            pend.append(y)
            if len(pend) >= batch:
                flush()
        flush()
        self.eval_results = (
            np.concatenate(results)
            if results
            else np.empty((0, len(self.logos), fade_steps), np.float32)
        )
        self.num_frames = len(self.eval_results)

    def select_logo(self, num_candidates: int = -1) -> int:
        """Pick the best logo by erase-residual score (ref :1647-1682)."""
        if num_candidates < 0:
            num_candidates = len(self.logos)
        r = self.eval_results[:, :num_candidates]
        detected = (r[:, :, 0] > THRESH) & (np.abs(r[:, :, -1]) < THRESH)
        num = detected.sum(axis=0)
        cost = np.where(detected, np.abs(r[:, :, -1]), 0.0).sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.where(
                num == 0, np.inf, (cost / num) * (self.num_frames / num)
            )
        self.best_logo = int(np.argmin(score))
        self.logo_ratio = float(num[self.best_logo]) / max(self.num_frames, 1)
        return self.best_logo

    def intervals(self, logo_index: int = -1) -> list[LogoInterval]:
        """Smooth the raw scores and extract on/off intervals
        (ref writeResult :1686-1827)."""
        if logo_index < 0:
            if self.best_logo < 0:
                self.select_logo()
            logo_index = self.best_logo

        thresh_l = 0.5
        avg_dur, median_dur = 1.0, 0.5
        half_avg = int(self.fps * avg_dur / 2 + 0.5)
        ave_frames = half_avg * 2 + 1
        half_med = int(self.fps * median_dur / 2 + 0.5)
        win = max(ave_frames, half_med * 2 + 1)
        half_win = win // 2
        n = self.num_frames

        r = self.eval_results[:, logo_index]
        raw = np.maximum(0.0, r[:, 0]) + np.minimum(0.0, r[:, -1])
        padded = np.concatenate(
            [np.full(half_win, raw[0] if n else 0.0), raw,
             np.full(win - half_win, raw[-1] if n else 0.0)]
        )
        off = half_win  # padded[off + i] == raw[i]

        result = np.empty(n, np.int32)
        score = np.empty(n, np.float32)
        for i in range(n):
            c = off + i
            before_max = padded[c - half_avg : c].max()
            after_max = padded[c + 1 : c + 1 + half_avg].max()
            minmax = min(before_max, after_max)
            mm_res = 1 if abs(minmax) < thresh_l else (0 if minmax < 0 else 2)
            avg = padded[c - half_avg : c + half_avg + 1].mean()
            avg_res = 1 if abs(avg) < THRESH else (0 if avg < 0 else 2)
            result[i] = 1 if mm_res != avg_res else mm_res
            score[i] = np.median(padded[c - half_med : c + half_med + 1])

        # fill indeterminate runs whose both sides agree (ref :1754-1767)
        i = 0
        while i < n:
            if result[i] != 1:
                i += 1
                continue
            j = i
            while j < n and result[j] == 1:
                j += 1
            prev_res = result[i - 1] if i > 0 else 0
            next_res = result[j] if j < n else 0
            if prev_res == next_res:
                result[i:j] = prev_res
            i = j

        # extract intervals with score-based refinement (ref :1770-1822)
        out: list[LogoInterval] = []
        it = 0
        while it < n:
            s_end_ = _find(result, it, n, lambda v: v == 2)
            e_end_ = _find(result, s_end_, n, lambda v: v == 0)
            s_end, e_end = s_end_, e_end_
            if s_end < n:
                if score[s_end] >= THRESH:
                    k = s_end
                    while k > it and score[k - 1] >= THRESH:
                        k -= 1
                    s_end = k
                else:
                    s_end = _find(score, s_end, n, lambda v: v >= THRESH)
            if e_end < n:
                if score[e_end] <= -THRESH:
                    k = e_end
                    while k > s_end and score[k - 1] <= -THRESH:
                        k -= 1
                    e_end = k
                else:
                    e_end = _find(score, e_end, n, lambda v: v <= -THRESH)
            s_start = s_end
            while s_start > it and not score[s_start - 1] <= -THRESH:
                s_start -= 1
            e_start = e_end
            while e_start > s_end and not score[e_start - 1] >= THRESH:
                e_start -= 1
            s_best = _find(score, s_start, s_end, lambda v: v > 0)
            e_best = e_end
            while e_best > e_start and not score[e_best - 1] > 0:
                e_best -= 1
            if s_end != e_end:
                out.append(
                    LogoInterval(
                        s_best=min(s_best, n - 1), s_start=s_start, s_end=s_end,
                        e_best=e_best - 1, e_start=e_start - 1, e_end=e_end - 1,
                    )
                )
            it = e_end_
            if e_end_ <= it - 1:
                break
        return out

    def fade_curve(self, logo_index: int = -1, window: int = 4) -> np.ndarray:
        """Per-frame erase fade in [0, 1]: the fade step whose erase residual
        is smallest, box-smoothed over +-window frames (the reference's
        CalcFade2, LogoScan.hpp:1263-1341, on the AMTAnalyzeLogo fade sweep).
        Needs scan_frames(fade_steps > 2) for meaningful intermediate fades."""
        if logo_index < 0:
            if self.best_logo < 0:
                self.select_logo()
            logo_index = self.best_logo
        r = self.eval_results[:, logo_index]  # [N, F]
        nf = r.shape[1]
        if len(r) == 0:
            return np.zeros(0, np.float32)
        fade = np.argmin(np.abs(r), axis=1).astype(np.float32) / max(nf - 1, 1)
        if window > 0 and len(fade) > 1:
            kernel = np.ones(2 * window + 1) / (2 * window + 1)
            fade = np.convolve(np.pad(fade, window, mode="edge"), kernel,
                               mode="valid")
        return np.clip(fade.astype(np.float32), 0.0, 1.0)

    def write_result(self, path: str, logo_index: int = -1) -> None:
        """logoframe file format consumed by join_logo_scp."""
        lines = []
        for iv in self.intervals(logo_index):
            lines.append(f"{iv.s_best:6d} S 0 ALL {iv.s_start:6d} {iv.s_end:6d}")
            lines.append(f"{iv.e_best:6d} E 0 ALL {iv.e_start:6d} {iv.e_end:6d}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))


def _find(arr, start, end, pred) -> int:
    for i in range(start, end):
        if pred(arr[i]):
            return i
    return end
