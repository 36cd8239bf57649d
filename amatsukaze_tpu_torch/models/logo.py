"""Logo generation (LogoAnalyzer) and frame matching (LogoFrame).

Counterpart of amatsukaze_tpu/models/logo.py:

- generation: LogoAnalyzer's 3-pass flow (ref LogoScan.hpp:794-1080).
  Pass 1 keeps the frames whose scan-region border is one flat colour
  (AddFrame :594-659) and accumulates per-pixel (fg, bg) regression sums on
  the device; passes 2-3 score the kept frames at 20 fades with the
  logo_eval kernel (its uint8 entry, DeintY inside), keep those whose best
  fade is above 8/20 and solve again, with edge cleanup on the last pass.
- matching: LogoFrameMatcher (ref LogoScan.hpp:1521-1836): score every
  frame against every candidate logo at a sweep of fade steps, select the
  logo by erase residual, smooth the scores into logo on/off intervals and
  derive the per-frame erase fade.

The per-pixel math runs on the device; frame acceptance, the least-squares
solve and the decisions are host-side numpy, unchanged from the JAX
package. Its slow-link host twins (ops/logo_host.py) are not carried.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import logo as ops
from ..ops import logo_eval
from ..ops.logo_ref import LogoEvalRef, med_average
from ..utils.batching import batched, pad_tail
from ..utils.device import resolve_device, to_device, to_host
from .lgd import LogoData, LogoHeader, save_lgd

THRESH = 0.2  # |score| below this = indeterminate (ref LogoScan.hpp:1536)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _sums_update(frames: torch.Tensor, bgs: torch.Tensor) -> torch.Tensor:
    """One batch of per-pixel regression sums -> [5, H, W] float32, on the
    frames' device."""
    zero = torch.zeros((5, 1, 1), dtype=torch.float32, device=frames.device)
    return ops.logo_sums_update(zero, frames, bgs)


def border_flat_background(y, u, v, thy: int):
    """AddFrame's border flatness test (ref LogoScan.hpp:594-659).

    Returns (bgY, bgU, bgV) if the frame border is a single flat colour,
    else None. Border = the 1-pixel frame edge of each plane.
    """

    def border(p):
        return np.concatenate([p[0, :], p[-1, :], p[1:-1, 0], p[1:-1, -1]])

    by, bu, bv = border(y), border(u), border(v)
    for vals in (by, bu, bv):
        if int(vals.max()) - int(vals.min()) > thy:
            return None
    return (med_average(by.tolist()), med_average(bu.tolist()),
            med_average(bv.tolist()))


def _calc_dist(a, b):
    """Distance of an (A, B) pixel from identity (ref calcDist :430-432)."""
    return (1.0 / 3.0) * (a - 1) * (a - 1) + (a - 1) * b + b * b


def _maxfilter_3x3_plus(d):
    """Two-pass 3-neighbour max (horizontal then vertical), matching the
    reference maxfilter (:434-456) which overwrites work with the vertical
    pass over the original data."""
    w = d.copy()
    w[:, 1:-1] = np.maximum(np.maximum(d[:, :-2], d[:, 1:-1]), d[:, 2:])
    w[1:-1, :] = np.maximum(np.maximum(d[:-2, :], d[1:-1, :]), d[2:, :])
    return w


@dataclass
class ScanRegion:
    x: int
    y: int
    w: int
    h: int


class LogoScanAccumulator:
    """Per-pixel regression sums for Y/U/V (ref LogoScan class :398-659).

    Precision: the reference accumulates in double (LogoColor). Each batch
    of at most 256 frames is summed on the device in float32 (exact for
    8-bit data and integer background levels, ops.logo.logo_sums_update)
    and folded into float64 totals on the device, which are exact integers
    too; the solve runs on the host in float64, as the JAX package's.
    """

    MAX_EXACT_BATCH = 256

    def __init__(self, scanw, scanh, log_uv_x=1, log_uv_y=1, thy=12,
                 device=None):
        self.scanw, self.scanh = scanw, scanh
        self.log_uv_x, self.log_uv_y = log_uv_x, log_uv_y
        self.thy = thy
        self.device = resolve_device(device)
        self.nframes = 0
        wuv, huv = scanw >> log_uv_x, scanh >> log_uv_y
        self.sums = [torch.zeros((5,) + shape, dtype=torch.float64,
                                 device=self.device)
                     for shape in ((scanh, scanw), (huv, wuv), (huv, wuv))]

    def add_frames(self, ys, us, vs, bgs):
        """Accumulate a batch of accepted frames: ys/us/vs [N, h, w] (numpy
        or tensors of 8-bit values), bgs [(bgY, bgU, bgV)]."""
        bg = torch.as_tensor(np.asarray(bgs, np.float32)).to(self.device)
        planes = [torch.as_tensor(p).to(self.device) for p in (ys, us, vs)]
        for i in range(0, len(bgs), self.MAX_EXACT_BATCH):
            sl = slice(i, i + self.MAX_EXACT_BATCH)
            for c, (acc, p) in enumerate(zip(self.sums, planes)):
                acc += _sums_update(p[sl], bg[sl, c])
        self.nframes += len(bgs)

    @staticmethod
    def _solve_ab(sums: np.ndarray, n: int, maxv=255.0):
        """Vectorised GetAB in float64 (ref approxim_line/GetAB :336-396)."""
        s = sums.copy()
        s[0] /= maxv
        s[1] /= maxv
        s[2] /= maxv * maxv
        s[3] /= maxv * maxv
        s[4] /= maxv * maxv
        sum_f, sum_b, sum_f2, sum_b2, sum_fb = s
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = n * sum_f2 - sum_f * sum_f
            a1 = (n * sum_fb - sum_f * sum_b) / t1
            b1 = (sum_f2 * sum_b - sum_f * sum_fb) / t1
            t2 = n * sum_b2 - sum_b * sum_b
            a2 = (n * sum_fb - sum_b * sum_f) / t2
            b2 = (sum_b2 * sum_f - sum_b * sum_fb) / t2
            a = (a1 + 1.0 / a2) / 2.0
            b = (b1 + (-b2 / a2)) / 2.0
        a = a.astype(np.float32)
        b = b.astype(np.float32)
        valid = np.isfinite(a) & np.isfinite(b) & (a != 0)
        return np.array(a), np.array(b), valid

    def get_logo(self, header: LogoHeader, clean: bool) -> LogoData | None:
        """Solve per-pixel least squares; None if any pixel is degenerate
        (ref GetLogo :490-566). Raw 0..255 sums are normalised here, as
        Normalize(255)."""
        n = self.nframes
        if n < 2:
            return None
        sums = [t.cpu().numpy() for t in self.sums]
        ay, by, vy = self._solve_ab(sums[0], n)
        au, bu, vu = self._solve_ab(sums[1], n)
        av, bv, vv = self._solve_ab(sums[2], n)
        if not (vy.all() and vu.all() and vv.all()):
            return None

        if clean:
            # edge cleanup (ref :516-563): zero out pixels whose distance
            # from identity stays small after 3x max-filtering
            yy, xx = np.mgrid[0 : self.scanh, 0 : self.scanw]
            uvy, uvx = yy >> self.log_uv_y, xx >> self.log_uv_x
            dist = (
                _calc_dist(ay, by)
                + _calc_dist(au[uvy, uvx], bu[uvy, uvx])
                + _calc_dist(av[uvy, uvx], bv[uvy, uvx])
            ) * 1000.0
            for _ in range(3):
                dist = _maxfilter_3x3_plus(dist)
            weak = dist < 0.3
            ay[weak] = 1.0
            by[weak] = 0.0
            weak_uv = np.zeros_like(au, bool)
            weak_uv[uvy[weak], uvx[weak]] = True
            for p, q in ((au, bu), (av, bv)):
                p[weak_uv] = 1.0
                q[weak_uv] = 0.0

        return LogoData(
            header=header,
            a_y=ay.astype(np.float32), b_y=by.astype(np.float32),
            a_u=au.astype(np.float32), b_u=bu.astype(np.float32),
            a_v=av.astype(np.float32), b_v=bv.astype(np.float32),
        )


class LogoAnalyzer:
    """3-pass logo generation from a frame source (ref :794-1080)."""

    NUM_FADE = 20

    def __init__(self, ctx, region: ScanRegion, thy=12, num_max_frames=10000,
                 log_uv_x=1, log_uv_y=1, batch=64, progress_cb=None,
                 device=None):
        self.ctx = ctx
        self.region = region
        self.thy = thy
        self.num_max_frames = num_max_frames
        self.log_uv_x, self.log_uv_y = log_uv_x, log_uv_y
        self.batch = batch
        self.progress_cb = progress_cb or (lambda *a: True)
        self.device = resolve_device(device)
        # accepted frame store (replaces the UtVideo workfile): uint8 crops
        self.frames_y: list[np.ndarray] = []
        self.frames_u: list[np.ndarray] = []
        self.frames_v: list[np.ndarray] = []
        self.logodata: LogoData | None = None
        # per refinement pass: each kept frame's best fade step (0..19)
        self.min_fades: list[np.ndarray] = []

    def _header(self, imgw, imgh, name="No Name", service_id=-1):
        r = self.region
        return LogoHeader(r.w, r.h, self.log_uv_x, self.log_uv_y,
                          imgw, imgh, r.x, r.y, name, service_id)

    def _accumulator(self) -> LogoScanAccumulator:
        r = self.region
        return LogoScanAccumulator(r.w, r.h, self.log_uv_x, self.log_uv_y,
                                   self.thy, self.device)

    def scan(self, frame_iter, imgw, imgh, name="No Name",
             service_id=-1) -> LogoData:
        """frame_iter yields (Y, U, V) full planes (uint8 numpy). Each pass
        is a span of ctx.trace: `logo.scan`, `logo.refine` and
        `logo.refine_final`; each ends in a fetch from the device."""
        header = self._header(imgw, imgh, name, service_id)
        trace = self.ctx.trace
        with trace.span("logo.scan"):
            self._initial_pass(frame_iter, header)
        with trace.span("logo.refine"):
            self._remake(header, False)
        with trace.span("logo.refine_final"):
            self._remake(header, True)
        return self.logodata

    # -- pass 1 -------------------------------------------------------------
    def _initial_pass(self, frame_iter, header) -> None:
        r = self.region
        acc = self._accumulator()
        ys0, ys1 = r.y >> self.log_uv_y, (r.y + r.h) >> self.log_uv_y
        xs0, xs1 = r.x >> self.log_uv_x, (r.x + r.w) >> self.log_uv_x
        pend_bg = []
        for n, (y, u, v) in enumerate(frame_iter):
            if len(self.frames_y) >= self.num_max_frames:
                break
            sy = y[r.y : r.y + r.h, r.x : r.x + r.w]
            su = u[ys0:ys1, xs0:xs1]
            sv = v[ys0:ys1, xs0:xs1]
            bg = border_flat_background(sy, su, sv, self.thy)
            if bg is None:
                continue
            self.frames_y.append(sy.copy())
            self.frames_u.append(su.copy())
            self.frames_v.append(sv.copy())
            pend_bg.append(bg)
            if len(pend_bg) >= self.batch:
                self._add_last(acc, pend_bg)
                pend_bg = []
                if self.progress_cb("scan", len(self.frames_y), n + 1) is False:
                    break
        if pend_bg:
            self._add_last(acc, pend_bg)
        self.logodata = acc.get_logo(header, clean=False)
        if self.logodata is None:
            raise RuntimeError("insufficient logo frames")

    def _add_last(self, acc: LogoScanAccumulator, bgs: list) -> None:
        """Accumulate the last len(bgs) stored frames (uint8 up, widened on
        the device)."""
        k = len(bgs)
        acc.add_frames(*(np.stack(store[-k:]) for store in
                         (self.frames_y, self.frames_u, self.frames_v)), bgs)

    # -- passes 2-3 -----------------------------------------------------------
    def _remake(self, header, final: bool) -> None:
        self.progress_cb("refine-final" if final else "refine",
                         len(self.frames_y), len(self.frames_y))
        # deinterlace the current logo estimate + build the eval mask
        deint_a = ops.batched_deint_logo(
            torch.from_numpy(self.logodata.a_y)).numpy()
        deint_b = ops.batched_deint_logo(
            torch.from_numpy(self.logodata.b_y)).numpy()
        ref = LogoEvalRef(deint_a, deint_b, maskratio=0.1)
        params = ops.LogoEvalParams.from_ref(ref, self.device)
        fades = torch.from_numpy(
            np.arange(self.NUM_FADE, dtype=np.float32) * np.float32(0.1)
        ).to(self.device)

        # the kept uint8 crops, scored at every fade (DeintY inside the
        # kernel); the best fades come down once
        best = []
        for chunk in batched(self.frames_y, self.batch):
            window = torch.from_numpy(np.stack(chunk)).to(self.device)
            scores = logo_eval.evaluate_logo_u8(params, window, 255.0, fades)
            best.append(scores.abs().argmin(dim=1))
        min_fades = (torch.cat(best).cpu().numpy().astype(np.int32) if best
                     else np.zeros(0, np.int32))
        self.min_fades.append(min_fades)

        # re-accumulate with clearly-logo-on frames only (minFade > 8/20)
        acc = self._accumulator()
        sel = np.nonzero(min_fades > 8)[0]
        for i in range(0, len(sel), self.batch):
            idxs = sel[i : i + self.batch]
            bgs = []
            for j in idxs:
                bg = border_flat_background(
                    self.frames_y[j], self.frames_u[j], self.frames_v[j],
                    self.thy)
                bgs.append(bg if bg else (0, 128, 128))
            acc.add_frames(*(np.stack([store[j] for j in idxs]) for store in
                             (self.frames_y, self.frames_u, self.frames_v)),
                           bgs)
        new_logo = acc.get_logo(header, clean=final)
        if new_logo is None:
            raise RuntimeError("insufficient logo frames in refinement")
        self.logodata = new_logo

    def save(self, path: str) -> None:
        save_lgd(path, self.logodata)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------


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

    def begin_scan(self, width: int, height: int, fps,
                   fade_steps: int = 2) -> None:
        """Start a scan of frames of `width` x `height`, scored at
        `fade_steps` fade levels spanning [0, 1] (2 = the matcher's on/off
        pair; 11 = the reference's AMTAnalyzeLogo sweep used to derive
        per-frame erase fades). Feed batches to scan_batch, then call
        end_scan."""
        self.fps = int(round(fps))
        self.fade_steps = fade_steps
        self._size = (width, height)
        self._fades = to_device(
            np.linspace(0.0, 1.0, fade_steps).astype(np.float32),
            self.device, self.ctx.trace)
        self._results = []
        self._pending = None

    def _fits(self, logo: LogoData) -> bool:
        return (logo.header.imgw, logo.header.imgh) == self._size

    def window_region(self):
        """(y0, x0, y1, x1): the smallest box of the frame that holds the
        window of every logo made for the scanned frame size; None when no
        logo is."""
        boxes = [(h.imgy, h.imgx, h.imgy + h.h, h.imgx + h.w)
                 for h in (lg.header for lg in self.logos if self._fits(lg))]
        if not boxes:
            return None
        y0, x0, y1, x1 = zip(*boxes)
        return min(y0), min(x0), max(y1), max(x1)

    def upload_windows(self, batch_np: np.ndarray):
        """(uint8 tensor on the device, origin): the window_region of a
        host batch [B, H, W], the only bytes the scores need; (None, None)
        when no logo fits the frame."""
        region = self.window_region()
        if region is None:
            return None, None
        y0, x0, y1, x1 = region
        window = np.ascontiguousarray(batch_np[:, y0:y1, x0:x1])
        return to_device(window, self.device, self.ctx.trace), (y0, x0)

    def scan_batch(self, luma: torch.Tensor | None, n_real: int,
                   origin=(0, 0)) -> None:
        """Score one batch already on the device: luma [B, h, w] uint8, the
        region of the frames whose top-left corner is `origin` (the whole
        frame by default). Each logo's window is sliced on the device
        (logos that share a window share its slice); one logo_eval launch
        per logo. Only the first `n_real` frames are kept (a tail batch is
        padded to the steady shape). Batch k's scores come down after batch
        k+1's launches are enqueued; end_scan fetches the last."""
        scores = []
        windows = {}
        for lg, params in zip(self.logos, self.params):
            if not self._fits(lg):
                scores.append(None)
                continue
            h = lg.header
            box = (h.imgy, h.imgx, h.h, h.w)
            if box not in windows:
                y, x = h.imgy - origin[0], h.imgx - origin[1]
                windows[box] = luma[:, y : y + h.h, x : x + h.w].contiguous()
            scores.append(logo_eval.evaluate_logo_u8(params, windows[box],
                                                     255.0, self._fades))
        self._fetch_pending()
        self._pending = (scores, n_real)

    def _fetch_pending(self) -> None:
        if self._pending is None:
            return
        scores, n_real = self._pending
        self._pending = None
        out = np.empty((n_real, len(self.logos), self.fade_steps), np.float32)
        for li, s in enumerate(scores):
            if s is None:  # a logo for another frame size never matches
                out[:, li, :] = 0.0
                out[:, li, -1] = -1.0
            else:
                out[:, li] = to_host(s[:n_real], self.ctx.trace)
        self._results.append(out)

    def end_scan(self) -> None:
        self._fetch_pending()
        self.eval_results = (
            np.concatenate(self._results)
            if self._results
            else np.empty((0, len(self.logos), self.fade_steps), np.float32)
        )
        self.num_frames = len(self.eval_results)
        self._results = []

    def scan_frames(self, frames_iter, width, height, fps, batch=32,
                    fade_steps: int = 2):
        """frames_iter yields full Y planes (uint8). Evaluates every frame
        against every valid logo at `fade_steps` fade levels (begin_scan);
        per batch only the logos' windows cross to the device."""
        self.begin_scan(width, height, fps, fade_steps)
        for chunk in batched(frames_iter, batch):
            # pad the tail to the steady batch shape: every launch then
            # runs at the one geometry the kernel is measured at
            arr, n_real = pad_tail(chunk, batch)
            luma, origin = self.upload_windows(arr)
            self.scan_batch(luma, n_real, origin)
        self.end_scan()

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
