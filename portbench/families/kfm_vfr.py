"""The family `kfm_vfr`: the plain reference of a configuration that runs
Amatsukaze's KFM VFR profile, its compared numbers and the control that
breaks its guarantee. The harness finds this module by the configuration's
"family"; it imports nothing of the program and reads none of its
decisions.

- CM pass: the trims and CM zones are the layout's program and CM parts;
  the chosen logo is the logo file that holds the painted logo.
- Logo erase: Amatsukaze's Delogo (pb/delogo.py) on every source frame.
- The output file holds every frame of the recording (the program's
  default output: the CM zones go to the encoder as zones, nothing is
  cut).
- kfm_vfr: each 3:2 cycle of film gives its four film frames, each the
  coded frame that holds it in both fields, else the top field of the
  frame that starts it woven with the bottom field of the frame before
  (the 3:2 repair); a film frame lasts 5 ticks of the 120000/1001 clock.
  KFM's UCF may put in the place of any film frame the bob of the top
  field of its frame (each missing line the mean of the lines around it,
  rounded half up): the frame's woven fields comb in its own field-match
  costs, which the reference does not work out, so either is the frame.
  Interlaced video whose fields move by one pixel is woven as it is (KFM's
  30p: only where even the best field pairing combs does it bob to 60p),
  4 ticks a frame.

`dtype` sets the precision of the arithmetic (the control runs it in
bfloat16).

Numbers (the worst over the window's recordings):
  cm_wrong          recordings whose CM pass gave other trims, CM zones or
                    logo than the layout's (cells whose traffic gives logos)
  count_wrong       recordings whose encoder got another number of frames
  timecode_gap_ms   widest gap between a served timecode and the plan's
                    (kfm_vfr)
  outside_gap       widest gap between a sampled frame and the reference's
                    off the logo box (grown by the lines a bob reads)
  recordings_differ recordings whose encoder got frames other than the
                    first recording's, by their digests (every recording of
                    a window is the same TS, so this reaches the frames
                    outside the sample)
  box_fit_gap       mean gap over the logo box of a sampled frame at the
                    fades that explain it best (cells with a logo): the
                    erase's arithmetic, whatever fade the program estimated
  fade_flips        sampled fields whose best fade is off by more than one
                    half from the layout's, where that is 0 or 1 (the erase
                    left out, or done where there is no logo)
  samples_missing   sampled frames that the encoder did not get
  whole_bobbed      sampled film frames coded whole in one picture (both
                    fields of one film instant) that were served as the
                    bob UCF may put in a film frame's place: UCF bobs a
                    weave that combs, and only the 3:2 repairs, whose
                    fields come from two intra pictures, comb here
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pb import compare, delogo

FILM_TICKS = 5
VIDEO_TICKS = 4
CLOCK = (120000, 1001)


def reference(config: dict, rec, truth: dict, geometry: dict, logo_planes,
              dtype=torch.float32, device="cpu"):
    """The Reference of one recording (`rec` the synth.Recording,
    `logo_planes` the painted logo's six window planes, None without a
    logo)."""
    return Reference(rec, truth, geometry, logo_planes, dtype, device)


def kfm_plan(rec, n: int) -> tuple:
    """(top source frame, bottom source frame) and duration in ticks of
    each output frame of the kfm_vfr configuration, from the layout's field
    times."""
    film = {i: s.film for i, s in enumerate(rec.scenes)}
    times = [rec.field_times(k) for k in range(n)]
    plan, ticks = [], []
    for i, (scene, top, bottom) in enumerate(times):
        if not film[scene]:
            plan.append((i, i))
            ticks.append(VIDEO_TICKS)
        elif top == bottom:
            plan.append((i, i))
            ticks.append(FILM_TICKS)
        elif i + 1 < n:
            ns, nt, nb = times[i + 1]
            # this frame's bottom field is the next frame's top film frame:
            # the next frame repairs it (unless that one is whole)
            if ns == scene and nt == bottom and nb != nt:
                plan.append((i + 1, i))
                ticks.append(FILM_TICKS)
    return plan, ticks


def timecodes(ticks: list) -> np.ndarray:
    """Start of each output frame in ms."""
    tick = 1000.0 * CLOCK[1] / CLOCK[0]
    return np.concatenate([[0], np.cumsum(ticks)[:-1]]) * tick


def bob_top(planes) -> tuple:
    """Each plane's top field line-doubled: odd lines the mean of the even
    lines above and below (the last one repeated), rounded half up."""
    out = []
    for p in planes:
        f = np.asarray(p, np.float32)[0::2]
        nxt = np.concatenate([f[1:], f[-1:]])
        full = np.empty((2 * len(f), f.shape[1]), np.float32)
        full[0::2] = f
        full[1::2] = (f + nxt) * np.float32(0.5)
        out.append(np.clip(np.floor(full + np.float32(0.5)), 0, 255)
                   .astype(np.uint8))
    return tuple(out)


def weave(top_planes, bottom_planes) -> tuple:
    out = []
    for t, b in zip(top_planes, bottom_planes):
        f = np.array(t, copy=True)
        f[1::2] = b[1::2]
        out.append(f)
    return tuple(out)


class Reference:
    """The frames and decisions one recording of a configuration must give.
    `rec` is the synth.Recording, `lgd_planes` the painted logo's six
    window planes (None without a logo)."""

    # lines of a plane next to the logo box that a bob reads from the box
    REACH = 2

    def __init__(self, rec, truth: dict, geometry: dict, lgd_planes=None,
                 dtype=torch.float32, device="cpu", workers: int = 8):
        self.rec, self.truth = rec, truth
        self.geometry, self.dtype, self.device = geometry, dtype, device
        self.workers = workers
        self.cm_pass = truth["logos_given"]
        self.ab = (delogo.logo_planes(lgd_planes, geometry)
                   if lgd_planes is not None else None)
        self.fade = delogo.fade_curve(truth) if self.ab is not None else None
        self.plan, self.ticks = kfm_plan(rec, truth["frames"])

    @property
    def num_out(self) -> int:
        return len(self.plan)

    def timecodes(self):
        return timecodes(self.ticks)

    def seams(self) -> list:
        """Output indices on either side of each edge between two parts of
        the layout (where the logo fades and the content changes)."""
        firsts = {p["first"] for p in self.truth["parts"][1:]}
        out = []
        for i in range(1, len(self.plan)):
            if any(self.plan[i - 1][0] < f <= self.plan[i][0]
                   for f in firsts):
                out += [i - 1, i]
        return out

    def filter_result(self) -> dict:
        """The filter analysis's decisions as the configuration makes them
        (what a program that is right reports)."""
        return dict(num_out=self.num_out, timecodes=list(self.timecodes()))

    def frames(self, indices: list) -> dict:
        """Output frames at the given output indices: for each, the list of
        (frame, how it was made) the configuration allows there, the first
        the one it gives unless UCF steps in. How: ("weave", top source,
        bottom source) or ("bob", top source)."""
        need = sorted({k for i in indices for k in self.plan[i]})
        with ThreadPoolExecutor(self.workers) as pool:
            raw = dict(zip(need, pool.map(self.rec.reconstruct, need)))
        self.raw = raw
        src = {k: self.erased(raw[k], self.fade[k] if self.ab else 0.0)
               for k in need}
        out = {}
        for i in indices:
            top, bottom = self.plan[i]
            out[i] = [(weave(src[top], src[bottom]), ("weave", top, bottom))]
            if self.ticks[i] == FILM_TICKS:
                out[i].append((bob_top(src[top]), ("bob", top)))
        return out

    def erased(self, planes, fade: float) -> tuple:
        if self.ab is None:
            return planes
        return delogo.erase(planes, self.ab, float(fade), self.dtype,
                            self.device)

    def fit_box(self, got: tuple, how: tuple) -> tuple:
        """The fades that best explain a served frame's logo box: each
        field's source erased at every fade the configuration can give (a
        mean of nine of the 11 fade steps: k/90), the mean gap over the
        box at the best ones, and those fades (top, bottom)."""
        lx, ly, lw, lh = self.geometry["logo_box"]
        fades = torch.arange(91, dtype=torch.float32) / 90.0
        crops = {}

        def crop(k, s):
            key = (k, s)
            if key not in crops:
                y0, y1 = ly // s - 2, (ly + lh) // s + 2
                x0, x1 = lx // s, (lx + lw) // s
                planes = []
                for q, sub in ((0, 1), (1, 2), (2, 2)):
                    if sub != s:
                        continue
                    a, b = self.ab[q]
                    src = torch.from_numpy(np.ascontiguousarray(
                        self.raw[k][q][max(y0, 0):y1, x0:x1])).to(self.dtype)
                    at = torch.from_numpy(a[max(y0, 0):y1, x0:x1]).to(
                        self.dtype)
                    bt = torch.from_numpy(b[max(y0, 0):y1, x0:x1]).to(
                        self.dtype)
                    f = fades.to(self.dtype)[:, None, None]
                    bg = at * src + bt * 255.0
                    tmp = f * bg + (1.0 - f) * src
                    planes.append(torch.floor(tmp + 0.5).clamp(0, 255))
                crops[key] = planes
            return crops[key]

        def plane_crops(k):
            return crop(k, 1) + crop(k, 2)  # Y, U, V: [91, h, w] each

        def got_box(q):
            s = 1 if q == 0 else 2
            y0, x0 = ly // s, lx // s
            return torch.from_numpy(np.asarray(
                got[q][y0:y0 + lh // s, x0:x0 + lw // s], np.float32))

        def rows(t, parity):
            return t[..., parity::2, :]

        best = []
        if how[0] == "weave":
            total, n = 0.0, 0
            for parity, k in ((0, how[1]), (1, how[2])):
                gaps = torch.zeros(91)
                cnt = 0
                for q, c in enumerate(plane_crops(k)):
                    box = c[:, 2:-2]
                    g = rows(got_box(q), parity)
                    gaps += (rows(box, parity) - g).abs().sum(dim=(1, 2))
                    cnt += g.numel()
                j = int(torch.argmin(gaps))
                best.append(float(fades[j]))
                total += float(gaps[j])
                n += cnt
            return total / n, tuple(best)
        gaps = torch.zeros(91)
        cnt = 0
        for q, c in enumerate(plane_crops(how[1])):
            f = c[:, 0::2]  # the top field rows of the grown crop
            nxt = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
            full = torch.empty_like(c)
            full[:, 0::2] = f
            full[:, 1::2] = torch.floor((f + nxt) * 0.5 + 0.5)
            g = got_box(q)
            gaps += (full[:, 2:-2] - g).abs().sum(dim=(1, 2))
            cnt += g.numel()
        j = int(torch.argmin(gaps))
        return float(gaps[j]) / cnt, (float(fades[j]), float(fades[j]))


def numbers(ref, expected: dict, served: list, cm_results: list,
            filter_results: list) -> dict:
    """The compared numbers of one run. expected: output index -> the
    (frame, how it was made) pairs the reference allows there, the first
    its own; served: per recording, the encoder's file as loaded (None
    where it wrote none); cm_results / filter_results: per recording, what
    the CM pass and the filter analysis decided (None where they did not
    run)."""
    truth = ref.truth
    out = dict(count_wrong=0, samples_missing=0, outside_gap=0,
               recordings_differ=compare.recordings_differ(served))
    if ref.cm_pass:
        want_logo = truth["painted_logo_file"]
        out["cm_wrong"] = sum(
            1 for c in cm_results
            if c is None or c["trims"] != truth["trims"]
            or c["cm_zones"] != truth["cm_zones"]
            or c["logo_file"] != want_logo)
    want_tc = ref.timecodes()
    gap = 0.0
    for f in filter_results:
        tc = None if f is None else np.asarray(f["timecodes"], float)
        if tc is None or len(tc) != len(want_tc):
            gap = float("inf")
        else:
            gap = max(gap, float(np.abs(tc - want_tc).max(initial=0.0)))
    out["timecode_gap_ms"] = gap
    whole_bobbed = 0
    box_gap, flips = 0.0, 0
    for enc in served:
        if enc is None or enc["n_frames"] != ref.num_out:
            out["count_wrong"] += 1
        if enc is None:
            out["samples_missing"] += len(expected)
            continue
        for k, allowed in expected.items():
            got = enc["frames"].get(k)
            want0 = allowed[0][0]
            if got is None or any(g.shape != w.shape
                                  for g, w in zip(got, want0)):
                out["samples_missing"] += 1
                continue
            off = [~m for m in compare.box_masks(ref.geometry, ref.REACH)] \
                if ref.ab is not None else [np.ones(w.shape, bool)
                                            for w in want0]
            gaps = [compare.outside_gap(got, want, off)
                    for want, _ in allowed]
            pick = int(np.argmin(gaps))
            out["outside_gap"] = max(out["outside_gap"], gaps[pick])
            _, top, bottom = allowed[0][1]
            if len(allowed) > 1 and top == bottom and pick > 0:
                whole_bobbed += 1
            how = allowed[pick][1]
            if ref.ab is None:
                continue
            gap, fades = ref.fit_box(got, how)
            box_gap = max(box_gap, gap)
            for src, f in zip(how[1:], fades):
                want = float(ref.fade[src])
                if want in (0.0, 1.0) and abs(f - want) > 0.5:
                    flips += 1
    if ref.ab is not None:
        out["box_fit_gap"] = box_gap
        out["fade_flips"] = flips
    out["whole_bobbed"] = whole_bobbed
    return out


def guarantee_control(ref, keep: list) -> tuple:
    """What a program that breaks the profile's guarantee hands the
    encoder: the coded frames as they are, at 30p, with no telecine
    removed. (frames at the kept output indices, output count, filter
    results)."""
    n = ref.truth["frames"]
    woven = {i: ref.erased(ref.rec.reconstruct(i),
                           ref.fade[i] if ref.ab else 0.0)
             for i in keep if i < n}
    return woven, n, [dict(num_out=n,
                           timecodes=list(timecodes([VIDEO_TICKS] * n)))]
