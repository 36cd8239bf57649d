"""The plain reference: what each configuration must hand the encoder,
worked out again from the inputs the harness made (the writer's
reconstruction of every frame, the logo planes, the truth of the layout),
in NumPy and plain PyTorch. It imports nothing of the program and reads
none of its decisions.

- CM pass: the trims and CM zones are the layout's program and CM parts;
  the chosen logo is the logo file that holds the painted logo.
- Logo erase (Amatsukaze's Delogo, LogoScan.hpp:1248-1261): every source
  frame, on Y, U and V, dst = floor(fade (A src + B 255) + (1 - fade) src
  + 0.5) clamped to [0, 255], with the fade 1 on frames that carry the
  logo and 0 elsewhere, box-averaged over +-4 frames (CalcFade2).
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
bfloat16)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FADE_WINDOW = 4
FILM_TICKS = 5
VIDEO_TICKS = 4
CLOCK = (120000, 1001)


def fade_curve(truth: dict) -> np.ndarray:
    """Per source frame erase fade of the painted logo."""
    on = np.zeros(truth["frames"])
    for s in truth["scenes"]:
        if s["logo"]:
            on[s["first"]:s["end"]] = 1.0
    k = np.ones(2 * FADE_WINDOW + 1) / (2 * FADE_WINDOW + 1)
    fade = np.convolve(np.pad(on, FADE_WINDOW, mode="edge"), k, mode="valid")
    return np.clip(fade.astype(np.float32), 0.0, 1.0)


def logo_planes(lgd_planes, geometry: dict) -> list:
    """Full-frame (A, B) float32 planes per colour (identity off the
    logo) from the painted logo's window planes."""
    lx, ly, lw, lh = geometry["logo_box"]
    h, w = geometry["height"], geometry["width"]
    out = []
    for p, s in enumerate((1, 2, 2)):
        a = np.ones((h // s, w // s), np.float32)
        b = np.zeros((h // s, w // s), np.float32)
        a[ly // s:ly // s + lh // s, lx // s:lx // s + lw // s] = \
            lgd_planes[2 * p]
        b[ly // s:ly // s + lh // s, lx // s:lx // s + lw // s] = \
            lgd_planes[2 * p + 1]
        out.append((a, b))
    return out


def erase(planes, ab: list, fade: float, dtype=torch.float32,
          device="cpu") -> tuple:
    """Delogo one frame's (Y, U, V) uint8 planes at `fade`."""
    out = []
    for x, (a, b) in zip(planes, ab):
        src = torch.from_numpy(np.asarray(x)).to(device, dtype)
        at = torch.from_numpy(a).to(device, dtype)
        bt = torch.from_numpy(b).to(device, dtype)
        f = torch.tensor(fade, dtype=dtype, device=device)
        bg = at * src + bt * torch.tensor(255.0, dtype=dtype, device=device)
        tmp = f * bg + (torch.tensor(1.0, dtype=dtype, device=device)
                        - f) * src
        out.append(torch.floor(tmp + 0.5).clamp(0.0, 255.0)
                   .to(torch.uint8).cpu().numpy())
    return tuple(out)


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

    def __init__(self, family: str, rec, truth: dict, geometry: dict,
                 lgd_planes=None, dtype=torch.float32, device="cpu",
                 workers: int = 8):
        if family != "kfm_vfr":
            raise ValueError(f"no reference for the family {family!r}")
        self.family, self.rec, self.truth = family, rec, truth
        self.geometry, self.dtype, self.device = geometry, dtype, device
        self.workers = workers
        self.cm_pass = truth["logos_given"]
        self.ab = (logo_planes(lgd_planes, geometry)
                   if lgd_planes is not None else None)
        self.fade = fade_curve(truth) if self.ab is not None else None
        self.plan, self.ticks = kfm_plan(rec, truth["frames"])

    @property
    def num_out(self) -> int:
        return len(self.plan)

    def timecodes(self):
        return timecodes(self.ticks)

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
        return erase(planes, self.ab, float(fade), self.dtype, self.device)

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
