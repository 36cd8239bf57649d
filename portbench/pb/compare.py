"""The comparison that decides `correct`: what the timed path produced
against the reference, once the window has closed. Each number has a limit
(portbench/cells/<cell>.json "limits"); the run is correct when every
recording completed and every number is within its limit.

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

import numpy as np

from . import fake_encoder


def sample_indices(n_out: int, seed: int, count: int, seams=()) -> list:
    """Output frames kept whole by the encoder: the first, the last, the
    frames at the seams (where the program parts meet) and `count` more
    drawn from the seed."""
    rng = np.random.default_rng((seed, 30))
    fixed = {0, n_out - 1} | {s for s in seams if 0 <= s < n_out}
    rest = [k for k in range(n_out) if k not in fixed]
    extra = rng.choice(rest, min(count, len(rest)), replace=False)
    return sorted(fixed | {int(k) for k in extra})


def box_masks(geometry: dict, reach: int) -> list:
    """Per plane, the logo box grown by `reach` pixels of that plane (True
    inside)."""
    lx, ly, lw, lh = geometry["logo_box"]
    h, w = geometry["height"], geometry["width"]
    masks = []
    for s in (1, 2, 2):
        m = np.zeros((h // s, w // s), bool)
        r = reach * s
        y0, y1 = max(0, (ly - r) // s), min(h // s, -(-(ly + lh + r) // s))
        x0, x1 = max(0, (lx - r) // s), min(w // s, -(-(lx + lw + r) // s))
        m[y0:y1, x0:x1] = True
        masks.append(m)
    return masks


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
               recordings_differ=recordings_differ(served))
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
            off = [~m for m in box_masks(ref.geometry, ref.REACH)] \
                if ref.ab is not None else [np.ones(w.shape, bool)
                                            for w in want0]
            gaps = [outside_gap(got, want, off) for want, _ in allowed]
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


def recordings_differ(served: list) -> int:
    """Recordings whose frame digests differ from the first served
    recording's (one that served nothing is count_wrong's)."""
    digests = [enc["digests"] for enc in served if enc is not None]
    return sum(1 for d in digests[1:] if d != digests[0])


def outside_gap(got: tuple, want: tuple, masks: list) -> int:
    """Widest gap between two frames' planes where the masks hold."""
    return max((int(np.abs(g.astype(np.int32) - w.astype(np.int32))[m].max())
                for g, w, m in zip(got, want, masks) if m.any()), default=0)


def load_served(report: dict | None):
    """The encoder's file of a recording's report, loaded (None where the
    recording wrote none)."""
    if not report or not report.get("outfiles"):
        return None
    try:
        return fake_encoder.load(report["outfiles"][0]["path"])
    except (OSError, ValueError, KeyError):
        return None


def judge(nums: dict, limits: dict, failed: int) -> tuple:
    """(correct, lines): each number beside its limit."""
    ok = failed == 0
    lines = [f"failed {failed} limit 0"]
    for k, v in nums.items():
        lim = limits[k]
        lines.append(f"{k} {v} limit {lim}")
        ok = ok and v <= lim
    return ok, lines
