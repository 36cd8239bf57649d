"""The comparison that decides `correct`, the parts every configuration's
family shares: the sample of output frames the encoder keeps whole, the
logo box's masks, the gap of two frames, the recordings whose digests
differ, the encoder's file as loaded, and the judgement of each number
against its limit (portbench/cells/<cell>.json "limits"). The run is
correct when every recording completed and every number is within its
limit. Which numbers a cell has, and how each is worked out, is its
family's (`numbers` in portbench/families/<family>.py)."""

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
