"""The recorded results of the filter stage over the seeded clips of
utils.synth_clip (testdata/golden_stage.json): what is recorded of one run,
and how a run is held against the record.

The record comes from the JAX package on the CPU (written by
tests/test_torch_golden.py, which also runs the port on the CPU over the
same clips); the card is held to it by chip_smoke.py. Exact: selected logo,
cycle decisions, durations, source frames, one digest per output frame. The
fade curve within FADE_TOL (float32 sums in another order on another
device).

One difference between the packages is known and recorded, not tolerated:
XLA on the CPU contracts the erase into fused multiply-adds, the port
rounds each operation (as the reference C++ and ops.logo_ref do), and a
pixel whose blend lands within one float32 step of k + 0.5 comes out one
code value apart, about 1.5e-5 of the erased pixels. A 96x256 logo erased
on 45 frames of 1440x1080 4:2:0 has about 20 such pixels whatever the seed.
The writer checks every one (inside the logo box's reach, one code value)
and stores, for each frame that holds one, the port's CPU digest beside the
JAX one under ``tie_digests``; such a frame must equal either. The small
clip has none.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent.parent / "testdata" / "golden_stage.json"
MODES = ("kfm_vfr", "yadif")
FADE_TOL = 1e-5
_EXACT = ("best_logo", "decisions", "durations", "source_frames")


def frame_digest(planes) -> str:
    """blake2b-128 over the frame's Y, U, V bytes."""
    h = hashlib.blake2b(digest_size=16)
    for p in planes:
        if p.dtype != np.uint8:
            raise ValueError("output planes must be uint8")
        h.update(np.ascontiguousarray(p).data)
    return h.hexdigest()


def record(best_logo: int, fade, graph, out_frames=None,
           digests=None, tie_digests=None) -> dict:
    """One run of the stage as plain JSON types. `graph` is the run's
    FilterGraph (of either package); give the output frames or their
    digests."""
    plan = graph.vfr_plan
    if digests is None:
        digests = [frame_digest(f) for f in out_frames]
    return dict(
        best_logo=int(best_logo),
        fade=None if fade is None else [float(x) for x in fade],
        decisions=None if graph.decisions is None else [
            [int(d.mode), int(d.phase)] for d in graph.decisions],
        durations=None if plan is None else [int(d) for d in plan.durations],
        source_frames=None if plan is None else [
            [int(s), int(op)] for s, op in plan.source_frames],
        digests=list(digests),
        tie_digests=dict(tie_digests or {}))


def assert_matches(got: dict, want: dict, what: str) -> None:
    """Raise AssertionError naming what differs between two records."""
    diff = [k for k in _EXACT if got[k] != want[k]]
    if diff:
        raise AssertionError(f"{what}: results differ in {diff}")
    if (got["fade"] is None) != (want["fade"] is None) or (
            got["fade"] is not None and not (
                len(got["fade"]) == len(want["fade"]) and np.allclose(
                    got["fade"], want["fade"], rtol=0, atol=FADE_TOL))):
        raise AssertionError(f"{what}: fade curves differ")
    ties = want.get("tie_digests", {})
    bad = [k for k, (a, b) in enumerate(zip(got["digests"], want["digests"]))
           if a != b and a != ties.get(str(k))]
    if len(got["digests"]) != len(want["digests"]) or bad:
        raise AssertionError(
            f"{what}: {len(bad)} output frames differ (first {bad[:5]}; "
            f"{len(got['digests'])} frames against {len(want['digests'])})")


def load() -> dict:
    """{clip name: {mode: record}}."""
    return json.loads(PATH.read_text())["clips"]


def load_meta() -> dict:
    return json.loads(PATH.read_text())["meta"]


def save(clips: dict, meta: dict) -> None:
    PATH.parent.mkdir(parents=True, exist_ok=True)
    PATH.write_text(json.dumps({"meta": meta, "clips": clips},
                               separators=(",", ":")) + "\n")
