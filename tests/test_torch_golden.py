"""Recorded results of the filter stage from the JAX package on the CPU, for
the seeded clips of amatsukaze_tpu_torch/utils/synth_clip.py.

    python tests/test_torch_golden.py --write

runs the JAX package (logo match with 11 fades, erase, KFM analysis, output
in kfm_vfr and yadif, Y/U/V; its device path in jnp, as its own tests run
it on the CPU) and the port on the CPU over both clips, asserts that the two
agree on every output frame of the small clip, and on the 1440x1080 clip on
every pixel but the few where the port's erase and XLA's FMA-contracted CPU
erase part at a rounding tie (utils/golden.py: each is checked to lie in the
logo box's reach and to differ by one code value, and the frames that hold
one are recorded with both digests), and writes
amatsukaze_tpu_torch/testdata/golden_stage.json: best logo, fade curve,
cycle decisions, durations, source_frames and one blake2b digest per output
frame. chip_smoke.py holds the card to that file.

As tests: the small clip's record is regenerated from the JAX package and
from the port on the CPU and found equal to the file (fade within 1e-5:
float32 sums in another order; everything else exact); the 1440x1080
clip's regeneration from JAX takes minutes and is marked slow.
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # for the script run
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from test_torch_filter_stage import jax_format, jax_stage  # noqa: E402

from amatsukaze_tpu_torch.pipeline.filter_stage import (  # noqa: E402
    run_filter_stage)
from amatsukaze_tpu_torch.utils import golden, synth_clip  # noqa: E402
from amatsukaze_tpu_torch.utils.context import AMTContext  # noqa: E402


class _Patch:
    """monkeypatch's setattr for the script run (never undone: the process
    ends)."""

    @staticmethod
    def setattr(obj, name, value):
        setattr(obj, name, value)


def jax_run(name: str, monkeypatch) -> dict:
    """{mode: (record, output frames)} from the JAX package."""
    frames, fmt, logos, batch = synth_clip.golden_clip(name)
    out = {}
    for mode in golden.MODES:
        best, fade, fg, _, outs = jax_stage(
            frames, jax_format(fmt.height, fmt.width), logos, mode, batch,
            monkeypatch)
        outs = [tuple(np.asarray(p) for p in f) for f in outs]
        out[mode] = (golden.record(best, fade, fg, outs), outs)
    return out


def port_run(name: str) -> dict:
    """{mode: (record, output frames)} from the port on the CPU."""
    frames, fmt, logos, batch = synth_clip.golden_clip(name)
    out = {}
    for mode in golden.MODES:
        outs = []
        res = run_filter_stage(AMTContext(level="error"),
                               lambda: iter(frames), len(frames), fmt, logos,
                               mode, outs.append, batch=batch, device="cpu")
        out[mode] = (golden.record(res.best_logo, res.fade, res.graph, outs),
                     outs)
    return out


def jax_record(name: str, monkeypatch) -> dict:
    return {m: rec for m, (rec, _) in jax_run(name, monkeypatch).items()}


def port_record(name: str) -> dict:
    return {m: rec for m, (rec, _) in port_run(name).items()}


MAX_TIE_PIXELS = 32  # per frame; about 20 are expected in a whole clip
MAX_TIE_FRAMES = 0.15  # share of a run's output frames


def erase_ties(name: str, got, want) -> dict:
    """Frames on which two runs' outputs differ -> number of pixels. Every
    such pixel must be an erase rounding tie: within the logo box grown by
    the reach of yadif's taps, one code value apart."""
    spec = synth_clip.GOLDEN_CLIPS[name]
    ties = {}
    for k, (a, b) in enumerate(zip(got, want)):
        n = 0
        for plane, (x, y) in enumerate(zip(a, b)):
            sub = 1 if plane == 0 else 2
            where = np.argwhere(x != y)
            if not len(where):
                continue
            y0, x0 = spec["ly"] // sub - 2, spec["lx"] // sub - 2
            y1 = (spec["ly"] + spec["lh"]) // sub + 2
            x1 = (spec["lx"] + spec["lw"]) // sub + 2
            assert ((where >= (y0, x0)) & (where < (y1, x1))).all(), (
                f"{name} frame {k} plane {plane}: differs outside the logo")
            assert np.abs(x.astype(int) - y.astype(int)).max() == 1, (
                f"{name} frame {k} plane {plane}: more than one code value")
            n += len(where)
        if n:
            assert n <= MAX_TIE_PIXELS, f"{name} frame {k}: {n} pixels differ"
            ties[k] = n
    assert len(ties) <= MAX_TIE_FRAMES * len(want), (
        f"{name}: {len(ties)} of {len(want)} frames differ")
    return ties


@pytest.fixture(scope="module")
def recorded():
    return golden.load()


def _check(got: dict, want: dict, what: str):
    for mode in golden.MODES:
        golden.assert_matches(got[mode], want[mode], f"{what} {mode}")


def test_record_covers_both_clips_and_modes(recorded):
    assert set(recorded) == set(synth_clip.GOLDEN_CLIPS)
    for name, rec in recorded.items():
        n = sum(synth_clip.GOLDEN_CLIPS[name][k]
                for k in ("n_film", "n_video"))
        assert set(rec) == set(golden.MODES)
        assert len(rec["yadif"]["digests"]) == n
        assert len(rec["kfm_vfr"]["digests"]) == len(
            rec["kfm_vfr"]["durations"]) != n
        assert rec["kfm_vfr"]["best_logo"] == 0
        assert len(rec["kfm_vfr"]["fade"]) == n
        # film cycles first, then 60p video
        modes = [m for m, _ in rec["kfm_vfr"]["decisions"]]
        assert modes[0] == 0 and modes[-1] == 2


def test_small_clip_jax_equals_record(recorded, monkeypatch):
    _check(jax_record("small", monkeypatch), recorded["small"], "JAX small")


def test_small_clip_port_equals_record(recorded):
    _check(port_record("small"), recorded["small"], "port small")


@pytest.mark.slow
def test_broadcast_clip_jax_equals_record(recorded, monkeypatch):
    _check(jax_record("broadcast", monkeypatch), recorded["broadcast"],
           "JAX broadcast")


def test_mismatch_is_reported(recorded):
    rec = recorded["small"]["yadif"]
    bad = dict(rec, digests=[rec["digests"][1], *rec["digests"][1:]])
    with pytest.raises(AssertionError, match="output frames differ"):
        golden.assert_matches(bad, rec, "x")
    with pytest.raises(AssertionError, match="fade"):
        golden.assert_matches(
            dict(rec, fade=[f + 1e-3 for f in rec["fade"]]), rec, "x")
    with pytest.raises(AssertionError, match="best_logo"):
        golden.assert_matches(dict(rec, best_logo=1), rec, "x")


def test_clip_is_reproducible():
    """The generator draws only integers from its seed and computes the
    picture in float64: a fixed digest of the small clip's luma guards the
    record against a numpy whose draws differ."""
    frames, _, _, _ = synth_clip.golden_clip("small")
    again, _, _, _ = synth_clip.golden_clip("small")
    assert all(np.array_equal(p, q) for f, g in zip(frames, again)
               for p, q in zip(f, g))
    assert golden.frame_digest(frames[25]) == golden.load_meta()[
        "small_frame25_source_digest"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate testdata/golden_stage.json")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do without --write")
    out = {}
    tie_pixels = {}
    for name in synth_clip.GOLDEN_CLIPS:
        j = jax_run(name, _Patch)
        p = port_run(name)
        out[name] = {}
        for mode in golden.MODES:
            (jrec, jouts), (prec, pouts) = j[mode], p[mode]
            assert len(jouts) == len(pouts)
            ties = erase_ties(name, pouts, jouts)
            if name == "small":
                assert not ties, f"small clip: erase ties in frames {ties}"
            jrec["tie_digests"] = {str(k): prec["digests"][k] for k in ties}
            golden.assert_matches(prec, jrec, f"port vs JAX {name} {mode}")
            out[name][mode] = jrec
            tie_pixels[f"{name}/{mode}"] = {str(k): n
                                            for k, n in ties.items()}
            print(f"{name} {mode}: {len(jouts)} frames, port == JAX on the "
                  f"CPU but for erase ties in frames {ties}")
    frames, _, _, _ = synth_clip.golden_clip("small")
    meta = {"small_frame25_source_digest": golden.frame_digest(frames[25]),
            "erase_tie_pixels": tie_pixels}
    golden.save(out, meta)
    print(f"wrote {golden.PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
