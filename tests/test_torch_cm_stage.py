"""The CM analysis pass and the filter stage it feeds, on the CPU, against
the JAX package.

    python tests/test_torch_cm_stage.py --write

runs a JAX composition of the reference's in-process CM analysis
(pipeline/transcode.py:427-616, :691-720, :793-805: scene_metrics_batch
with its carry, histogram_correlation_from_hists, detect_scene_changes,
the JAX LogoFrameMatcher on its device path, audio_rms_windows /
detect_silence, CMAnalyzer.analyze, the JLS elements and the five files)
over the 96x128 broadcast layout of utils/synth_clip.py, checks the port's
run_cm_analysis on the CPU against it, and writes
amatsukaze_tpu_torch/testdata/golden_cm.json, which chip_smoke.py holds the
card to.

As tests: the same comparison (everything exact but the fade curve, within
1e-5: float32 sums in another order), the layout's constructed truth, the
record; then run_filter_stage(cm=...): its zones and v2 timecode text equal
to the JAX make_out_zones and _encode_one's formatting over the same spec,
its frames the same with the frame spill and without; the recorded digests
of testdata/golden_stage.json with the spill usable and forced off; the
filter dump equal to the JAX FilterGraph.debug_dump.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # for the script run
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
from test_torch_filter_stage import jax_format, jax_logo, jax_stage  # noqa: E402

import amatsukaze_tpu.models.logo as jlogo_model  # noqa: E402
from amatsukaze_tpu.models import chapter as jchapter  # noqa: E402
from amatsukaze_tpu.models import cm_analyze as jcma  # noqa: E402
from amatsukaze_tpu.models.filter_graph import \
    make_out_zones as j_make_out_zones  # noqa: E402
from amatsukaze_tpu.ops import cm as jcm  # noqa: E402
from amatsukaze_tpu.utils.batching import pad_tail as j_pad_tail  # noqa: E402
from amatsukaze_tpu.utils.context import AMTContext as JContext  # noqa: E402
from amatsukaze_tpu_torch.pipeline import cm_stage  # noqa: E402
from amatsukaze_tpu_torch.pipeline.cm_stage import run_cm_analysis  # noqa: E402
from amatsukaze_tpu_torch.pipeline.filter_stage import (  # noqa: E402
    run_filter_stage)
from amatsukaze_tpu_torch.utils import golden, synth_clip  # noqa: E402
from amatsukaze_tpu_torch.utils.context import AMTContext  # noqa: E402

BATCH = 32
TRUTH = synth_clip.BROADCAST_TRUTH


class _Patch:
    """monkeypatch's setattr for the script run (never undone: the process
    ends)."""

    @staticmethod
    def setattr(obj, name, value):
        setattr(obj, name, value)


def read_files(out_dir) -> dict:
    return {k: Path(out_dir, f).read_text()
            for k, f in cm_stage.FILES.items()}


def jax_cm(name: str, out_dir, monkeypatch) -> dict:
    """The CM pass of the JAX package over one broadcast clip, composed as
    TranscodePipeline._analyze_video_file composes it; its record."""
    monkeypatch.setattr(jlogo_model, "_HOST_OPS", False)  # the device path
    open_frames, n, fmt, logos, pcm = synth_clip.broadcast_clip(name)
    fps = fmt.frame_rate
    ctx = JContext(level="error")
    ys = [planes[0] for planes in open_frames()]
    path = {k: os.path.join(out_dir, f) for k, f in cm_stage.FILES.items()}

    scores, hists, prev = [], [], None
    for k in range(0, n, BATCH):
        pend = ys[k:k + BATCH]
        padded, n_real = j_pad_tail(pend, BATCH)
        arr = jnp.asarray(padded)
        d, h = jcm.scene_metrics_batch(
            arr, arr[0] if prev is None else jnp.asarray(prev))
        scores.append(np.asarray(d)[:n_real])
        hists.append(np.asarray(h)[:n_real])
        prev = pend[-1]
    corr = jcm.histogram_correlation_from_hists(np.concatenate(hists))
    scene_changes = jcm.detect_scene_changes(np.concatenate(scores), corr)
    Path(path["scpos"]).write_text(
        jcma.format_scene_changes_text(scene_changes, []))

    jl = [jax_logo(lg) for lg in logos]
    m = jlogo_model.LogoFrameMatcher(ctx, jl)
    m.scan_frames(iter(ys), fmt.width, fmt.height, fps, batch=BATCH,
                  fade_steps=11)
    best = m.select_logo()
    m.write_result(path["logo_frames"])
    spans = [(iv.s_best, iv.e_best + 1) for iv in m.intervals()]

    x = pcm.astype(np.float32) / 32768.0
    window = 48000 * 2 // 100
    usable = len(x) // window * window
    rms = jcm.audio_rms_windows(jnp.asarray(x[:usable]), window)
    silence = [(int(s * fps / 100.0), int(e * fps / 100.0))
               for s, e in jcm.detect_silence(rms, threshold=0.01,
                                              min_windows=30)]

    r = jcma.CMAnalyzer(ctx, n, fps).analyze(
        spans, m.logo_ratio, logos[best].header.name, scene_changes, silence)
    Path(path["trim"]).write_text(jcma.format_trim_avs(r.trims) + "\n")
    Path(path["div"]).write_text(
        "\n".join(str(d) for d in r.divs[:-1]) + "\n")
    bounds = sorted(set([0, n] + r.trims + r.divs))
    elements = [jchapter.JlsElement(a, b, int(round((b - a) / fps)))
                for a, b in zip(bounds, bounds[1:]) if b > a]
    Path(path["jls"]).write_text(jchapter.format_jls(elements))
    assert r.logopath == logos[best].header.name
    return golden.cm_record(scene_changes, silence, best, spans,
                            m.fade_curve(), r.trims, r.divs, r.cmzones,
                            elements, read_files(out_dir))


def port_cm(name: str, out_dir):
    """(CMStageResult, record) of the port on the CPU."""
    open_frames, n, fmt, logos, pcm = synth_clip.broadcast_clip(name)
    cm = run_cm_analysis(AMTContext(level="error"), open_frames, n, fmt,
                         logos, pcm_s16=pcm, batch=BATCH, device="cpu",
                         out_dir=str(out_dir))
    return cm, golden.cm_stage_record(cm, read_files(out_dir))


def assert_truth(rec: dict, what: str) -> None:
    """The layout's constructed truth."""
    assert rec["trims"] == TRUTH["trims"], what
    assert rec["cmzones"] == [list(z) for z in TRUTH["cm_zones"]], what
    assert rec["scene_changes"] == TRUTH["scene_changes"], what
    assert rec["best_logo"] == 0, what
    assert len(rec["silence"]) == 2, what
    for (s, e), cut in zip(rec["silence"], TRUTH["cm_zones"][0]):
        assert s < cut < e, what


@pytest.fixture(scope="module")
def jax_small(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return jax_cm("small", tmp_path_factory.mktemp("jax"), mp)


@pytest.fixture(scope="module")
def port_small(tmp_path_factory):
    return port_cm("small", tmp_path_factory.mktemp("port"))


def test_cm_pass_matches_jax(port_small, jax_small):
    cm, rec = port_small
    golden.assert_cm_matches(rec, jax_small, "port vs JAX")
    assert cm.num_frames == synth_clip.BROADCAST_FRAMES
    assert cm.result.logopath == "synth"
    assert_truth(rec, "port")


def test_cm_pass_matches_record(port_small, jax_small):
    recorded = golden.load_cm()
    assert set(recorded) == {"small"}
    golden.assert_cm_matches(jax_small, recorded["small"], "JAX vs record")
    golden.assert_cm_matches(port_small[1], recorded["small"],
                             "port vs record")


def test_cm_record_mismatch_is_reported(jax_small):
    with pytest.raises(AssertionError, match="trims"):
        golden.assert_cm_matches(dict(jax_small, trims=[0, 1340]), jax_small,
                                 "x")
    with pytest.raises(AssertionError, match="fade"):
        golden.assert_cm_matches(
            dict(jax_small, fade=[f + 1e-3 for f in jax_small["fade"]]),
            jax_small, "x")


def test_cm_pass_one_upload_per_batch(monkeypatch):
    """The scene metrics and the matcher read one tensor per batch: the
    matcher's per-batch entry gets the whole padded frame batch that the
    scene metrics got, and fetches batch k's scores only after batch k+1's
    launches."""
    from amatsukaze_tpu_torch.models import logo as tlogo
    from amatsukaze_tpu_torch.ops import cm as tcm

    seen = []
    metrics = tcm.scene_metrics_batch
    scan = tlogo.LogoFrameMatcher.scan_batch
    fetch = tlogo.LogoFrameMatcher._fetch_pending

    def counted_metrics(frames, prev):
        seen.append(("metrics", id(frames), tuple(frames.shape)))
        return metrics(frames, prev)

    def counted_scan(self, luma, n_real, origin=(0, 0)):
        seen.append(("scan", id(luma), tuple(luma.shape)))
        return scan(self, luma, n_real, origin)

    def counted_fetch(self):
        if self._pending is not None:
            seen.append(("fetch", None, None))
        return fetch(self)

    monkeypatch.setattr(tcm, "scene_metrics_batch", counted_metrics)
    monkeypatch.setattr(tlogo.LogoFrameMatcher, "scan_batch", counted_scan)
    monkeypatch.setattr(tlogo.LogoFrameMatcher, "_fetch_pending",
                        counted_fetch)
    frames, fmt, logos, _ = synth_clip.golden_clip("small")
    cm = run_cm_analysis(AMTContext(level="error"), lambda: iter(frames),
                         len(frames), fmt, logos, batch=16, device="cpu")
    kinds = [k for k, _, _ in seen]
    assert kinds == ["metrics", "scan", "metrics", "scan", "fetch",
                     "metrics", "scan", "fetch", "fetch"]
    pairs = [(a, b) for a, b in zip(seen, seen[1:])
             if a[0] == "metrics" and b[0] == "scan"]
    assert len(pairs) == 3
    assert all(a[1] == b[1] and a[2] == b[2] == (16, 96, 128)
               for a, b in pairs)
    assert cm.num_frames == len(frames) == 45
    assert cm.silence == []  # no audio


OPTIONS = {
    "script_and_pmt": dict(script="AutoEdge S -sec 5\n", pmt=(0.5, 0.0),
                           pid_changes=[0, 215]),
    "tail_pmt": dict(pmt=(0.0, 0.5), pid_changes=[0, 880, 905]),
    "loose_no_delogo": dict(loose=True, no_delogo=True),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_cm_pass_options_match_jax(name, port_small, tmp_path):
    """The decision options pass through as the reference passes them
    (transcode.py:390-401, :613-615): the port's pass with a JL script, a
    PMT cut or loose detection and no_delogo against the JAX CMAnalyzer
    (and JlsScript) over the same scene changes, silence and logo spans;
    the JLS elements and file from the final trims."""
    from amatsukaze_tpu.models.jls_script import JlsScript as JJlsScript
    from amatsukaze_tpu_torch.models.jls_script import JlsScript

    opt = OPTIONS[name]
    base = port_small[0]
    open_frames, n, fmt, logos, pcm = synth_clip.broadcast_clip("small")
    script = opt.get("script")
    cm = run_cm_analysis(
        AMTContext(level="error"), open_frames, n, fmt, logos, pcm_s16=pcm,
        jls_script=JlsScript(script) if script else None,
        loose_logo_detection=opt.get("loose", False),
        no_delogo=opt.get("no_delogo", False),
        pid_changes=opt.get("pid_changes"),
        pmt_cut_side_rate=opt.get("pmt", (0, 0)), batch=BATCH, device="cpu",
        out_dir=str(tmp_path))
    assert cm.scene_changes == base.scene_changes
    assert cm.silence == base.silence
    fps = fmt.frame_rate
    an = jcma.CMAnalyzer(JContext(level="error"), n, fps,
                         loose_logo_detection=opt.get("loose", False),
                         jls_script=JJlsScript(script) if script else None)
    an.analyze(cm.logo_spans, cm.matcher.logo_ratio, "synth",
               cm.scene_changes, cm.silence)
    if "pmt" in opt:
        an.apply_pmt_cut(opt["pmt"], opt["pid_changes"])
    want = an.result
    assert (cm.result.trims, cm.result.divs) == (want.trims, want.divs)
    assert [(z.start_frame, z.end_frame) for z in cm.result.cmzones] == [
        (z.start_frame, z.end_frame) for z in want.cmzones]
    assert cm.result.trims != base.result.trims or "loose" in opt
    bounds = sorted(set([0, n] + want.trims + want.divs))
    assert [(e.frame_start, e.frame_end) for e in cm.jls_elements] == list(
        zip(bounds, bounds[1:]))
    assert (tmp_path / cm_stage.FILES["jls"]).read_text() == \
        jchapter.format_jls([jchapter.JlsElement(e.frame_start, e.frame_end,
                                                 e.seconds)
                             for e in cm.jls_elements])
    if opt.get("no_delogo"):
        assert cm.fade is None and cm.matcher.fade_steps == 2
        assert cm.best_logo == base.best_logo


# ---------------------------------------------------------------------------
# the filter stage fed by the CM pass
# ---------------------------------------------------------------------------

def port_stage(name, cm, tmp_path, **kw):
    open_frames, n, fmt, logos, _ = synth_clip.broadcast_clip(name)
    digests = []
    res = run_filter_stage(
        AMTContext(level="error"), open_frames, n, fmt, logos, "kfm_vfr",
        lambda planes: digests.append(golden.frame_digest(planes)),
        batch=BATCH, device="cpu", cm=cm,
        timecode_path=str(tmp_path / "tc.txt"),
        dump_path=str(tmp_path / "dump.json"), **kw)
    return res, digests


@pytest.fixture(scope="module")
def stage_runs(port_small, tmp_path_factory):
    cm = port_small[0]
    return {cap: (port_stage("small", cm, d, analysis_cache_bytes=cap), d)
            for cap, d in ((None, tmp_path_factory.mktemp("spill")),
                           (0, tmp_path_factory.mktemp("nospill")))}


def test_stage_zones_and_timecodes_match_jax(port_small, stage_runs):
    cm = port_small[0]
    (res, _), out = stage_runs[None]
    spec = res.spec
    n = synth_clip.BROADCAST_FRAMES
    assert spec.time_codes, "the layout gives VFR output"
    want = j_make_out_zones(
        [jcma.EncoderZone(z.start_frame, z.end_frame)
         for z in cm.result.cmzones], list(range(n)), spec.num_out_frames,
        list(spec.time_codes), 30000, 1001)
    got = [(z.start_frame, z.end_frame) for z in res.zones]
    assert got == [(z.start_frame, z.end_frame) for z in want]
    assert len(got) == 1 and got[0][0] < got[0][1] <= spec.num_out_frames
    text = "# timecode format v2\n" + "".join(
        f"{tc:.6f}\n" for tc in spec.time_codes[:spec.num_out_frames])
    assert (out / "tc.txt").read_text() == text
    assert len(text.splitlines()) == spec.num_out_frames + 1


def test_stage_spill_changes_no_frame(stage_runs):
    (on, d_on), out_on = stage_runs[None]
    (off, d_off), out_off = stage_runs[0]
    assert on.spill_frames == synth_clip.BROADCAST_FRAMES
    assert off.spill_frames == 0
    assert d_on == d_off and len(d_on) == on.num_out_frames
    assert [(z.start_frame, z.end_frame) for z in on.zones] == [
        (z.start_frame, z.end_frame) for z in off.zones]
    for f in ("tc.txt", "dump.json"):
        assert (out_on / f).read_text() == (out_off / f).read_text()
    assert on.best_logo == 0 and on.matcher is not None


@pytest.mark.parametrize("cm_zones_mode", ["non_cm", "cm"])
def test_stage_zones_only_for_both(port_small, tmp_path, cm_zones_mode):
    """Only a file that holds program and CM carries the CM zones; the
    frames do not depend on it."""
    frames, fmt, logos, batch = synth_clip.golden_clip("small")
    res = run_filter_stage(AMTContext(level="error"), lambda: iter(frames),
                           len(frames), fmt, logos, "yadif", lambda p: None,
                           batch=batch, device="cpu", cm=port_small[0],
                           cm_zones_mode=cm_zones_mode)
    assert res.zones == []
    with pytest.raises(ValueError):
        run_filter_stage(AMTContext(), lambda: iter(frames), len(frames),
                         fmt, logos, "yadif", lambda p: None, device="cpu",
                         cm_zones_mode="half")


@pytest.mark.parametrize("cap", [None, 0])
def test_stage_golden_digests_with_and_without_spill(cap, monkeypatch,
                                                     tmp_path):
    """The recorded results of the small clip hold with the spill usable
    and forced off; the filter dump is the JAX FilterGraph's."""
    frames, fmt, logos, batch = synth_clip.golden_clip("small")
    digests = []
    res = run_filter_stage(
        AMTContext(level="error"), lambda: iter(frames), len(frames), fmt,
        logos, "kfm_vfr", lambda p: digests.append(golden.frame_digest(p)),
        batch=batch, device="cpu", analysis_cache_bytes=cap,
        dump_path=str(tmp_path / "dump.json"))
    assert res.spill_frames == (len(frames) if cap is None else 0)
    golden.assert_matches(
        golden.record(res.best_logo, res.fade, res.graph, digests=digests),
        golden.load()["small"]["kfm_vfr"], f"spill cap {cap}")
    if cap is None:
        *_, jfg, _, _ = jax_stage(frames, jax_format(fmt.height, fmt.width),
                                  logos, "kfm_vfr", batch, monkeypatch)
        assert json.loads((tmp_path / "dump.json").read_text()) == json.loads(
            json.dumps(jfg.debug_dump(len(frames))))


def test_stage_erase_logos_at_full_fade(tmp_path):
    """erase_logos entries erase at fade 1 on every frame: the same frames
    as the logo given with a fade curve of ones."""
    frames, fmt, logos, batch = synth_clip.golden_clip("small")
    from amatsukaze_tpu_torch.models.logo_erase import LogoEraser

    ctx = AMTContext(level="error")
    got = []
    run_filter_stage(ctx, lambda: iter(frames), len(frames), fmt, [],
                     "yadif", got.append, batch=batch, device="cpu",
                     erase_logos=[logos[0]])
    ones = np.ones(len(frames), np.float32)
    eraser = LogoEraser(ctx, [(logos[0], ones)], fmt.width, fmt.height,
                        device="cpu")
    want = list(eraser.erase_iter(iter(frames), batch))
    plain = []
    run_filter_stage(ctx, lambda: iter(want), len(want), fmt, [], "yadif",
                     plain.append, batch=batch, device="cpu")
    assert len(got) == len(plain) == len(frames)
    assert all(np.array_equal(a, b) for f, g in zip(got, plain)
               for a, b in zip(f, g))
    ys = slice(8, 24)
    assert not np.array_equal(got[-1][0][ys], frames[-1][0][ys])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate testdata/golden_cm.json")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do without --write")
    import tempfile

    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as pd:
        want = jax_cm("small", jd, _Patch)
        _, got = port_cm("small", pd)
    golden.assert_cm_matches(got, want, "port vs JAX small")
    assert_truth(want, "JAX small")
    golden.save_cm({"small": want},
                   {"spec": synth_clip.BROADCAST_CLIPS["small"],
                    "frames": synth_clip.BROADCAST_FRAMES, "batch": BATCH})
    print(f"small: port == JAX on the CPU; wrote {golden.CM_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
