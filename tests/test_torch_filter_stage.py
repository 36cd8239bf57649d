"""run_filter_stage's `no_delogo` and `kfm_ucf` arguments on the CPU, against
the JAX package driven as pipeline/transcode.py drives it: with no_delogo
the matcher sweeps two fades and nothing is erased (transcode.py:553,588);
kfm_ucf is FilterGraph.kfm_ucf (filter_graph.py:296, set at
transcode.py:857). Same logo, identical decisions, plan and output frames;
the fade curve within 1e-5 (the tolerance of test_torch_logo.py: float32
sums in another order)."""

import numpy as np
import pytest

import amatsukaze_tpu.models.logo as jlogo_model
from amatsukaze_tpu.models.filter_graph import FilterGraph as JFilterGraph
from amatsukaze_tpu.models.lgd import LogoData as JLogoData
from amatsukaze_tpu.models.lgd import LogoHeader as JLogoHeader
from amatsukaze_tpu.models.logo_erase import LogoEraser as JLogoEraser
from amatsukaze_tpu.pipeline.transcode import _pump_filtered
from amatsukaze_tpu.types import VideoFormat as JVideoFormat
from amatsukaze_tpu.utils.context import AMTContext as JContext
from amatsukaze_tpu_torch.pipeline import filter_stage
from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
from amatsukaze_tpu_torch.utils import synth_clip
from amatsukaze_tpu_torch.utils.context import AMTContext

SPEC = dict(synth_clip.GOLDEN_CLIPS["small"])
BATCH = SPEC.pop("batch")
H, W = SPEC["h"], SPEC["w"]
FADE_TOL = 1e-5
_HEADER = ("w", "h", "log_uv_x", "log_uv_y", "imgw", "imgh", "imgx", "imgy",
           "name", "service_id")
_PLANES = ("a_y", "b_y", "a_u", "b_u", "a_v", "b_v")


def jax_logo(logo) -> JLogoData:
    """The port's LogoData as the JAX package's (the same numpy planes)."""
    out = JLogoData.create(JLogoHeader(*(getattr(logo.header, k)
                                         for k in _HEADER)))
    for k in _PLANES:
        setattr(out, k, np.array(getattr(logo, k), np.float32))
    return out


def jax_format(h, w) -> JVideoFormat:
    f = JVideoFormat()
    f.width, f.height = w, h
    f.frame_rate_num, f.frame_rate_denom = 30000, 1001
    return f


def jax_stage(frames, fmt, logos, mode, batch, monkeypatch, no_delogo=False,
              kfm_ucf=True):
    """The filter part of the JAX pipeline on its device path: (best logo,
    fade curve, FilterGraph, FilterOutput, output frames)."""
    monkeypatch.setattr(jlogo_model, "_HOST_OPS", False)
    ctx = JContext(level="error")
    best, fade, entries = -1, None, []
    if logos:
        jl = [jax_logo(lg) for lg in logos]
        m = jlogo_model.LogoFrameMatcher(ctx, jl)
        m.scan_frames((f[0] for f in frames), fmt.width, fmt.height,
                      fmt.frame_rate_num / fmt.frame_rate_denom, batch=batch,
                      fade_steps=2 if no_delogo else 11)
        best = m.select_logo()
        fade = m.fade_curve()
        if not no_delogo:
            entries.append((jl[best], fade))
    eraser = JLogoEraser(ctx, entries, fmt.width, fmt.height)

    def filtered():
        return eraser.erase_iter(iter(frames), batch) if eraser \
            else iter(frames)

    fg = JFilterGraph(ctx, mode=mode, batch=batch)
    fg._host_backend = False  # the device path, not the host twins
    fg.quantize_output = True
    fg.kfm_ucf = kfm_ucf
    if mode in JFilterGraph.KFM_FAMILY:
        fg.analyze((p[0] for p in filtered()), len(frames))
    spec = fg.output_spec(len(frames), fmt)
    outs = []

    class Pump:
        put = outs.append

    _pump_filtered(fg, filtered(), Pump(), batch)
    return best, fade, fg, spec, outs


def port_stage(frames, logos, mode, **kw):
    outs = []
    res = run_filter_stage(AMTContext(level="error"), lambda: iter(frames),
                           len(frames), synth_clip.video_format(H, W), logos,
                           mode, outs.append, batch=BATCH, device="cpu", **kw)
    return res, outs


def assert_same_plan(fg, jfg):
    assert ([(int(d.mode), d.phase) for d in fg.decisions]
            == [(int(d.mode), d.phase) for d in jfg.decisions])
    assert fg.vfr_plan.durations == jfg.vfr_plan.durations
    assert fg.vfr_plan.source_frames == jfg.vfr_plan.source_frames


def assert_same_frames(outs, jouts):
    assert len(outs) == len(jouts)
    for k, (got, want) in enumerate(zip(outs, jouts)):
        for p in range(3):
            np.testing.assert_array_equal(got[p], want[p],
                                          err_msg=f"frame {k} plane {p}")


@pytest.fixture(scope="module")
def clip():
    return synth_clip.make_clip(**SPEC)


@pytest.fixture(scope="module")
def logos():
    return synth_clip.make_logos(*(SPEC[k] for k in ("h", "w", "lh", "lw",
                                                      "lx", "ly")))


@pytest.mark.parametrize("mode", ["kfm_vfr", "yadif"])
def test_no_delogo_matches_jax(clip, logos, mode, monkeypatch):
    best, fade, jfg, jspec, jouts = jax_stage(
        clip, jax_format(H, W), logos, mode, BATCH, monkeypatch,
        no_delogo=True)
    res, outs = port_stage(clip, logos, mode, no_delogo=True)
    assert res.matcher.fade_steps == filter_stage.FADE_STEPS_NO_DELOGO == 2
    assert res.best_logo == best == 0
    np.testing.assert_allclose(res.fade, fade, rtol=0, atol=FADE_TOL)
    if mode == "kfm_vfr":
        assert_same_plan(res.graph, jfg)
    assert res.spec.num_out_frames == jspec.num_out_frames
    assert_same_frames(outs, jouts)


def test_no_delogo_erases_nothing(clip, logos):
    """The frames come out as with no logos at all, and differ inside the
    logo's box from the erased run."""
    _, plain = port_stage(clip, [], "yadif")
    res, kept = port_stage(clip, logos, "yadif", no_delogo=True)
    assert res.best_logo == 0 and res.fade is not None
    assert_same_frames(kept, plain)
    _, erased = port_stage(clip, logos, "yadif")
    ys = slice(SPEC["ly"], SPEC["ly"] + SPEC["lh"])
    xs = slice(SPEC["lx"], SPEC["lx"] + SPEC["lw"])
    assert not np.array_equal(erased[-1][0][ys, xs], kept[-1][0][ys, xs])
    outside = np.ones((H, W), bool)  # beyond the reach of yadif's taps
    outside[ys.start - 2:ys.stop + 2, xs.start - 2:xs.stop + 2] = False
    np.testing.assert_array_equal(erased[-1][0][outside],
                                  kept[-1][0][outside])


@pytest.fixture(scope="module")
def dirty_clip():
    # two film frames whose bottom field comes from far away in time
    return synth_clip.make_clip(**SPEC, dirty_frames=(10, 13))


@pytest.fixture(scope="module")
def ucf_plans(dirty_clip):
    return {ucf: port_stage(dirty_clip, [], "kfm_vfr", kfm_ucf=ucf)
            for ucf in (True, False)}


@pytest.mark.parametrize("kfm_ucf", [True, False])
def test_kfm_ucf_matches_jax(dirty_clip, ucf_plans, kfm_ucf, monkeypatch):
    _, _, jfg, jspec, jouts = jax_stage(
        dirty_clip, jax_format(H, W), [], "kfm_vfr", BATCH, monkeypatch,
        kfm_ucf=kfm_ucf)
    res, outs = ucf_plans[kfm_ucf]
    assert res.graph.kfm_ucf is kfm_ucf and jfg.kfm_ucf is kfm_ucf
    assert_same_plan(res.graph, jfg)
    assert res.spec.time_codes == jspec.time_codes
    assert_same_frames(outs, jouts)


def test_kfm_ucf_changes_the_plan(ucf_plans):
    """The dirty frames are bobbed with UCF and woven without: the two
    settings give different plans on this clip, of equal durations."""
    on, off = (ucf_plans[k][0].graph.vfr_plan for k in (True, False))
    assert on.durations == off.durations
    assert on.source_frames != off.source_frames
    changed = [(a, b) for a, b in zip(on.source_frames, off.source_frames)
               if a != b]
    assert {a[0] for a, _ in changed} == {10, 13}
    assert all(a[1] == on.BOB_T and b[1] != on.BOB_T for a, b in changed)


def test_kfm_ucf_defaults_on():
    from amatsukaze_tpu_torch.models.filter_graph import FilterGraph

    assert FilterGraph(AMTContext(), mode="kfm_vfr", device="cpu").kfm_ucf
