"""The whole slice on the CPU: the JAX chain (LogoFrameMatcher -> fade
curve -> LogoEraser -> FilterGraph analysis -> _pump_filtered, forced onto
its device path) against the port's pipeline.filter_stage, on a 3:2
telecined clip followed by interlaced video, with a rendered logo, Y/U/V. The selected logo, the cycle
decisions and the VFR plan must be identical, the fade curve within 1e-5
and every output plane bit-equal."""

import numpy as np
import pytest
import torch

import amatsukaze_tpu.models.logo as jlogo_model
from amatsukaze_tpu.models.filter_graph import FilterGraph as JFilterGraph
from amatsukaze_tpu.models.lgd import LogoData as JLogoData
from amatsukaze_tpu.models.lgd import LogoHeader as JLogoHeader
from amatsukaze_tpu.models.logo_erase import LogoEraser as JLogoEraser
from amatsukaze_tpu.pipeline.transcode import _pump_filtered
from amatsukaze_tpu.types import VideoFormat as JVideoFormat
from amatsukaze_tpu.utils.context import AMTContext as JContext
from amatsukaze_tpu_torch import convert
from amatsukaze_tpu_torch.models.filter_graph import FilterGraph, normalize_u8
from amatsukaze_tpu_torch.models.logo_erase import LogoEraser
from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
from amatsukaze_tpu_torch.types import VideoFormat
from amatsukaze_tpu_torch.utils.context import AMTContext

H, W = 64, 96
LH, LW = 16, 24
LX, LY = 56, 8  # logo origin (even, so chroma lands on whole pixels)
BATCH, FPS = 8, 30


def _alpha(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot((yy - h / 2) / (h / 2), (xx - w / 2) / (w / 2))
    return (np.clip(1.0 - 1.45 * r, 0, 1) * 0.35).astype(np.float32)


def _ab(alpha, color):
    a = (1.0 / (1.0 - alpha)).astype(np.float32)
    b = (-alpha * color / (1.0 - alpha) / 255.0).astype(np.float32)
    return a, b


def _jax_logos():
    header = JLogoHeader(LW, LH, 1, 1, W, H, LX, LY, "L0", 1)
    logo = JLogoData.create(header)
    logo.a_y, logo.b_y = _ab(_alpha(LH, LW), 200.0)
    logo.a_u, logo.b_u = _ab(_alpha(LH // 2, LW // 2), 90.0)
    logo.a_v, logo.b_v = _ab(_alpha(LH // 2, LW // 2), 170.0)
    decoy = JLogoData.create(header)
    decoy.a_y = np.full((LH, LW), 1.3, np.float32)
    decoy.b_y = np.full((LH, LW), -0.2, np.float32)
    return [logo, decoy]


def _clip(n_film=30, n_video=15, pan=6):
    """A hard-telecined 3:2 stream from a panning film source, then true
    interlaced video (every field its own instant), all three planes, with
    the logo painted on from frame 6 on."""
    def film_plane(i, h, w, period, amp, base):
        yy, xx = np.mgrid[0:h, 0:w]
        return np.clip(base + amp * np.sin((xx + pan * i) / period)
                       * np.cos(yy / 9.0), 0, 255)

    geoms = ((H, W, 7.0, 80, 120), (H // 2, W // 2, 5.0, 30, 128),
             (H // 2, W // 2, 6.0, 30, 128))
    film = [tuple(film_plane(i, *g) for g in geoms)
            for i in range((n_film * 4) // 5 + 4)]

    def weave(top, bot):
        f = np.empty_like(top)
        f[0::2] = top[0::2]
        f[1::2] = bot[1::2]
        return f

    rng = np.random.default_rng(2)
    frames = []
    i = 0
    while len(frames) < n_film:
        a, b, c, d = film[i:i + 4]
        for pair in ((a, a), (a, b), (b, c), (c, c), (d, d)):
            if len(frames) < n_film:
                frames.append([weave(p, q) for p, q in zip(*pair)])
        i += 4
    for k in range(n_video):
        t0 = i + 2.5 * k  # fields 1.25 film frames apart: heavy combing
        frames.append([weave(film_plane(t0, *g), film_plane(t0 + 1.25, *g))
                       for g in geoms])
    out = []
    for k, planes in enumerate(frames):
        if k >= 6:
            for p, (scale, color) in enumerate(((1, 200.0), (2, 90.0),
                                                (2, 170.0))):
                al = _alpha(LH // scale, LW // scale)
                y0, x0 = LY // scale, LX // scale
                win = planes[p][y0:y0 + al.shape[0], x0:x0 + al.shape[1]]
                win[...] = (1 - al) * win + al * color
        out.append(tuple(np.clip(np.rint(p + rng.normal(0, 0.6, p.shape)),
                                 0, 255).astype(np.uint8) for p in planes))
    return out


def _fmt(cls):
    f = cls()
    f.width, f.height = W, H
    f.frame_rate_num, f.frame_rate_denom = 30000, 1001
    return f


def _jax_chain(frames, mode, monkeypatch):
    monkeypatch.setattr(jlogo_model, "_HOST_OPS", False)  # device path
    ctx = JContext(level="error")
    logos = _jax_logos()
    m = jlogo_model.LogoFrameMatcher(ctx, logos)
    m.scan_frames((f[0] for f in frames), W, H, FPS, batch=BATCH,
                  fade_steps=11)
    best = m.select_logo()
    fade = m.fade_curve()
    eraser = JLogoEraser(ctx, [(logos[best], fade)], W, H)
    fg = JFilterGraph(ctx, mode=mode, batch=BATCH)
    fg._host_backend = False  # the device path, not the host twins
    fg.quantize_output = True
    if mode in JFilterGraph.KFM_FAMILY:
        fg.analyze((p[0] for p in eraser.erase_iter(iter(frames), BATCH)),
                   len(frames))
    spec = fg.output_spec(len(frames), _fmt(JVideoFormat))
    outs = []

    class Pump:
        put = outs.append

    _pump_filtered(fg, eraser.erase_iter(iter(frames), BATCH), Pump(), BATCH)
    return best, fade, fg, spec, outs


def _port_chain(frames, mode):
    logos = [convert.logo_data_from_numpy(lg) for lg in _jax_logos()]
    outs = []
    res = run_filter_stage(AMTContext(level="error"), lambda: iter(frames),
                           len(frames), _fmt(VideoFormat), logos, mode,
                           outs.append, batch=BATCH, device="cpu")
    return res, outs


@pytest.fixture(scope="module")
def clip():
    return _clip()


@pytest.mark.parametrize("mode", ["kfm_vfr", "kfm_cfr24", "yadif"])
def test_slice_matches_jax(clip, mode, monkeypatch):
    best, fade, jfg, jspec, jouts = _jax_chain(clip, mode, monkeypatch)
    res, outs = _port_chain(clip, mode)
    assert res.best_logo == best == 0
    np.testing.assert_allclose(res.fade, fade, atol=1e-5)
    assert fade[:4].max() < 0.5 and fade[-10:].min() > 0.5  # logo erased
    if mode == "yadif":
        assert jfg.decisions is None and res.graph.decisions is None
    else:
        assert ([(d.mode, d.phase) for d in res.graph.decisions]
                == [(d.mode, d.phase) for d in jfg.decisions])
        assert res.graph.vfr_plan.durations == jfg.vfr_plan.durations
        assert (res.graph.vfr_plan.source_frames
                == jfg.vfr_plan.source_frames)
        # film cycles decimate, interlaced cycles bob to 60p
        assert len(outs) != len(clip)
        if mode == "kfm_vfr":
            assert {op for _, op in jfg.vfr_plan.source_frames} == {0, 1, 2, 3}
    assert res.spec.num_out_frames == jspec.num_out_frames == len(outs)
    assert res.spec.time_codes == jspec.time_codes
    assert (res.spec.out_format.frame_rate_num,
            res.spec.out_format.frame_rate_denom) == (
        jspec.out_format.frame_rate_num, jspec.out_format.frame_rate_denom)
    assert res.num_out_frames == len(outs) == len(jouts)
    for k, (got, want) in enumerate(zip(outs, jouts)):
        for p in range(3):
            assert got[p].dtype == np.uint8
            np.testing.assert_array_equal(got[p], want[p],
                                          err_msg=f"frame {k} plane {p}")


def test_batching_does_not_change_output(clip):
    """Outputs are per-frame functions of their halo: another batch size
    gives the same frames."""
    a_res, a = _port_chain(clip, "kfm_vfr")
    logos = [convert.logo_data_from_numpy(lg) for lg in _jax_logos()]
    b = []
    run_filter_stage(AMTContext(level="error"), lambda: iter(clip),
                     len(clip), _fmt(VideoFormat), logos, "kfm_vfr",
                     b.append, batch=13, device="cpu")
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert all(np.array_equal(p, q) for p, q in zip(x, y))


def test_mode_none_passes_frames_through(clip):
    outs = []
    res = run_filter_stage(AMTContext(level="error"), lambda: iter(clip[:12]),
                           12, _fmt(VideoFormat), [], "none", outs.append,
                           batch=5, device="cpu")
    assert res.best_logo == -1 and res.num_out_frames == 12
    for got, want in zip(outs, clip[:12]):
        assert all(np.array_equal(p, q) for p, q in zip(got, want))


@pytest.mark.parametrize("mode", ["yadif60", "qtgmc", "svp", "autovfr"])
def test_unported_modes_raise(mode):
    with pytest.raises(NotImplementedError):
        FilterGraph(AMTContext(), mode=mode, device="cpu")


def test_unknown_mode_and_short_clip():
    with pytest.raises(ValueError):
        FilterGraph(AMTContext(), mode="bogus", device="cpu")
    fg = FilterGraph(AMTContext(), mode="kfm_vfr", batch=4, device="cpu")
    fg.analyze(iter([np.zeros((8, 8), np.uint8)] * 3), 3)
    assert fg.mode == "none" and fg.vfr_plan is None


def test_eraser_matches_jax(clip):
    logo = _jax_logos()[0]
    fades = np.linspace(0, 1, len(clip)).astype(np.float32)
    j = list(JLogoEraser(JContext(level="error"), [(logo, fades)], W, H)
             .erase_iter(iter(clip), BATCH))
    t = list(LogoEraser(AMTContext(), [(convert.logo_data_from_numpy(logo),
                                        fades)], W, H, device="cpu")
             .erase_iter(iter(clip), BATCH))
    assert len(j) == len(t) == len(clip)
    for x, y in zip(j, t):
        assert all(np.array_equal(p, q) for p, q in zip(x, y))


def test_zone_and_format_conversion_match_jax():
    from amatsukaze_tpu.models.cm_analyze import EncoderZone as JZone
    from amatsukaze_tpu.models.filter_graph import (
        make_out_format as j_format, make_out_zones as j_zones)
    from amatsukaze_tpu_torch.models.filter_graph import (
        make_out_format, make_out_zones)
    from amatsukaze_tpu_torch.models.vfr import EncoderZone

    frames = list(range(0, 400, 2))
    spans = [(10, 90), (100, 130), (150, 390)]
    tcs = [i * 41.7 for i in range(170)]
    for codes, n_out in ((tcs, 169), ([], 150), ([], 200)):
        got = make_out_zones([EncoderZone(*z) for z in spans], frames, n_out,
                             codes, 30000, 1001)
        want = j_zones([JZone(*z) for z in spans], frames, n_out, codes,
                       30000, 1001)
        assert [(z.start_frame, z.end_frame) for z in got] == \
            [(z.start_frame, z.end_frame) for z in want]
    got = make_out_format(_fmt(VideoFormat), 1280, 720, 24000, 1001, True)
    want = j_format(_fmt(JVideoFormat), 1280, 720, 24000, 1001, True)
    for k in ("width", "height", "sar_width", "sar_height",
              "frame_rate_num", "frame_rate_denom", "progressive"):
        assert getattr(got, k) == getattr(want, k)


def test_normalize_u8():
    assert normalize_u8(np.array([1023], np.uint16))[0] == 255
    assert normalize_u8(np.array([2.5, 3.5], np.float32)).tolist() == [2, 4]


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the request is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FilterGraph(AMTContext(), mode="yadif")
