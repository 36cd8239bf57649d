"""Logo generation (models.logo.LogoAnalyzer and its ops) and the .lgd
preview (models.logo_render) on the CPU, against the JAX package.

The regression sums (ops.logo.logo_sums_update) are bit-equal to the JAX
package's: 8-bit frames and integer background levels keep them exact.
border_flat_background, the edge cleanup's distance and max filter are
copies, equal on the same input. LogoAnalyzer as the JAX package's
TestAnalyzer holds it (the three passes recover the logo's A and B on its
core; the saved .lgd loads), and further: on the same frames the port keeps
the same frames, picks the same best fade for every one of them in both
refinement passes and solves the same A and B, bit for bit; the .lgd it
writes is the JAX package's byte for byte and its load_lgd reads it. The
preview as TestLogoRender.

The record (testdata/golden_logo.npz, the 96x128 logo scan clip of
utils.synth_clip): each pass's best fades and the final A/B planes from
the JAX package, held by utils.golden.assert_logo_matches (selections
identical, A and B within LOGO_AB_TOL).

    python tests/test_torch_logo_gen.py --write

rewrites it from the JAX package and checks the port against it.
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # for the script run
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
import amatsukaze_tpu.models.logo as jlogo  # noqa: E402
from amatsukaze_tpu.models import lgd as jlgd  # noqa: E402
from amatsukaze_tpu.ops import logo as jops  # noqa: E402
from amatsukaze_tpu.utils.context import AMTContext as JContext  # noqa: E402
from test_models_logo import (IMGH, IMGW, LH, LW,  # noqa: E402
                              frame_with_logo, synth_logo_ab)

from amatsukaze_tpu_torch.models import lgd, logo  # noqa: E402
from amatsukaze_tpu_torch.models import logo_render  # noqa: E402
from amatsukaze_tpu_torch.ops import logo as ops  # noqa: E402
from amatsukaze_tpu_torch.types import VideoFormat  # noqa: E402
from amatsukaze_tpu_torch.utils import golden, synth_clip  # noqa: E402
from amatsukaze_tpu_torch.utils.context import AMTContext  # noqa: E402


@pytest.fixture(autouse=True)
def _jax_device_ops(monkeypatch):
    """The JAX package's device path, not its slow-link host twins."""
    monkeypatch.setattr(jlogo, "_HOST_OPS", False)


def _planes(logo_data):
    return {k: getattr(logo_data, k) for k in golden.LOGO_PLANES}


def jax_analyze(frames, region, imgw, imgh):
    """The JAX LogoAnalyzer over a list of (Y, U, V) frames, and each
    refinement pass's best fades (its `_deint_eval` scores, argmin of |.|
    as _remake takes it)."""
    best = []
    orig = jlogo._deint_eval

    def spy(params, chunk, fades):
        s = orig(params, chunk, fades)
        best.append(np.abs(s).argmin(axis=1).astype(np.int32))
        return s

    jlogo._deint_eval = spy
    try:
        an = jlogo.LogoAnalyzer(JContext(level="error"),
                                jlogo.ScanRegion(*region), thy=12, batch=64)
        an.scan(iter(frames), imgw, imgh, name="recovered", service_id=5)
    finally:
        jlogo._deint_eval = orig
    n = len(an.frames_y)
    all_best = np.concatenate(best)
    an.min_fades = [all_best[:n], all_best[n:2 * n]]
    return an


def port_analyze(frames, region, imgw, imgh):
    an = logo.LogoAnalyzer(AMTContext(level="error"),
                           logo.ScanRegion(*region), thy=12, batch=64,
                           device="cpu")
    an.scan(iter(frames), imgw, imgh, name="recovered", service_id=5)
    return an


@pytest.fixture(scope="module")
def recovery():
    """300 frames of test_models_logo's three-pass recovery test, the logo
    on in 80% of them; both analyzers over the same frames."""
    _, _, alpha = synth_logo_ab()
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(300):
        bg = float(rng.uniform(30, 140))
        on = rng.random() < 0.8
        frames.append(frame_with_logo(bg, alpha, on=on))
    region = (8, 8, LW, LH)
    return (port_analyze(frames, region, IMGW, IMGH),
            jax_analyze(frames, region, IMGW, IMGH))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_field_fades_matches_jax():
    t = np.array([0.0, 0.3, 1.0], np.float32)
    b = np.array([0.5, 0.7, 0.1], np.float32)
    np.testing.assert_array_equal(
        ops.field_fades(torch.from_numpy(t), torch.from_numpy(b), 7).numpy(),
        np.asarray(jops.field_fades(jnp.asarray(t), jnp.asarray(b), 7)))


def test_logo_sums_update_matches_jax():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (256, 6, 10)).astype(np.float32)
    frames[:, 0, 0] = 255.0  # the largest sums: exact below 2^24
    bgs = rng.integers(0, 256, 256).astype(np.float32)
    start = rng.integers(0, 99, (5, 6, 10)).astype(np.float32)
    got = ops.logo_sums_update(torch.from_numpy(start),
                               torch.from_numpy(frames),
                               torch.from_numpy(bgs)).numpy()
    want = np.asarray(jops.logo_sums_update(
        jnp.asarray(start), jnp.asarray(frames), jnp.asarray(bgs)))
    np.testing.assert_array_equal(got, want)
    exact = ops.logo_sums_update(torch.from_numpy(start).double(),
                                 torch.from_numpy(frames),
                                 torch.from_numpy(bgs)).numpy()
    np.testing.assert_array_equal(got, exact)


def test_logo_ab_from_sums_matches_jax():
    rng = np.random.default_rng(4)
    f = rng.integers(0, 256, (40, 5, 7)).astype(np.float32) / 255.0
    b = rng.integers(0, 256, 40).astype(np.float32) / 255.0
    f[:, 0, 0] = 0.5  # a pixel that never changes: degenerate
    sums = ops.logo_sums_update(torch.zeros((5, 5, 7)), torch.from_numpy(f),
                                torch.from_numpy(b))
    got = ops.logo_ab_from_sums(sums, 40.0)
    want = jops.logo_ab_from_sums(jnp.asarray(sums.numpy()), 40.0)
    # float32 closed form: its differences cancel (t1 = n sum_f2 - sum_f^2)
    # and XLA fuses its products into FMAs, so the last bits move: 1e-4
    valid = got[2].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want[2]))
    assert not valid[0, 0] and valid[1:].all()
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid],
                                   rtol=1e-4)


def test_border_test_distance_and_max_filter_match_jax():
    rng = np.random.default_rng(5)
    for trial in range(20):
        lo = int(rng.integers(0, 240))
        span = int(rng.integers(0, 20))
        y = rng.integers(lo, lo + span + 1, (12, 20)).astype(np.uint8)
        u = rng.integers(120, 126, (6, 10)).astype(np.uint8)
        assert logo.border_flat_background(y, u, u, 12) == \
            jlogo.border_flat_background(y, u, u, 12)
    a = rng.uniform(0.8, 1.2, (9, 13))
    bb = rng.uniform(-0.1, 0.1, (9, 13))
    d = logo._calc_dist(a, bb)
    np.testing.assert_array_equal(d, jlogo._calc_dist(a, bb))
    np.testing.assert_array_equal(logo._maxfilter_3x3_plus(d),
                                  jlogo._maxfilter_3x3_plus(d))


# ---------------------------------------------------------------------------
# LogoAnalyzer
# ---------------------------------------------------------------------------

def test_three_pass_recovery(recovery):
    an, jan = recovery
    a_true, b_true, alpha = synth_logo_ab()
    core = alpha > 0.15
    got = an.logodata
    np.testing.assert_allclose(got.a_y[core], a_true[core], atol=0.08)
    np.testing.assert_allclose(got.b_y[core], b_true[core], atol=0.04)
    assert len(an.frames_y) == len(jan.frames_y) == 300
    for mine, theirs in zip(an.min_fades, jan.min_fades):
        np.testing.assert_array_equal(mine, theirs)
    for k, v in _planes(got).items():
        np.testing.assert_array_equal(v, getattr(jan.logodata, k), err_msg=k)


def test_save_is_the_jax_packages_lgd(recovery, tmp_path):
    an, jan = recovery
    path, jpath = tmp_path / "port.lgd", tmp_path / "jax.lgd"
    an.save(str(path))
    jan.save(str(jpath))
    assert path.read_bytes() == jpath.read_bytes()
    back = jlgd.load_lgd(str(path))
    assert (back.header.imgw, back.header.imgh) == (IMGW, IMGH)
    assert back.header.name == "recovered" and back.header.service_id == 5
    mine = lgd.load_lgd(str(path))
    for k in golden.LOGO_PLANES:
        np.testing.assert_array_equal(getattr(mine, k), getattr(back, k))


def test_busy_or_too_few_frames_raise():
    _, _, alpha = synth_logo_ab()
    y, u, v = frame_with_logo(90.0, alpha)
    busy = y.copy()
    busy[8, 8:8 + LW] = np.arange(LW) * 9  # the region's top border
    frames = [(busy, u, v)] * 5 + [(y, u, v)]
    an = logo.LogoAnalyzer(AMTContext(level="error"),
                           logo.ScanRegion(8, 8, LW, LH), device="cpu")
    with pytest.raises(RuntimeError, match="insufficient logo frames"):
        an.scan(iter(frames), IMGW, IMGH)
    assert len(an.frames_y) == 1


# ---------------------------------------------------------------------------
# the recorded 96x128 scan clip
# ---------------------------------------------------------------------------

def scan_clip_frames():
    open_frames, n, fmt, region, truth = synth_clip.logo_scan_clip(
        golden.LOGO_CLIP)
    return list(open_frames()), fmt, region, truth


def test_analyzer_matches_the_record():
    frames, fmt, region, truth = scan_clip_frames()
    an = port_analyze(frames, region, fmt.width, fmt.height)
    assert golden.assert_logo_matches(golden.logo_record(an),
                                      golden.load_logo(), "port") == 0
    core = truth["alpha"] > 0.15
    assert np.abs(an.logodata.a_y - truth["a_y"])[core].max() < 0.08
    assert np.abs(an.logodata.b_y - truth["b_y"])[core].max() < 0.04


# ---------------------------------------------------------------------------
# models.logo_render
# ---------------------------------------------------------------------------

def _make_lgd(tmp_path):
    header = lgd.LogoHeader(16, 8, 1, 1, 1440, 1080, 100, 60, "renderme", 7)
    lg = lgd.LogoData.create(header)
    lg.a_y[:] = 1.0
    lg.b_y[:] = 0.0
    lg.a_y[2:6, 4:12] = 0.8
    lg.b_y[2:6, 4:12] = -0.1
    lg.a_u[:] = 1.0
    lg.a_v[:] = 1.0
    path = str(tmp_path / "r.lgd")
    lgd.save_lgd(path, lg)
    return path


def test_render_and_rename(tmp_path):
    from amatsukaze_tpu.models.logo_render import GUILogoFile as JGUILogoFile

    path = _make_lgd(tmp_path)
    g = logo_render.GUILogoFile(path)
    assert (g.width, g.height) == (16, 8)
    assert g.name == "renderme"
    rgb = g.render(bg=128)
    assert rgb.shape == (8, 16, 3)
    assert rgb[3, 8, 0] != rgb[0, 0, 0]  # the logo shows on the background
    np.testing.assert_array_equal(rgb, JGUILogoFile(path).render(bg=128))
    g.set_name("renamed")
    g.save()
    assert logo_render.GUILogoFile(path).name == "renamed"
    assert JGUILogoFile(path).name == "renamed"


def test_compose_inverts_erase():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.7, 1.0, (4, 4)).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, (4, 4)).astype(np.float32)
    observed = logo_render.compose_logo_plane(a, b, 128.0)
    np.testing.assert_allclose(a * observed + b * 255.0, 128.0, atol=1e-3)


def test_frame_extractor():
    def decoder(path):
        def frames():
            for i in range(30):
                y = np.full((8, 16), 16 + i * 5, np.uint8)
                u = np.full((4, 8), 128, np.uint8)
                yield y, u, u

        return VideoFormat(width=16, height=8), frames(), []

    ex = logo_render.MediaFrameExtractor("x", decoder)
    f0 = ex.get_frame(0.0, approx_total=30)
    f1 = ex.get_frame(0.5, approx_total=30)
    assert f0.shape == (8, 16, 3)
    assert f1[0, 0, 0] > f0[0, 0, 0]  # later frame is brighter


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate testdata/golden_logo.npz")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do without --write")
    jlogo._HOST_OPS = False  # the device path
    frames, fmt, region, _ = scan_clip_frames()
    record = golden.logo_record(jax_analyze(frames, region, fmt.width,
                                            fmt.height))
    moved = golden.assert_logo_matches(
        golden.logo_record(port_analyze(frames, region, fmt.width,
                                        fmt.height)), record, "port")
    golden.save_logo(record)
    print(f"wrote {golden.LOGO_PATH}: {int(record['kept'])} frames kept, "
          f"{[int((record[f'min_fades_{i}'] > 8).sum()) for i in range(2)]} "
          f"selected; the port's best fades differ on {moved}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
