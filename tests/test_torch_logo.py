"""The port's logo ops (plain versions, on the CPU) against the JAX package:
batched_evaluate_logo against the jnp path and the Pallas kernel in
interpret mode (rtol 1e-5, atol 1e-5: float32 sums in another order; the
jnp and Pallas outputs themselves differ by ~2e-7), DeintY / DeintLogo /
the erase bit for bit, and the dense operands carried over by
convert.logo_params_from_numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amatsukaze_tpu.models.lgd import LogoData as JLogoData
from amatsukaze_tpu.models.lgd import LogoHeader as JLogoHeader
from amatsukaze_tpu.ops import logo as jlogo
from amatsukaze_tpu.ops import logo_ref as jlogo_ref
from amatsukaze_tpu.ops.logo_pallas import evaluate_logo_pallas
from amatsukaze_tpu_torch import convert
from amatsukaze_tpu_torch.models import lgd as tlgd
from amatsukaze_tpu_torch.ops import logo as tlogo
from amatsukaze_tpu_torch.ops import logo_ref as tlogo_ref
from amatsukaze_tpu_torch.ops.logo_eval import delogo_full_frame, evaluate_logo

LH, LW = 16, 24
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _logo_ab():
    yy, xx = np.mgrid[0:LH, 0:LW]
    r = np.hypot((yy - LH / 2) / (LH / 2), (xx - LW / 2) / (LW / 2))
    alpha = (np.clip(1.2 - r, 0, 1) * 0.35).astype(np.float32)
    a = (1.0 / (1.0 - alpha)).astype(np.float32)
    b = (-alpha * 200.0 / (1.0 - alpha) / 255.0).astype(np.float32)
    return a, b, alpha


@pytest.fixture(scope="module")
def ref():
    a, b, _ = _logo_ab()
    return jlogo_ref.LogoEvalRef(a, b, maskratio=0.1)


@pytest.fixture(scope="module")
def windows():
    """Deinterlaced Y windows: half with the logo painted on."""
    _, _, alpha = _logo_ab()
    rng = np.random.default_rng(5)
    bg = rng.uniform(30, 200, (8, 1, 1)) + rng.normal(0, 3, (8, LH, LW))
    on = (np.arange(8) % 2 == 0)[:, None, None]
    y = np.where(on, (1 - alpha) * bg + alpha * 200.0, bg)
    raw = np.clip(np.rint(y), 0, 255).astype(np.uint8)
    deint = np.array(jlogo.batched_deint_y(jnp.asarray(raw, jnp.float32)))
    return raw, deint


def test_logo_ref_copy_matches(ref):
    """The port's numpy oracle builds the same kernels, scales and mask."""
    a, b, _ = _logo_ab()
    mine = tlogo_ref.LogoEvalRef(a, b, maskratio=0.1)
    for name in ("mask", "kernels", "scales"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    assert mine.black_score == ref.black_score


def test_dense_operands_match(ref):
    j = jlogo.dense_operands_from_ref(ref)
    t = tlogo.dense_operands_from_ref(ref)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


def test_convert_params_layout(ref):
    jp = jlogo.LogoEvalParams.from_ref(ref)
    p = convert.logo_params_from_numpy(jp, device="cpu")
    np.testing.assert_array_equal(p.kernels.numpy(),
                                  np.moveaxis(np.asarray(jp.kernels), -1, 0))
    np.testing.assert_array_equal(p.scale.numpy(),
                                  np.moveaxis(np.asarray(jp.scale), -1, 0))
    np.testing.assert_array_equal(p.scale2.numpy(),
                                  np.moveaxis(np.asarray(jp.scale2), -1, 0))
    for k in ("a_y", "b_y", "mask"):
        np.testing.assert_array_equal(getattr(p, k).numpy(),
                                      np.asarray(getattr(jp, k)))
    assert p.black_score == float(jp.black_score)
    assert p.kernels.is_contiguous() and p.scale.is_contiguous()
    same = tlogo.LogoEvalParams.from_ref(ref, CPU)
    assert torch.equal(same.kernels, p.kernels)


@pytest.mark.parametrize("fade_steps", [2, 11])
def test_evaluate_logo_matches_jax(ref, windows, fade_steps):
    _, deint = windows
    fades = np.linspace(0.0, 1.0, fade_steps).astype(np.float32)
    jp = jlogo.LogoEvalParams.from_ref(ref)
    j = np.asarray(jlogo.batched_evaluate_logo(
        jp, jnp.asarray(deint), jnp.float32(255.0), jnp.asarray(fades)))
    pallas = np.asarray(evaluate_logo_pallas(
        jp, jnp.asarray(deint), jnp.float32(255.0), jnp.asarray(fades),
        interpret=True))
    p = tlogo.LogoEvalParams.from_ref(ref, CPU)
    t = tlogo.batched_evaluate_logo(p, torch.from_numpy(deint), 255.0,
                                    torch.from_numpy(fades)).numpy()
    assert t.shape == (8, fade_steps)
    np.testing.assert_allclose(t, j, **SCORE_TOL)
    np.testing.assert_allclose(t, pallas, **SCORE_TOL)
    # the wrapper takes the plain version for a CPU tensor, uncounted
    before = evaluate_logo.launches
    w = evaluate_logo(p, torch.from_numpy(deint), 255.0,
                      torch.from_numpy(fades)).numpy()
    np.testing.assert_array_equal(w, t)
    assert evaluate_logo.launches == before


def test_evaluate_logo_matches_oracle(ref, windows):
    """Against the numpy oracle of the reference's per-pixel loop."""
    _, deint = windows
    p = tlogo.LogoEvalParams.from_ref(ref, CPU)
    t = tlogo.batched_evaluate_logo(p, torch.from_numpy(deint), 255.0,
                                    torch.tensor([0.0, 1.0])).numpy()
    want = np.array([[ref.evaluate(d, 255.0, f) for f in (0.0, 1.0)]
                     for d in deint], np.float32)
    np.testing.assert_allclose(t, want, rtol=1e-4, atol=1e-4)
    # the logo is present in the even frames and erased away at fade 1
    assert (t[0::2, 0] > 0.2).all() and (np.abs(t[0::2, 1]) < 0.2).all()


def test_deint_y_and_logo_bit_equal(windows):
    raw, deint = windows
    t = tlogo.batched_deint_y(torch.from_numpy(raw).float()).numpy()
    np.testing.assert_array_equal(t, deint)
    a, _, _ = _logo_ab()
    np.testing.assert_array_equal(
        tlogo.batched_deint_logo(torch.from_numpy(a)).numpy(),
        np.asarray(jlogo.batched_deint_logo(jnp.asarray(a))))


def test_delogo_bit_equal():
    """The erase equals the JAX one bit for bit on logo-sized batches, and
    the numpy oracle (the reference's separately rounded float code)
    everywhere. On the CPU, XLA contracts the erase's multiply-adds into
    FMAs; the port rounds each operation as the oracle does, so on large
    inputs the two may differ by one level where the exact value sits
    within a rounding of a half-integer."""
    a, b, _ = _logo_ab()
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (8, LH, LW)).astype(np.float32)
    fades = np.concatenate([[0.0, 1.0], rng.uniform(0, 1, 6)]).astype(
        np.float32)
    j = np.asarray(jlogo.batched_delogo(jnp.asarray(x), jnp.asarray(a),
                                        jnp.asarray(b), jnp.float32(255.0),
                                        jnp.asarray(fades)))
    t = delogo_full_frame(torch.from_numpy(x), torch.from_numpy(a),
                          torch.from_numpy(b), 255.0,
                          torch.from_numpy(fades)).numpy()
    np.testing.assert_array_equal(t, j)
    oracle = np.stack([np.floor(jlogo_ref.delogo(
        x[i], a, b, 255.0, fades[i], dtype=np.float32)) for i in range(8)])
    np.testing.assert_array_equal(t, oracle)


def test_delogo_differs_from_xla_only_at_rounding_ties():
    rng = np.random.default_rng(1)
    n, h, w = 16, 96, 256
    a = rng.uniform(1.0, 1.6, (h, w)).astype(np.float32)
    b = rng.uniform(-0.5, 0.0, (h, w)).astype(np.float32)
    x = rng.integers(0, 256, (n, h, w)).astype(np.float32)
    fades = rng.uniform(0, 1, n).astype(np.float32)
    j = np.asarray(jlogo.batched_delogo(jnp.asarray(x), jnp.asarray(a),
                                        jnp.asarray(b), jnp.float32(255.0),
                                        jnp.asarray(fades)))
    t = tlogo.batched_delogo(torch.from_numpy(x), torch.from_numpy(a),
                             torch.from_numpy(b), 255.0,
                             torch.from_numpy(fades)).numpy()
    diff = np.argwhere(t != j)
    assert len(diff) <= 1e-5 * t.size
    exact = (fades[:, None, None].astype(np.float64)
             * (a.astype(np.float64) * x + b.astype(np.float64) * 255.0)
             + (1.0 - fades[:, None, None].astype(np.float64)) * x)
    for i, y, xx in diff:
        assert abs(t[i, y, xx] - j[i, y, xx]) == 1.0
        frac = exact[i, y, xx] + 0.5 - np.floor(exact[i, y, xx] + 0.5)
        assert min(frac, 1.0 - frac) < 1e-4  # a half-integer tie


def test_logo_data_round_trip(tmp_path):
    """convert.logo_data_from_numpy carries a JAX LogoData across, and the
    port's .lgd writer produces the JAX package's bytes."""
    a, b, _ = _logo_ab()
    header = JLogoHeader(LW, LH, 1, 1, 96, 64, 8, 8, "logo", 7)
    jl = JLogoData.create(header)
    jl.a_y, jl.b_y = a, b
    tl = convert.logo_data_from_numpy(jl)
    assert tl.header == tlgd.LogoHeader(LW, LH, 1, 1, 96, 64, 8, 8, "logo", 7)
    from amatsukaze_tpu.models.lgd import save_lgd as jsave

    jsave(str(tmp_path / "j.lgd"), jl)
    tlgd.save_lgd(str(tmp_path / "t.lgd"), tl)
    assert (tmp_path / "j.lgd").read_bytes() == (tmp_path / "t.lgd").read_bytes()
    back = tlgd.load_lgd(str(tmp_path / "t.lgd"))
    np.testing.assert_array_equal(back.a_y, a)
    np.testing.assert_array_equal(back.b_v, jl.b_v)
