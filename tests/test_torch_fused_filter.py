"""The port's yadif_fieldmatch (plain version, on the CPU) against the JAX
package: both Pallas kernels in interpret mode (frame layout, field layout
with its costs_only / with_costs / logo_box modes) and the jnp chain of
ops.deint. Filtered frames must be bit-equal; costs agree to the JAX
package's own tolerance (rtol 1e-5, atol 1e-4: float32 sums in another
order against the port's exact integer sums)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amatsukaze_tpu.ops import deint as jdeint
from amatsukaze_tpu.ops.fused_filter import (
    make_fused_filter,
    make_fused_filter_field,
    pad_width_for_fused,
)
from amatsukaze_tpu.ops.logo_pallas import pad_logo_planes
from amatsukaze_tpu_torch.ops import deint as tdeint
from amatsukaze_tpu_torch.ops.fused_filter import (
    EraseBox,
    mode_name,
    yadif_fieldmatch,
    yadif_fieldmatch_plain,
)

B, H, W = 4, 32, 128  # stored geometry of the JAX kernels
COST_TOL = dict(rtol=1e-5, atol=1e-4)

# (logical height, logical width): aligned, the 1440-in-1536 case, the
# 540-row chroma case (not 8-aligned), both
GEOMETRIES = [(32, 128), (32, 100), (20, 128), (26, 100)]


def _frames(b=B, h=H, w=W, seed=11):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w),
                                                dtype=np.uint8)


def _logo(bh=8, bw=16):
    yy, xx = np.mgrid[0:bh, 0:bw]
    alpha = (np.clip(1.0 - np.hypot((yy - bh / 2) / (bh / 2),
                                    (xx - bw / 2) / (bw / 2)), 0, 1)
             * 0.3).astype(np.float32)
    a = (1.0 / (1.0 - alpha)).astype(np.float32)
    b = (-alpha * 200.0 / (1.0 - alpha) / 255.0).astype(np.float32)
    return a, b


def _port(frames_u8, **kw):
    out, costs = yadif_fieldmatch(torch.from_numpy(frames_u8), **kw)
    return (None if out is None else out.numpy(),
            None if costs is None else costs.numpy())


@pytest.mark.parametrize("with_costs", [True, False])
@pytest.mark.parametrize("lh,lw", GEOMETRIES)
def test_frame_layout_kernel(lh, lw, with_costs):
    """make_fused_filter(...).yadif_costs over edge-padded frames vs the
    port on a strided view of the logical frames (row stride = stored
    width, as a padded buffer would be read)."""
    frames = _frames()[:, :lh, :lw]
    fp, _, _ = pad_width_for_fused(jnp.asarray(frames),
                                   jnp.ones((lh, lw), jnp.float32),
                                   jnp.zeros((lh, lw), jnp.float32), W, H)
    fused = make_fused_filter(H, W, tile_rows=16, logical_width=lw,
                              logical_height=lh, with_costs=with_costs)
    j_out, j_costs = fused.yadif_costs(fp, jnp.float32(255.0),
                                       interpret=True)
    view = torch.from_numpy(np.array(fp))[:, :lh, :lw]
    assert view.stride(1) == W
    out, costs = yadif_fieldmatch(view, with_costs=with_costs)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(j_out)[:, :lh, :lw])
    if with_costs:
        np.testing.assert_allclose(costs.numpy(), np.asarray(j_costs),
                                   **COST_TOL)
    else:
        assert costs is None and j_costs is None


def test_frame_layout_kernel_with_erase():
    """fused(): XLA logo erase (pass 1) + yadif + costs vs the port's
    erase-on-load box."""
    frames = _frames()
    a, b = _logo()
    y0, x0 = 2, 4
    a_full, b_full = pad_logo_planes(a, b, H, W, x0, y0)
    fades = np.random.default_rng(3).uniform(0, 1, B).astype(np.float32)
    fused = make_fused_filter(H, W, tile_rows=16)
    j_out, j_costs = fused(jnp.asarray(frames), jnp.asarray(a_full),
                           jnp.asarray(b_full), jnp.asarray(fades),
                           jnp.float32(255.0), interpret=True)
    box = EraseBox(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(fades), y0, x0)
    out, costs = _port(frames, with_costs=True, erase=box)
    np.testing.assert_array_equal(out, np.asarray(j_out))
    np.testing.assert_allclose(costs, np.asarray(j_costs), **COST_TOL)


@pytest.mark.parametrize("variant", ["costs_only", "with_costs", "yadif"])
@pytest.mark.parametrize("h,lh,lw,ftile", [
    (64, 64, 128, 16),   # aligned
    (64, 64, 96, 16),    # logical width below the stored width
    (48, 40, 128, 24),   # logical height, odd field tiles
])
def test_field_layout_kernel(variant, h, lh, lw, ftile):
    frames = _frames(b=6, h=h, w=lw, seed=42)
    fp, _, _ = pad_width_for_fused(jnp.asarray(frames),
                                   jnp.ones((h, lw), jnp.float32),
                                   jnp.zeros((h, lw), jnp.float32), 128, h)
    kernel = make_fused_filter_field(
        h, 128, field_tile_rows=ftile, logical_width=lw, logical_height=lh,
        with_costs=variant != "yadif", costs_only=variant == "costs_only")
    j_out, j_costs = kernel(fp, jnp.float32(255.0), interpret=True)
    out, costs = _port(frames[:, :lh], write_frames=variant != "costs_only",
                       with_costs=variant != "yadif")
    if variant == "costs_only":
        assert out is None  # the port writes no frame output at all
    else:
        np.testing.assert_array_equal(out, np.asarray(j_out)[:, :lh, :lw])
    if variant == "yadif":
        assert costs is None and j_costs is None
    else:
        np.testing.assert_allclose(costs, np.asarray(j_costs), **COST_TOL)


@pytest.mark.parametrize("box", [
    (0, 0, 20, 40),      # top-left corner (broadcast logo position)
    (10, 30, 17, 33),    # odd origin/size
    (34, 100, 30, 40),   # crosses the Pallas field-tile boundary
])
def test_field_layout_logo_box(box):
    """fused_logo (box erase + in-kernel overlay + yadif + costs) vs the
    port's erase-on-load box."""
    h, w, wp = 64, 140, 256
    y0, x0, bh, bw = box
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (5, h, w), dtype=np.uint8)
    alpha = np.clip(rng.uniform(0, 0.4, (bh, bw)), 0.01, 0.4).astype(
        np.float32)
    a = (1.0 / (1.0 - alpha)).astype(np.float32)
    b = (-alpha * 200.0 / (1.0 - alpha) / 255.0).astype(np.float32)
    a_full, b_full = pad_logo_planes(a, b, h, w, x0, y0)
    fades = rng.uniform(0, 1, (5,)).astype(np.float32)
    fp, ap, bp = pad_width_for_fused(jnp.asarray(frames),
                                     jnp.asarray(a_full),
                                     jnp.asarray(b_full), wp)
    fl = make_fused_filter_field(h, wp, field_tile_rows=16, logical_width=w,
                                 logo_box=box)
    wy0, wx0, wh, ww = fl.window
    j_out, j_costs = fl(fp, np.asarray(ap)[wy0:wy0 + wh, wx0:wx0 + ww],
                        np.asarray(bp)[wy0:wy0 + wh, wx0:wx0 + ww],
                        jnp.asarray(fades), jnp.float32(255.0),
                        interpret=True)
    erase = EraseBox(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(fades), y0, x0)
    out, costs = _port(frames, with_costs=True, erase=erase)
    np.testing.assert_array_equal(out, np.asarray(j_out)[:, :, :w])
    np.testing.assert_allclose(costs, np.asarray(j_costs), **COST_TOL)


@pytest.mark.parametrize("b", [1, 2, 5])
def test_against_jnp_chain(b):
    """Any batch size, against ops.deint's yadif + field_match_costs with
    the sequence-edge replication of the JAX filter graph."""
    frames = _frames(b=b, h=26, w=36, seed=b)
    x = jnp.asarray(frames.astype(np.float32))
    prev = jnp.concatenate([x[:1], x[:-1]])
    nxt = jnp.concatenate([x[1:], x[-1:]])
    j_out = np.asarray(jnp.clip(jnp.floor(
        jdeint.yadif_deinterlace(prev, x, nxt, True) + 0.5), 0, 255))
    j_costs = np.asarray(jdeint.field_match_costs(x))
    out, costs = _port(frames, with_costs=True)
    np.testing.assert_array_equal(out, j_out.astype(np.uint8))
    np.testing.assert_allclose(costs, j_costs, **COST_TOL)


@pytest.mark.parametrize("parity_top", [True, False])
def test_deint_ops_match_jax(parity_top):
    """The port's float32 ops.deint functions against the JAX ones."""
    f = _frames(b=5, h=24, w=40, seed=9).astype(np.float32)
    prev, cur, nxt = f[:-2], f[1:-1], f[2:]
    j = np.asarray(jdeint.yadif_deinterlace(
        jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(nxt), parity_top))
    t = tdeint.yadif_deinterlace(torch.from_numpy(prev),
                                 torch.from_numpy(cur),
                                 torch.from_numpy(nxt), parity_top).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(
        tdeint.field_match_costs(torch.from_numpy(f)).numpy(),
        np.asarray(jdeint.field_match_costs(jnp.asarray(f))), rtol=1e-6)
    top, bot = f[:, 0::2], f[:, 1::2]
    np.testing.assert_allclose(
        tdeint.combing_metric_fields(torch.from_numpy(top),
                                     torch.from_numpy(bot)).numpy(),
        np.asarray(jdeint.combing_metric_fields(jnp.asarray(top),
                                                jnp.asarray(bot))),
        rtol=1e-6)


def test_telecine_pattern_costs_match_jax():
    costs = np.random.default_rng(4).uniform(0, 500, (23, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tdeint.telecine_pattern_costs_host(costs),
        jdeint.telecine_pattern_costs_host(costs))


def test_cpu_tensor_runs_plain_version_without_counting():
    frames = torch.from_numpy(_frames())
    before = sum(yadif_fieldmatch.launches.values())
    got = yadif_fieldmatch(frames, with_costs=True)
    want = yadif_fieldmatch_plain(frames, with_costs=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sum(yadif_fieldmatch.launches.values()) == before


@pytest.mark.parametrize("shape,kw,err", [
    ((4, 31, 64), {}, "even H"),
    ((4, 32, 64), {"write_frames": False}, "nothing to compute"),
])
def test_rejects_bad_arguments(shape, kw, err):
    with pytest.raises(ValueError, match=err):
        yadif_fieldmatch(torch.zeros(shape, dtype=torch.uint8), **kw)


def test_rejects_float_frames_and_outside_box():
    with pytest.raises(ValueError, match="uint8"):
        yadif_fieldmatch(torch.zeros((3, 8, 8)))
    a = torch.ones((4, 4))
    box = EraseBox(a, a, torch.ones(3), 6, 0)
    with pytest.raises(ValueError, match="outside"):
        yadif_fieldmatch(torch.zeros((3, 8, 8), dtype=torch.uint8),
                         erase=box)


def test_mode_names():
    assert mode_name(True, False, None) == "yadif"
    assert mode_name(False, True, None) == "costs"
    assert mode_name(True, True, object()) == "yadif+costs+erase"
