"""The port's yadif_fieldmatch (plain version, on the CPU) against the JAX
package: both Pallas kernels in interpret mode (frame layout, field layout
with its costs_only / with_costs / logo_box modes) and the jnp chain of
ops.deint. Filtered frames must be bit-equal; costs agree to the JAX
package's own tolerance (rtol 1e-5, atol 1e-4: float32 sums in another
order against the port's exact integer sums)."""

import itertools

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401
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


# ---------------------------------------------------------------------------
# What the CUDA kernel leans on: its packed-byte arithmetic emulated with
# numpy, and the launch geometry that stays in Python.
# ---------------------------------------------------------------------------

from amatsukaze_tpu_torch.ops import fused_filter as ff  # noqa: E402


def test_average_then_clamp_equals_clamp_then_halve():
    """(clamp(p2, 2lo, 2hi) + 1) >> 1 == clamp((p2 + 1) >> 1, lo, hi) for
    every sum of two bytes and every pair of byte bounds lo <= hi: the
    kernel clamps the rounded-up byte average instead of the doubled sum."""
    lo, hi = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    keep = lo <= hi
    lo, hi = lo[keep], hi[keep]
    for p2 in range(511):
        doubled = (np.clip(p2, 2 * lo, 2 * hi) + 1) >> 1
        halved = np.clip((p2 + 1) >> 1, lo, hi)
        assert np.array_equal(doubled, halved), p2


def test_comb_product_without_compares_is_exact():
    """2 * relu((u - m) * (l - m)) == |u - m| * |l - m| + u*l + m*m - u*m -
    m*l for all bytes: the kernel's cost sums are sums of byte products."""
    m, low = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for u in range(256):
        want = 2 * np.maximum((u - m) * (low - m), 0)
        got = (np.abs(u - m) * np.abs(low - m) + u * low + m * m - u * m
               - m * low)
        assert np.array_equal(got, want), u


def _funnel_r(lo, hi, shift):
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both >> np.uint64(shift)) & np.uint64(0xffffffff)).astype(
        np.uint32)


def _bytes(words):
    return np.ascontiguousarray(words).view(np.uint8).astype(np.int32)


def _words(byte_values):
    return np.ascontiguousarray(byte_values.astype(np.uint8)).view(np.uint32)


def _packed_rebuild_row(above, below, tp, tn):
    """The kernel's `rebuild` for one row, word by word on uint32 lanes: 16
    pixels a word, the last one padded with the row's last pixel, aprons of
    replicated edge pixels, funnel shifts for the +-1/+-2 taps, the winner's
    taps kept under strict-less masks, one rounded-up average, one clamp."""
    w = above.shape[-1]
    n_words = -(-w // 16)

    def padded(row):
        out = np.full(n_words * 16, row[-1], np.uint8)
        out[:w] = row
        return out.view(np.uint32).reshape(n_words, 4)

    rows = {k: padded(v) for k, v in dict(a=above, c=below, tp=tp,
                                          tn=tn).items()}

    def with_aprons(words):
        left = np.empty(n_words, np.uint32)
        right = np.empty(n_words, np.uint32)
        left[1:] = words[:-1, 3]
        right[:-1] = words[1:, 0]
        left[0] = (words[0, 0] & 0xff) * np.uint32(0x01010101)
        right[-1] = (words[-1, 3] >> 24) * np.uint32(0x01010101)
        return np.concatenate([left[:, None], words, right[:, None]], axis=1)

    A, C = with_aprons(rows["a"]), with_aprons(rows["c"])
    out = np.empty((n_words, 4), np.uint32)
    for j in range(4):
        a, c = _bytes(A[:, j + 1]), _bytes(C[:, j + 1])
        score = np.abs(a - c)
        taps = [(_funnel_r(A[:, j + 1], A[:, j + 2], 8),
                 _funnel_r(C[:, j], C[:, j + 1], 24)),
                (_funnel_r(A[:, j], A[:, j + 1], 24),
                 _funnel_r(C[:, j + 1], C[:, j + 2], 8)),
                (_funnel_r(A[:, j + 1], A[:, j + 2], 16),
                 _funnel_r(C[:, j], C[:, j + 1], 16)),
                (_funnel_r(A[:, j], A[:, j + 1], 16),
                 _funnel_r(C[:, j + 1], C[:, j + 2], 16))]
        for pa, pc in taps:
            pa, pc = _bytes(pa), _bytes(pc)
            sc = np.abs(pa - pc)
            better = sc < score
            a = np.where(better, pa, a)
            c = np.where(better, pc, c)
            score = np.where(better, sc, score)
        pred = (a + c + 1) >> 1
        p, n = _bytes(rows["tp"][:, j]), _bytes(rows["tn"][:, j])
        swap = n < p
        lo, hi = np.where(swap, n, p), np.where(swap, p, n)
        res = np.where(pred < lo, lo, np.where(hi < pred, hi, pred))
        out[:, j] = _words(res)
    return out.view(np.uint8).reshape(-1)[:w]


@pytest.mark.parametrize("w,levels", [(64, 3), (70, 2), (16, 4), (33, 256),
                                      (5, 3)])
def test_packed_direction_search_matches_deint_chain(w, levels):
    """Few grey levels make most scores tie: the packed search with its
    strict '<' must pick the tap that ops.deint's chain picks, at the row
    ends (edge replication) and in a partial last word too."""
    rng = np.random.default_rng(w * 1000 + levels)
    for _ in range(20):
        above, below, tp, tn = (
            rng.integers(0, levels, w).astype(np.uint8) * (255 // levels)
            for _ in range(4))
        spatial = tdeint._spatial_pred(
            torch.from_numpy(above.astype(np.float32))[None, None],
            torch.from_numpy(below.astype(np.float32))[None, None])[0, 0]
        lo = np.minimum(tp, tn).astype(np.float32)
        hi = np.maximum(tp, tn).astype(np.float32)
        want = np.floor(np.clip(spatial.numpy(), lo, hi) + 0.5)
        got = _packed_rebuild_row(above, below, tp, tn)
        np.testing.assert_array_equal(got, want.astype(np.uint8))


def test_packed_rebuild_matches_plain_version_on_frames():
    """Whole frames through the emulated kernel row against
    yadif_fieldmatch_plain (bottom rows rebuilt, last field row's below row
    is the kept row itself)."""
    frames = _frames(b=3, h=12, w=37, seed=5)
    want, _ = _port(frames)
    prev = np.concatenate([frames[:1], frames[:-1]])
    nxt = np.concatenate([frames[1:], frames[-1:]])
    for f in range(3):
        for y in range(6):
            below = frames[f, 2 * y + 2] if y < 5 else frames[f, 2 * y]
            got = _packed_rebuild_row(frames[f, 2 * y], below,
                                      prev[f, 2 * y + 1], nxt[f, 2 * y + 1])
            np.testing.assert_array_equal(got, want[f, 2 * y + 1])
            np.testing.assert_array_equal(frames[f, 2 * y], want[f, 2 * y])


@pytest.mark.parametrize("w,levels", [(37, 256), (40, 3)])
def test_packed_rebuild_bottom_parity_matches_plain_version(w, levels):
    """The kernel's bottom-parity rows: the rebuilt even row 2y from the
    kept rows 2y-1 above (row 1 again on the first field row) and 2y+1
    below, in that order, clamped by the previous and next frame's row 2y,
    against yadif_fieldmatch_plain(parity_top=False)."""
    rng = np.random.default_rng(w + levels)
    frames = (rng.integers(0, levels, (3, 12, w)) * (255 // (levels - 1))
              ).astype(np.uint8)
    want, _ = yadif_fieldmatch_plain(torch.from_numpy(frames),
                                     parity_top=False)
    want = want.numpy()
    prev = np.concatenate([frames[:1], frames[:-1]])
    nxt = np.concatenate([frames[1:], frames[-1:]])
    for f in range(3):
        for y in range(6):
            above = frames[f, 2 * max(y - 1, 0) + 1]
            got = _packed_rebuild_row(above, frames[f, 2 * y + 1],
                                      prev[f, 2 * y], nxt[f, 2 * y])
            np.testing.assert_array_equal(got, want[f, 2 * y])
            np.testing.assert_array_equal(frames[f, 2 * y + 1],
                                          want[f, 2 * y + 1])


def test_product_cost_sums_match_plain_version():
    """The three costs as the kernel sums them (per woven row the products
    of the steps' absolute differences, of the rows two apart, of the row
    with itself, less those of the adjacent rows; halved) against the plain
    version."""
    frames = _frames(b=4, h=14, w=21, seed=8).astype(np.int64)
    _, want = yadif_fieldmatch_plain(torch.from_numpy(
        frames.astype(np.uint8)), write_frames=False, with_costs=True)
    prev = np.concatenate([frames[:1], frames[:-1]])
    sums = np.zeros((4, 3), np.int64)
    weaves = [(frames[:, 0::2], frames[:, 1::2]),
              (frames[:, 0::2], prev[:, 1::2]),
              (prev[:, 0::2], frames[:, 1::2])]
    for k, (top, bot) in enumerate(weaves):
        woven = np.empty_like(frames)
        woven[:, 0::2], woven[:, 1::2] = top, bot
        u, m, low = woven[:, :-2], woven[:, 1:-1], woven[:, 2:]
        plus = np.abs(u - m) * np.abs(low - m) + u * low + m * m
        minus = u * m + m * low
        assert (plus >= minus).all()  # the kernel's running sum never wraps
        sums[:, k] = (plus.sum((1, 2)) - minus.sum((1, 2))) // 2
    got = tdeint.comb_mean(torch.from_numpy(sums), 14, 21)
    assert torch.equal(got, want)


@pytest.mark.parametrize("h", [2, 50, 540, 1080])
@pytest.mark.parametrize("with_costs", [True, False])
def test_tile_count_and_partials_shape(h, with_costs):
    rows = ff.tile_rows_for(with_costs)
    assert rows == (ff.TILE_FIELD_ROWS_COSTS if with_costs
                    else ff.TILE_FIELD_ROWS)
    n = ff.tile_count(h, rows)  # the partials' [tiles, B, 3]
    fh = h // 2
    assert (n - 1) * rows < fh <= n * rows  # every field row in one tile
    assert n == {2: 1, 50: (2 if with_costs else 4),
                 540: (12 if with_costs else 34),
                 1080: (23 if with_costs else 68)}[h]


@pytest.mark.parametrize("w", [1, 16, 70, 333, 720, 1440, 1920, 3840, 4096,
                               5000])
@pytest.mark.parametrize("rows", [ff.TILE_FIELD_ROWS,
                                  ff.TILE_FIELD_ROWS_COSTS])
@pytest.mark.parametrize("cap", [ff.MAX_THREADS, ff.MAX_THREADS_ALL])
def test_launch_geometry(w, rows, cap):
    strips, threads = ff.launch_geometry(w, rows, cap)
    n_words = -(-w // ff.WORD)
    assert threads % 32 == 0 and 32 <= threads <= cap
    assert 1 <= strips <= rows and strips & (strips - 1) == 0
    if n_words * strips > threads:  # threads loop over column chunks
        assert strips == 1 and threads == cap
    else:
        assert threads - n_words * strips < 32  # no idle warp
        assert 2 * strips > rows or 2 * strips * n_words > cap
    if w in (720, 1440):
        assert (strips, threads) == {720: (4, 192), 1440: (2, 192)}[w]


def test_thread_cap_per_mode():
    """Only the mode that writes frames, sums costs and erases at once is
    held to the smaller block."""
    for frames, costs, erase in itertools.product((False, True), repeat=3):
        want = (ff.MAX_THREADS_ALL if frames and costs and erase
                else ff.MAX_THREADS)
        assert ff.max_threads_for(frames, costs, erase) == want
    assert ff.launch_geometry(1440, 8) == ff.launch_geometry(
        1440, 8, ff.MAX_THREADS)


@pytest.mark.parametrize("w,h", [(1440, 1080), (720, 540), (1920, 1080),
                                 (3840, 2160), (7680, 4320)])
@pytest.mark.parametrize("cap", [ff.MAX_THREADS, ff.MAX_THREADS_ALL])
def test_uint32_cost_sums_cannot_overflow(w, h, cap):
    """A thread's cost sums stay in uint32: the most products it adds, each
    at most 255^2, fit for the chosen tile height whatever H is (a thread
    never walks more than its strip of one tile)."""
    rows = ff.tile_rows_for(True)
    n = ff.products_per_thread(w, rows, cap)
    strips, threads = ff.launch_geometry(w, rows, cap)
    per_row = 6 * ff.WORD * -(-(-(-w // ff.WORD) * strips) // threads)
    assert n == per_row * -(-rows // strips)
    assert n * 255 * 255 < 2 ** 32
    assert n <= ff.MAX_U32_PRODUCTS == (2 ** 32 - 1) // 255 ** 2
    # and the bound is not vacuous: rows wide enough would overflow
    assert ff.products_per_thread(16 * 256 * 200, rows) > ff.MAX_U32_PRODUCTS
