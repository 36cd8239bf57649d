"""The port's logo ops (plain versions, on the CPU) against the JAX package:
batched_evaluate_logo against the jnp path and the Pallas kernel in
interpret mode (rtol 1e-5, atol 1e-5: float32 sums in another order; the
jnp and Pallas outputs themselves differ by ~2e-7), DeintY / DeintLogo /
the erase bit for bit, and the dense operands carried over by
convert.logo_params_from_numpy. The compacted operands that the CUDA kernel
reads are held against the dense ones, and a torch emulation of the
kernel's loop over them (one masked pixel per thread, its sums in the
kernel's order) against the plain version: every pixel's value bit-equal,
the scores within 1e-5 (another order of the masked sum)."""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401
import torch

import jax.numpy as jnp

import amatsukaze_tpu.models.logo as jlogo_model
from amatsukaze_tpu.models.lgd import LogoData as JLogoData
from amatsukaze_tpu.models.lgd import LogoHeader as JLogoHeader
from amatsukaze_tpu.ops import logo as jlogo
from amatsukaze_tpu.ops import logo_ref as jlogo_ref
from amatsukaze_tpu.ops.logo_pallas import evaluate_logo_pallas
from amatsukaze_tpu_torch import convert
from amatsukaze_tpu_torch.models import lgd as tlgd
from amatsukaze_tpu_torch.ops import logo as tlogo
from amatsukaze_tpu_torch.ops import logo_ref as tlogo_ref
from amatsukaze_tpu_torch.ops.logo_eval import (delogo_full_frame, evaluate_logo,
                                                evaluate_logo_u8)

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


# ---------------------------------------------------------------------------
# the compacted operands and the kernel's loop over them
# ---------------------------------------------------------------------------

WINDOWS = [(96, 256), (50, 70)]


def _window_ref(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot((yy - h / 2) / (h / 2), (xx - w / 2) / (w / 2))
    alpha = (np.clip(1.2 - r, 0, 1) * 0.35
             * (0.6 + 0.4 * np.sin(xx / 3.0) * np.cos(yy / 2.0))).astype(
                 np.float32)
    a = (1.0 / (1.0 - alpha)).astype(np.float32)
    b = (-alpha * 200.0 / (1.0 - alpha) / 255.0).astype(np.float32)
    return jlogo_ref.LogoEvalRef(a, b, maskratio=0.1)


@pytest.fixture(scope="module", params=WINDOWS, ids=lambda s: f"{s[0]}x{s[1]}")
def window_ref(request):
    h, w = request.param
    rng = np.random.default_rng(h * 1000 + w)
    raw = rng.integers(0, 256, (5, h, w)).astype(np.uint8)
    return _window_ref(h, w), raw


def _assert_compact_matches_dense(p):
    h, w = p.mask.shape
    pos = p.pos.numpy().astype(np.int64)
    weight = p.weight.numpy()
    real = weight > 0
    assert len(pos) % p.chunk == 0 and p.chunk % 32 == 0
    assert int(real.sum()) == p.n_items == int(p.mask.sum())
    # the real entries are the masked pixels, each once, in row-major order
    np.testing.assert_array_equal(pos[real],
                                  np.flatnonzero(p.mask.numpy().ravel()))
    for dense, compact in ((p.kernels, p.kernels_c), (p.scale, p.scale_c),
                           (p.scale2, p.scale2_c)):
        flat = dense.numpy().reshape(dense.shape[0], -1)
        np.testing.assert_array_equal(compact.numpy()[:, real],
                                      flat[:, pos[real]])
        assert not compact.numpy()[:, ~real].any()  # padding: zero tables
        assert compact.is_contiguous()
    np.testing.assert_array_equal(weight[real], 1.0)
    # every chunk: positions ascend (padding repeats the last one), interior
    ys, xs = pos // w, pos % w
    assert ys.min() >= 2 and ys.max() <= h - 3
    assert xs.min() >= 2 and xs.max() <= w - 3
    for c in range(len(pos) // p.chunk):
        sl = slice(c * p.chunk, (c + 1) * p.chunk)
        assert (np.diff(pos[sl]) >= 0).all()
        n_real = int(real[sl].sum())  # padding only behind the real ones
        assert n_real >= 1 and real[sl][:n_real].all()
    _assert_boxes_hold_taps(pos, p.boxes.numpy(), p.chunk, p.tile_elems, h, w)


def _assert_boxes_hold_taps(pos, boxes, chunk, tile_elems, h, w):
    """Each chunk's box of the window holds the 5x5 taps of all its entries,
    lies inside the window, starts and ends on columns the 16-byte loads
    can take, and is no larger than the tile."""
    ys, xs = (pos // w).reshape(-1, chunk), (pos % w).reshape(-1, chunk)
    assert boxes.shape == (len(ys), 4) and boxes.dtype == np.int32
    row0, rows, col0, cols = boxes.T
    assert (row0 >= 0).all() and (row0 + rows <= h).all()
    assert (col0 >= 0).all() and (col0 + cols <= w).all()
    assert (ys.min(1) - 2 >= row0).all() and (ys.max(1) + 2 < row0 + rows).all()
    assert (xs.min(1) - 2 >= col0).all() and (xs.max(1) + 2 < col0 + cols).all()
    assert (rows <= tlogo.MAX_TILE_ROWS).all()
    assert (col0 % 4 == 0).all()
    if w % 4 == 0:
        assert (cols % 4 == 0).all()
    assert tile_elems == (rows * cols).max()


@pytest.mark.parametrize("via", ["from_numpy", "convert"])
def test_compact_operands_round_trip(window_ref, via):
    ref, _ = window_ref
    if via == "from_numpy":
        p = tlogo.LogoEvalParams.from_numpy(
            tlogo.dense_operands_from_ref(ref), CPU)
    else:
        p = convert.logo_params_from_numpy(
            jlogo.LogoEvalParams.from_ref(ref), device="cpu")
    assert p.chunk == tlogo.ITEMS_PER_BLOCK
    assert p.n_items % 32 != 0  # the last warp is padded
    _assert_compact_matches_dense(p)


@pytest.mark.parametrize("chunk", [32, 64, 256])
def test_compact_operands_other_chunks(window_ref, chunk):
    ref, _ = window_ref
    _assert_compact_matches_dense(tlogo.LogoEvalParams.from_ref(ref, CPU, chunk))
    with pytest.raises(ValueError, match="multiple of 32"):
        tlogo.LogoEvalParams.from_ref(ref, CPU, chunk + 1)


def test_compact_operands_sparse_mask_ends_chunks_early():
    """Few masked pixels spread over many rows: a chunk ends where its tile
    would outgrow the rows a block holds, and is padded."""
    h, w = 64, 40
    mask = np.zeros((h, w), np.float32)
    mask[2:h - 2:3, 5] = 1.0
    rng = np.random.default_rng(3)
    c = tlogo.compact_operands(
        mask, rng.normal(size=(25, h, w)).astype(np.float32),
        rng.normal(size=(32, h, w)).astype(np.float32),
        rng.normal(size=(32, h, w)).astype(np.float32), 32)
    n = int(mask.sum())
    assert c["n_items"] == n and len(c["pos"]) > 32 * -(-n // 32)
    _assert_boxes_hold_taps(c["pos"].astype(np.int64), c["boxes"], 32,
                            c["tile_elems"], h, w)
    np.testing.assert_array_equal(c["pos"][c["weight"] > 0],
                                  np.flatnonzero(mask.ravel()))
    empty = tlogo.compact_operands(
        np.zeros((h, w), np.float32), np.zeros((25, h, w), np.float32),
        np.zeros((32, h, w), np.float32), np.zeros((32, h, w), np.float32))
    assert empty["n_items"] == 0 and len(empty["pos"]) == 0
    assert empty["boxes"].shape == (0, 4) and empty["tile_elems"] == 0


@pytest.mark.parametrize("where", [(1, 5), (5, 1), (-2, 5), (5, -2)])
def test_compact_operands_reject_border_mask(where):
    h, w = 12, 14
    mask = np.zeros((h, w), np.float32)
    mask[6, 6] = 1.0
    mask[where] = 1.0
    z = np.zeros((32, h, w), np.float32)
    with pytest.raises(ValueError, match="border"):
        tlogo.compact_operands(mask, z[:25], z, z)


def _emulate_kernel(p, src, maxv, fades, fades_per_block=6):
    """csrc/logo_eval.cu in torch on the CPU, float32 throughout and every
    operation on its own: the tile fill (with DeintY for a uint8 window),
    one compacted entry per thread, the shuffle tree of a warp, the warps
    of a block and the chunks of a frame in index order. Returns (scores
    [B, F], values [B, F, M])."""
    b, h, w = src.shape
    if src.dtype == torch.uint8:
        u = src.to(torch.int32)
        mid = ((u[:, :-2] + 2 * u[:, 1:-1] + u[:, 2:] + 2).float()
               * torch.tensor(0.25))
        xs = torch.cat([u[:, :1].float(), mid, u[:, -1:].float()], dim=1)
    else:
        xs = src
    bg = p.a_y * xs + p.b_y * maxv
    pos = p.pos.long()
    m = len(pos)
    # the block reads its taps from a tile that holds its chunk's box of
    # the window: tap (dy, dx) of an entry is tile[t0 + dy * cols + dx]
    row0, n_rows, col0, cols = (
        p.boxes.long().repeat_interleave(p.chunk, dim=0).T)
    t0 = (pos // w - row0 - 2) * cols + pos % w - col0 - 2
    dy = torch.arange(25) // 5
    dx = torch.arange(25) % 5
    tile_idx = t0[:, None] + dy * cols[:, None] + dx  # [M, 25]
    assert (tile_idx >= 0).all()
    assert (tile_idx < (n_rows * cols)[:, None]).all()
    assert (n_rows * cols <= p.tile_elems).all()
    # where the fill put that element of the tile
    idx = ((row0[:, None] + tile_idx // cols[:, None]) * w + col0[:, None]
           + tile_idx % cols[:, None])
    assert torch.equal(idx, pos[:, None] + (dy - 2) * w + dx - 2)
    tx = xs.reshape(b, -1)[:, idx]  # [B, M, 25]
    tb = bg.reshape(b, -1)[:, idx]
    item = torch.arange(m)
    values = torch.empty((b, len(fades), m))
    for fi, fade in enumerate(fades):
        keep = torch.tensor(1.0) - fade
        v = fade * tb + keep * tx
        total = torch.zeros((b, m))
        for k in range(25):
            total = total + v[..., k]
        avg = total / 25.0
        corr = torch.zeros((b, m))
        for k in range(25):
            corr = corr + (v[..., k] - avg) * p.kernels_c[k]
        bucket = (avg.to(torch.int32).clamp(0, 255) >> 3).long()
        s1 = p.scale_c[bucket, item]
        s2 = p.scale2_c[bucket, item]
        nrm = (corr * s1).clamp(-1.0, 1.0)
        values[:, fi] = nrm * s2 * p.weight
    lanes = values.reshape(b, len(fades), -1, 32)
    for off in (16, 8, 4, 2, 1):  # __shfl_down: lane i takes lane i + off
        lanes = lanes[..., :off] + lanes[..., off:2 * off]
    warps = lanes[..., 0].reshape(b, len(fades), m // p.chunk, p.chunk // 32)
    partial = warps[..., 0]
    for k in range(1, warps.shape[-1]):
        partial = partial + warps[..., k]
    assert fades_per_block >= 1  # the split over blocks moves no sum
    total = partial[..., 0]
    for c in range(1, partial.shape[-1]):
        total = total + partial[..., c]
    return total / torch.tensor(p.black_score), values


@pytest.mark.parametrize("entry", ["float32", "uint8"])
@pytest.mark.parametrize("fade_steps", [2, 11])
def test_kernel_item_loop_matches_plain(window_ref, fade_steps, entry):
    ref, raw = window_ref
    p = tlogo.LogoEvalParams.from_ref(ref, CPU)
    fades = torch.linspace(0, 1, fade_steps)
    raw_t = torch.from_numpy(raw)
    deint = tlogo.batched_deint_y(raw_t.float())
    scores, values = _emulate_kernel(
        p, raw_t if entry == "uint8" else deint, 255.0, fades)
    per_pixel = tlogo.correlation_values(
        p, tlogo.blend(p, deint, 255.0, fades))  # [B, F, H, W]
    want = per_pixel.flatten(-2)[..., p.pos.long()] * (p.weight > 0)
    assert torch.equal(values, want)  # bit for bit
    # nothing off the compacted list adds to the plain version's sum
    off = per_pixel.flatten(-2).clone()
    off[..., p.pos.long()[p.weight > 0]] = 0.0
    assert not off.any()
    plain = tlogo.batched_evaluate_logo(p, deint, 255.0, fades)
    np.testing.assert_allclose(scores.numpy(), plain.numpy(), **SCORE_TOL)
    # and the oracle's per-pixel loop, on the first frame at fade 0
    np.testing.assert_allclose(scores[0, 0].item(),
                               ref.evaluate(deint[0].numpy(), 255.0, 0.0),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fade_steps", [2, 11])
def test_evaluate_logo_u8_matches_chain_and_jax(window_ref, fade_steps,
                                                monkeypatch):
    """The uint8 entry on the CPU is DeintY + the plain score exactly, and
    the JAX matcher's _deint_eval chain within the score tolerance."""
    ref, raw = window_ref
    fades = np.linspace(0.0, 1.0, fade_steps).astype(np.float32)
    p = tlogo.LogoEvalParams.from_ref(ref, CPU)
    before = evaluate_logo.launches
    got = evaluate_logo_u8(p, torch.from_numpy(raw), 255.0,
                           torch.from_numpy(fades))
    assert evaluate_logo.launches == before  # the plain version, uncounted
    chain = tlogo.batched_evaluate_logo(
        p, tlogo.batched_deint_y(torch.from_numpy(raw).float()), 255.0,
        torch.from_numpy(fades))
    assert torch.equal(got, chain)
    monkeypatch.setattr(jlogo_model, "_HOST_OPS", False)  # the jnp path
    j = jlogo_model._deint_eval(jlogo.LogoEvalParams.from_ref(ref), raw, fades)
    assert got.shape == j.shape == (len(raw), fade_steps)
    np.testing.assert_allclose(got.numpy(), j, **SCORE_TOL)


def test_evaluate_logo_entries_check_their_dtype(window_ref):
    ref, raw = window_ref
    p = tlogo.LogoEvalParams.from_ref(ref, CPU)
    fades = torch.linspace(0, 1, 2)
    with pytest.raises(ValueError, match="float32"):
        evaluate_logo(p, torch.from_numpy(raw), 255.0, fades)
    with pytest.raises(ValueError, match="uint8"):
        evaluate_logo_u8(p, torch.from_numpy(raw).float(), 255.0, fades)
