"""The post chain, the resize and the 10-bit path of the filter stage on the
CPU, against the JAX package.

Unit by unit: ops.threefry against jax.random, bit for bit; each op of
ops.denoise against amatsukaze_tpu.ops.denoise, bit for bit (deblock_qp
sums its DCT taps in XLA's order and edge_level rounds `c - lap * k` as
the FMA XLA makes of it); the fixed order of deblock's and the resize's
sums, held against a numpy rendering of the same order (what makes the card
give the CPU's bits); QpMapSource's clamping and its replacement of a map
of the wrong shape; lanczos3_weights equal to the JAX package's copy and
the resize within 1e-3 of jax.image.resize (XLA sums the dense weights in
another order).

Whole: run_filter_stage against the JAX package's `_encode_one` wiring
(build_post_chain, QP maps, resize, the 10-bit rule, `_pump_filtered`'s
batching) in each configuration of utils.golden.POST_CONFIGS. Where yadif
feeds the chain, the JAX reference takes its TPU path's composition
(yadif -> round to uint8 -> chain), which the port follows. Output frames
are equal or one code value apart on at most POST_TIE_SHARE of the samples
(utils.golden says which configurations are bit-equal). Mode none with a
resize and no chain resizes (the JAX pipeline's `_encode_one` passes the
frames through unresized there, under a header that declares the resized
size; its FilterGraph driven through `_pump_filtered` does resize).

    python tests/test_torch_post_chain.py --write

runs those configurations over the recorded 96x128 clip in the JAX package,
checks the port against them, and rewrites
amatsukaze_tpu_torch/testdata/golden_post.npz (chip_smoke.py holds the card
to it).
"""

import argparse
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # for the script run
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import amatsukaze_tpu.models.logo as jlogo_model  # noqa: E402
from amatsukaze_tpu.models import filter_graph as jfg_mod  # noqa: E402
from amatsukaze_tpu.models.logo_erase import LogoEraser as JEraser  # noqa: E402
from amatsukaze_tpu.ops import deint as jdeint  # noqa: E402
from amatsukaze_tpu.ops import denoise as jden  # noqa: E402
from amatsukaze_tpu.ops import resize as jresize  # noqa: E402
from amatsukaze_tpu.pipeline.transcode import _pump_filtered  # noqa: E402
from amatsukaze_tpu.ts.qp_extract import QpMapSource as JQp  # noqa: E402
from amatsukaze_tpu.utils.context import AMTContext as JContext  # noqa: E402
from test_torch_filter_stage import jax_format, jax_logo  # noqa: E402

from amatsukaze_tpu_torch.models.filter_graph import (  # noqa: E402
    FilterGraph, build_post_chain)
from amatsukaze_tpu_torch.ops import denoise, threefry  # noqa: E402
from amatsukaze_tpu_torch.ops import resize as tresize  # noqa: E402
from amatsukaze_tpu_torch.pipeline.filter_stage import (  # noqa: E402
    run_filter_stage)
from amatsukaze_tpu_torch.ts.qp_extract import QpMapSource  # noqa: E402
from amatsukaze_tpu_torch.utils import golden, synth_clip  # noqa: E402
from amatsukaze_tpu_torch.utils.context import AMTContext  # noqa: E402

TOL_8BIT = 1e-3  # the resize against jax.image.resize, 8-bit domain


def _j(x):
    return np.asarray(x)


def _frames(b=8, h=64, w=96, seed=0, hi=256):
    return np.random.default_rng(seed).integers(0, hi, (b, h, w)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# ops.threefry against jax.random
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 0x9E3779B9, 0xFFFFFFFF]


def _jkey(seed):
    return jax.random.PRNGKey(jnp.uint32(seed))


def _same(jarr, t):
    np.testing.assert_array_equal(np.asarray(jarr).astype(np.int64),
                                  t.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split(seed):
    jk, tk = _jkey(seed), threefry.prng_key(seed)
    _same(jk, tk)
    for d in (0, 1, 31, 0xFFFFFFFF):
        _same(jax.random.fold_in(jk, jnp.uint32(d)), threefry.fold_in(tk, d))
    for n in (2, 3):
        _same(jax.random.split(jk, n), threefry.split(tk, n))
    keys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(5))
    tkeys = threefry.fold_in(tk, torch.arange(5))
    _same(keys, tkeys)
    _same(jax.vmap(jax.random.split)(keys), threefry.split(tkeys))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry2x32_and_bits(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    x = rng.integers(0, 2 ** 32, (2, 50), dtype=np.uint64).astype(np.uint32)
    k = np.array([seed >> 7, seed], np.uint64).astype(np.uint32)
    from jax._src import prng as jprng

    want = jprng.threefry2x32_p.bind(*(jnp.asarray(v) for v in (
        k[0], k[1], x[0], x[1])))
    got = threefry.threefry2x32(int(k[0]), int(k[1]),
                                *(torch.from_numpy(v.astype(np.int64))
                                  for v in x))
    for a, b in zip(want, got):
        _same(a, b)
    _same(jax.random.bits(_jkey(seed), (7, 9)),
          threefry.random_bits(threefry.prng_key(seed), (7, 9)))


@pytest.mark.parametrize("shape,lo,hi", [((8, 2), -15, 16), ((24, 40), 0, 8),
                                         ((5, 6), 2, 32), ((3, 4), 5, 5)])
def test_randint(shape, lo, hi):
    """The shapes and ranges deband draws (candidate offsets, selection),
    a span that is no power of two, and an empty range."""
    for seed in SEEDS:
        _same(jax.random.randint(_jkey(seed), shape, lo, hi),
              threefry.randint(threefry.prng_key(seed), shape, lo, hi))
    keys = jax.vmap(lambda i: jax.random.fold_in(_jkey(3), i))(jnp.arange(4))
    _same(jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))(keys),
          threefry.randint(threefry.fold_in(threefry.prng_key(3),
                                            torch.arange(4)), shape, lo, hi))


# ---------------------------------------------------------------------------
# ops.denoise against amatsukaze_tpu.ops.denoise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 3, 8])
def test_temporal_nr_bit_equal(b):
    x = _frames(b=b, seed=b) * 64.0
    # close values, so that most neighbours pass the motion guard
    x = x[:1] + (x - x[:1]) * 0.01
    np.testing.assert_array_equal(
        denoise.temporal_nr(torch.from_numpy(x)).numpy(),
        _j(jden.temporal_nr(jnp.asarray(x))))


@pytest.mark.parametrize("seed,offset", [(0, 0), (7, 3), (0x9E3779B9, 0)])
def test_deband_bit_equal(seed, offset):
    yy, xx = np.mgrid[0:64, 0:96]
    ramp = (yy * 3.0 + xx * 2.0)[None] + _frames(b=4, seed=seed & 99,
                                                  hi=40)
    x = (ramp * 16.0).astype(np.float32)
    np.testing.assert_array_equal(
        denoise.deband(torch.from_numpy(x), seed,
                       frame_offset=offset).numpy(),
        _j(jden.deband(jnp.asarray(x), jnp.uint32(seed),
                       frame_offset=offset)))


def test_deband_offsets_and_selection_match_jax():
    for s in range(2):
        koff = jax.random.fold_in(_jkey(0 ^ 0x9E3779B9), s)
        want = _j(jax.random.randint(koff, (8, 2), -15, 16)).tolist()
        assert [list(o) for o in denoise.deband_offsets(0, s)] == want
    keys = threefry.fold_in(threefry.prng_key(0), torch.arange(6))
    ksel = threefry.split(keys)[:, 1]
    got = denoise.deband_selection(ksel, 10, 12)
    _same(jax.vmap(lambda k: jax.random.randint(k, (10, 12), 0, 8))(
        jnp.asarray(ksel.numpy().astype(np.uint32))), got)


@pytest.mark.parametrize("scale", [2, 1])
def test_deblock_qp_within_tolerance(scale):
    """Bit-equal (a tolerance of 0), on integer and fractional samples."""
    x = _frames(b=3, seed=scale)
    x[1] += np.random.default_rng(scale).random(x[1].shape, np.float32)
    qp = np.random.default_rng(4).integers(2, 32, (3, 64 // 8 // scale,
                                                   96 // 8 // scale))
    qp = qp.astype(np.float32)
    got = denoise.deblock_qp(torch.from_numpy(x), torch.from_numpy(qp),
                             qp_block_scale=scale).numpy()
    want = _j(jden.deblock_qp(jnp.asarray(x), jnp.asarray(qp),
                              qp_block_scale=scale))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - x).max() > 1.0  # the threshold did shrink


def test_edge_level_within_tolerance():
    """Bit-equal (a tolerance of 0)."""
    yy, xx = np.mgrid[0:64, 0:96]
    edges = np.where((xx // 12 + yy // 16) % 2, 180.0, 60.0)[None]
    x = ((edges + _frames(b=3, seed=2, hi=60)) * 64.0).astype(np.float32)
    x[2] += np.random.default_rng(2).random(x[2].shape, np.float32)
    got = denoise.edge_level(torch.from_numpy(x)).numpy()
    want = _j(jden.edge_level(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - x).max() > 64.0


def _fma(prod, acc):
    """numpy float32 fma from a float64 product (ops.denoise.fma_f32)."""
    return (prod + acc.astype(np.float64)).astype(np.float32)


def _dct_numpy(m, y):
    """m @ y per 8x8 block, the taps in dct8_sum's order, in numpy."""
    t = [m[:, j, None].astype(np.float64) * y[..., j, None, :].astype(
        np.float64) for j in range(8)]
    a = [_fma(t[r + 4], t[r].astype(np.float32)) for r in range(4)]
    return (a[0] + a[1]) + (a[2] + a[3])


@pytest.mark.parametrize("threads", [1, 3])
def test_deblock_and_resize_follow_one_fixed_order(threads):
    """Both are sequences of elementwise operations in one order, which a
    numpy rendering of that order reproduces bit for bit, whatever the
    thread count, and each frame's result does not depend on the batch it
    is in. Nothing is left to a BLAS or a compiler, so the card computes
    the same bits (chip_smoke.py checks it there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        x = _frames(b=3, h=64, w=96, seed=threads) + 0.25
        qp = np.random.default_rng(3).integers(2, 32, (3, 4, 6)).astype(
            np.float32)
        got = denoise.deblock_qp(torch.from_numpy(x),
                                 torch.from_numpy(qp)).numpy()
        alone = denoise.deblock_qp(torch.from_numpy(x[1:2]),
                                   torch.from_numpy(qp[1:2])).numpy()
        d = denoise._DCT8
        blocks = x.reshape(3, 8, 8, 12, 8).transpose(0, 1, 3, 2, 4)
        coef = _dct_numpy(d, _dct_numpy(d, blocks).swapaxes(-1, -2)
                          ).swapaxes(-1, -2)
        np.testing.assert_array_equal(
            coef, denoise._dct_right(denoise._dct_left(
                torch.from_numpy(d).double(),
                torch.from_numpy(blocks).double()).double(),
                torch.from_numpy(d).double()).numpy())
        np.testing.assert_array_equal(got[1:2], alone)

        r = tresize.resize_lanczos3(torch.from_numpy(x), 40, 72).numpy()
        r_alone = tresize.resize_lanczos3(torch.from_numpy(x[2:]), 40,
                                          72).numpy()
        want = x
        for axis, size in ((1, 40), (2, 72)):
            idx, wt = tresize.lanczos3_taps(want.shape[axis], size)
            src = np.moveaxis(want, axis, -1)
            acc = src[..., idx[0]] * wt[0]
            for t in range(1, len(idx)):
                acc = (acc + src[..., idx[t]] * wt[t]).astype(np.float32)
            want = np.moveaxis(acc, -1, axis)
        np.testing.assert_array_equal(r, want)
        np.testing.assert_array_equal(r[2:], r_alone)
    finally:
        torch.set_num_threads(n)


def test_bit_depth_staging_bit_equal():
    x8 = _frames(seed=5)
    t14 = denoise.to_14bit(torch.from_numpy(x8.astype(np.uint8)))
    np.testing.assert_array_equal(
        t14.numpy(), _j(jden.to_14bit(jnp.asarray(x8.astype(np.uint8)))))
    x14 = np.random.default_rng(1).uniform(-40, 16500, (2, 64, 96)).astype(
        np.float32)
    x14[0, 0, :8] = [8.0, 24.0, 40.0, 16376.0, -8.0, 16383.0, 7.99, 8.01]
    np.testing.assert_array_equal(
        denoise.to_10bit(torch.from_numpy(x14)).numpy(),
        _j(jden.to_10bit(jnp.asarray(x14))))


@pytest.mark.parametrize("tnr,deband,edge", [(True, True, False),
                                             (True, False, True),
                                             (False, True, False)])
def test_hbd_filter_chain(tnr, deband, edge):
    x = np.clip(_frames(b=4, seed=6, hi=30) + 100, 0, 255).astype(np.uint8)
    got = denoise.hbd_filter_chain(torch.from_numpy(x), 0, tnr, deband,
                                   edge).numpy()
    want = _j(jden.hbd_filter_chain(jnp.asarray(x), jnp.uint32(0), tnr,
                                    deband, edge))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# QP maps, resize, build_post_chain
# ---------------------------------------------------------------------------

def _jax_qp_source(maps) -> JQp:
    q = JQp.__new__(JQp)
    q.results = [SimpleNamespace(qp=m) for m in maps]
    q.full_parse = True
    q.slices_ok = q.slices_fallback = 0
    return q


def test_qp_source_clamps_and_replaces_wrong_shapes():
    maps = synth_clip.qp_maps(6, 1, 4, 6)
    maps[3] = np.full((2, 3), 12, np.uint8)  # a field-sized map
    maps[4] = np.zeros((4, 7), np.uint8)  # median 0 -> 8
    t, j = QpMapSource.from_maps(maps), _jax_qp_source(maps)
    assert len(t) == len(j) == 6
    for idx in ([0, 1, 2], [-3, 0, 9], [2, 3, 4, 5], [3, 4], [], [5, 5, 7]):
        a, b = t.maps_for(idx), j.maps_for(idx)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.maps(4, 5), j.maps(4, 5))
    sel_t, sel_j = t.select([5, 0, 2, 11]), j.select([5, 0, 2, 11])
    assert len(sel_t) == len(sel_j) == 4
    np.testing.assert_array_equal(sel_t.maps(0, 4), sel_j.maps(0, 4))
    assert QpMapSource.from_maps([]).maps_for([0]) is None
    assert len(QpMapSource.from_maps([]).select([0, 1])) == 0


@pytest.mark.parametrize("n_in,n_out", [(96, 64), (128, 112), (64, 96),
                                        (1080, 720), (1440, 1280), (7, 7)])
def test_lanczos3_weights_equal_jax_copy(n_in, n_out):
    np.testing.assert_array_equal(tresize.lanczos3_weights(n_in, n_out),
                                  jresize.lanczos3_weights(n_in, n_out))


@pytest.mark.parametrize("out_h,out_w", [(64, 112), (32, 56), (120, 160),
                                         (96, 128)])
def test_resize_within_tolerance_of_jax_image(out_h, out_w):
    x = _frames(b=3, h=96, w=128, seed=out_w)
    got = tresize.resize_lanczos3(torch.from_numpy(x), out_h, out_w).numpy()
    want = _j(jax.image.resize(jnp.asarray(x), (3, out_h, out_w),
                               method="lanczos3"))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_8BIT)


@pytest.mark.parametrize("spec", ["deblock,bogus", "nr,,sharpen"])
def test_unknown_post_tokens_raise(spec):
    with pytest.raises(ValueError, match="unknown post-filter tokens"):
        jfg_mod.build_post_chain(spec)
    with pytest.raises(ValueError, match="unknown post-filter tokens"):
        build_post_chain(spec)
    with pytest.raises(ValueError, match="unknown post-filter tokens"):
        run_filter_stage(AMTContext(), lambda: iter([]), 0,
                         synth_clip.video_format(8, 8), [], "none",
                         lambda planes: None, device="cpu", post_filter=spec)


@pytest.mark.parametrize("spec,bits,h", [
    ("deblock,nr,deband", 8, 64), ("deblock", 8, 60), ("nr,edge", 10, 64),
    ("deband", 8, 64), (" nr , deband ", 10, 64)])
def test_post_chain_matches_jax(spec, bits, h):
    """The chain itself (deblock on a plane of no multiple of 8 rows pads
    with edge rows first)."""
    assert build_post_chain("") is None and build_post_chain(" , ") is None
    chain, jchain = build_post_chain(spec), jfg_mod.build_post_chain(spec)
    assert chain.wants_qp == jchain.wants_qp == ("deblock" in spec)
    x = _frames(b=5, h=h, seed=len(spec), hi=1 << bits)
    x = x[:1] + (x - x[:1]) * 0.05  # temporal neighbours pass the guard
    qp = np.random.default_rng(1).integers(2, 32, (5, -(-h // 16), 6))
    qp = qp.astype(np.float32)
    got = chain(torch.from_numpy(x), qp=torch.from_numpy(qp),
                src_bits=bits).numpy()
    want = _j(jchain(jnp.asarray(x), qp=qp, src_bits=bits))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the stage in each configuration against the JAX package's wiring
# ---------------------------------------------------------------------------

def _yadif_as_on_tpu(fg):
    """The JAX FilterGraph's fused-kernel yadif (its TPU path: uint8 frames
    out, which the chain and resize then read), built from its jnp yadif
    and the kernel's rounding."""

    def fused(frames, prev_frame, next_frame):
        arr = jnp.asarray(frames).astype(jnp.float32)
        first = frames[:1] if prev_frame is None else prev_frame[None]
        last = frames[-1:] if next_frame is None else next_frame[None]
        prev = jnp.concatenate([jnp.asarray(first, jnp.float32), arr[:-1]])
        nxt = jnp.concatenate([arr[1:], jnp.asarray(last, jnp.float32)])
        out = jdeint.yadif_deinterlace(prev, arr, nxt, True)
        return jnp.clip(jnp.floor(out + 0.5), 0, 255).astype(jnp.uint8)

    fg._fused_yadif = fused


def jax_post_stage(frames, logos, mode, batch, monkeypatch, post_filter="",
                   qp_source=None, resize=None):
    """The filter part of the JAX pipeline as `_encode_one` wires it (logo
    match and erase, FilterGraph with build_post_chain, QP maps and resize,
    the 10-bit rule, `_pump_filtered`), on its device path. Returns
    (FilterGraph, FilterOutput, output frames)."""
    monkeypatch.setattr(jlogo_model, "_HOST_OPS", False)
    ctx = JContext(level="error")
    h, w = frames[0][0].shape
    fmt = jax_format(h, w)
    entries = []
    if logos:
        jl = [jax_logo(lg) for lg in logos]
        m = jlogo_model.LogoFrameMatcher(ctx, jl)
        m.scan_frames((jfg_mod.normalize_u8(f[0]) for f in frames), w, h,
                      fmt.frame_rate_num / fmt.frame_rate_denom, batch=batch,
                      fade_steps=11)
        entries.append((jl[m.select_logo()], m.fade_curve()))
    eraser = JEraser(ctx, entries, w, h)
    fg = jfg_mod.FilterGraph(ctx, mode=mode, batch=batch,
                             post_chain=jfg_mod.build_post_chain(post_filter))
    fg._host_backend = False  # the device path, not the host twins
    fg.quantize_output = True
    if resize is not None:
        fg.resize = tuple(resize)
    if qp_source is not None:
        fg.qp_source = _jax_qp_source([r.qp for r in qp_source.results])
    if mode == "yadif":
        _yadif_as_on_tpu(fg)
    depth = 10 if frames[0][0].dtype == np.uint16 else 8
    filtered = not (mode == "none" and fg.post_chain is None)
    post10 = (depth == 10 and not eraser and mode == "none"
              and fg.post_chain is not None)
    if post10:
        fg.src_bits = 10
    src = list(frames)
    if depth == 10 and not post10 and (filtered or eraser):
        src = [tuple(((p.astype(np.int32) + 2) >> 2).clip(0, 255).astype(
            np.uint8) for p in f) for f in src]

    def stream():
        return eraser.erase_iter(iter(src), batch) if eraser else iter(src)

    if mode in fg.KFM_FAMILY:
        fg.analyze((p[0] for p in stream()), len(src))
    spec = fg.output_spec(len(src), fmt)
    outs = []

    class Pump:
        put = outs.append

    if not filtered:
        outs.extend(stream())
    else:
        _pump_filtered(fg, stream(), Pump(), batch)
    return fg, spec, [tuple(np.asarray(p) for p in f) for f in outs]


def port_post_stage(frames, logos, batch, **kw):
    outs = []
    h, w = frames[0][0].shape
    res = run_filter_stage(AMTContext(level="error"), lambda: iter(frames),
                           len(frames), synth_clip.video_format(h, w), logos,
                           sink=outs.append, batch=batch, device="cpu", **kw)
    return res, outs


def assert_same_graph(res, jfg, jspec, outs, jouts, what,
                      tie_share=golden.POST_TIE_SHARE):
    """Decisions, plan, output spec and debug dump identical; frames within
    the post-chain rule of utils.golden."""
    fg = res.graph
    if jfg.decisions is None:
        assert fg.decisions is None
    else:
        assert ([(int(d.mode), d.phase) for d in fg.decisions]
                == [(int(d.mode), d.phase) for d in jfg.decisions])
        assert fg.vfr_plan.source_frames == jfg.vfr_plan.source_frames
    for k in ("num_out_frames", "time_codes", "durations"):
        assert getattr(res.spec, k) == getattr(jspec, k), k
    for k in ("width", "height", "sar_width", "sar_height", "frame_rate_num",
              "frame_rate_denom", "progressive"):
        assert getattr(res.spec.out_format, k) == getattr(
            jspec.out_format, k), k
    n = len(outs[0][0]) if outs else 0
    assert fg.debug_dump(n) == jfg.debug_dump(n)
    assert len(outs) == len(jouts) == res.num_out_frames
    return golden.assert_post_matches(golden.stack_planes(outs),
                                      golden.stack_planes(jouts), what,
                                      tie_share)


@pytest.fixture(scope="module")
def small_clip():
    frames, _, logos, _ = synth_clip.golden_clip(golden.POST_CLIP)
    return frames, logos


@pytest.fixture(scope="module")
def port_post_outputs(small_clip):
    """{configuration: (stage result, output frames)} of the port on the
    CPU over the recorded clip."""
    frames, logos = small_clip
    out = {}
    for name in golden.POST_CONFIGS:
        f, lg, kw = golden.post_stage_inputs(name, frames, logos)
        out[name] = port_post_stage(f, lg, golden.POST_BATCH, **kw)
    return out


@pytest.mark.parametrize("name", list(golden.POST_CONFIGS))
def test_stage_configuration_matches_jax(name, small_clip, port_post_outputs,
                                         monkeypatch):
    frames, logos = small_clip
    f, lg, kw = golden.post_stage_inputs(name, frames, logos)
    mode = kw.pop("mode")
    jfg, jspec, jouts = jax_post_stage(f, lg, mode, golden.POST_BATCH,
                                       monkeypatch, **kw)
    res, outs = port_post_outputs[name]
    assert_same_graph(res, jfg, jspec, outs, jouts, name,
                      golden.POST_CONFIGS[name].get("tie_share",
                                                    golden.POST_TIE_SHARE))
    bits = golden.POST_CONFIGS[name].get("bits", 8)
    assert outs[0][0].dtype == (np.uint16 if bits == 10 else np.uint8)


@pytest.mark.parametrize("name", list(golden.POST_CONFIGS))
def test_port_matches_recorded_post_outputs(name, port_post_outputs):
    recorded = golden.load_post()
    assert set(recorded) == set(golden.POST_CONFIGS)
    _, outs = port_post_outputs[name]
    golden.assert_post_record(outs, recorded[name], name)


@pytest.mark.parametrize("mode,post", [("yadif", "nr"), ("kfm_vfr", "nr"),
                                       ("qtgmc", "nr,deband"),
                                       ("yadif60", "nr")])
def test_pump_padding_reaches_the_chain(mode, post, small_clip, monkeypatch):
    """A clip of 45 frames in batches of 16: the head ramp (8 frames padded
    to 16, its next frame past the padding) and the padded tail both feed
    temporal NR, in the JAX package's batching (in kfm_vfr: the output
    entries padded to a multiple of 8); outside kfm_vfr the result differs
    from the same stage without its padding."""
    frames, logos = small_clip
    jfg, jspec, jouts = jax_post_stage(frames, logos, mode, 16, monkeypatch,
                                       post_filter=post)
    res, outs = port_post_stage(frames, logos, 16, mode=mode,
                                post_filter=post)
    assert_same_graph(res, jfg, jspec, outs, jouts, f"{mode} {post}")
    if mode == "kfm_vfr":
        return
    # the same batches without their padding give other edge frames
    from amatsukaze_tpu_torch.pipeline import filter_stage

    monkeypatch.setattr(filter_stage, "pad_tail",
                        lambda items, batch: (np.stack(items), len(items)))
    _, unpadded = port_post_stage(frames, logos, 16, mode=mode,
                                  post_filter=post)
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(outs, unpadded))


@pytest.mark.parametrize("mode,post,with_logo,want", [
    ("none", "nr,deband,edge", False, np.uint16),
    ("none", "", False, np.uint16),
    ("none", "nr", True, np.uint8),
    ("yadif", "nr", False, np.uint8),
    ("kfm_vfr", "", False, np.uint8),
    ("none", "", True, np.uint8),
])
def test_10bit_rule(mode, post, with_logo, want, small_clip, monkeypatch):
    """uint16 sources: mode none without a logo to erase keeps 10 bits
    (the chain runs from and to 10 bits, or the planes pass through);
    every other graph filters the (x + 2) >> 2 downconvert."""
    frames, logos = small_clip
    f10 = synth_clip.to_10bit(frames[:21], 9)
    lg = logos if with_logo else []
    jfg, jspec, jouts = jax_post_stage(f10, lg, mode, 8, monkeypatch,
                                       post_filter=post)
    res, outs = port_post_stage(f10, lg, 8, mode=mode, post_filter=post)
    assert outs[0][0].dtype == want
    assert res.graph.src_bits == jfg.src_bits == (
        10 if want == np.uint16 and post else 8)
    assert_same_graph(res, jfg, jspec, outs, jouts, f"10-bit {mode} {post}")
    if want == np.uint16 and not post:
        assert all(np.array_equal(a[0], b[0]) for a, b in zip(outs, f10))


def test_mode_none_resize_without_chain_matches_jax(small_clip):
    """Mode none with a resize and no post chain: the port resizes, so the
    frames have the size output_spec declares, and they equal the JAX
    FilterGraph's driven through `_pump_filtered` (the JAX pipeline's
    `_encode_one` skips the graph in this case and hands on unresized
    frames under the resized header; the port keeps the consistent one)."""
    frames = small_clip[0][:21]
    size = golden.resize_for(96, 128)
    res, outs = port_post_stage(frames, [], 8, mode="none", resize=size)
    jfg = jfg_mod.FilterGraph(JContext(level="error"), mode="none", batch=8)
    jfg._host_backend = False
    jfg.quantize_output = True
    jfg.resize = size
    jspec = jfg.output_spec(len(frames), jax_format(96, 128))
    jouts = []

    class Pump:
        put = jouts.append

    _pump_filtered(jfg, iter(frames), Pump(), 8)
    assert (res.spec.out_format.width, res.spec.out_format.height) == size
    assert (jspec.out_format.width, jspec.out_format.height) == size
    assert len(outs) == len(jouts) == res.num_out_frames == 21
    for planes in outs:
        assert [p.shape for p in planes] == [
            (size[1], size[0]), (size[1] // 2, size[0] // 2),
            (size[1] // 2, size[0] // 2)]
    golden.assert_post_matches(
        golden.stack_planes(outs),
        golden.stack_planes([tuple(np.asarray(p) for p in f)
                             for f in jouts]), "none + resize")


def test_resize_and_double_rate_output_spec():
    fg = FilterGraph(AMTContext(), mode="qtgmc", device="cpu")
    fg.resize = (112, 64)
    jfg = jfg_mod.FilterGraph(JContext(), mode="qtgmc")
    jfg.resize = (112, 64)
    spec = fg.output_spec(45, synth_clip.video_format(96, 128))
    jspec = jfg.output_spec(45, jax_format(96, 128))
    assert spec.num_out_frames == jspec.num_out_frames == 90
    for k in ("width", "height", "sar_width", "frame_rate_num",
              "frame_rate_denom", "progressive"):
        assert getattr(spec.out_format, k) == getattr(jspec.out_format, k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate testdata/golden_post.npz")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do without --write")

    class Patch:
        @staticmethod
        def setattr(obj, name, value):
            setattr(obj, name, value)

    frames, _, logos, _ = synth_clip.golden_clip(golden.POST_CLIP)
    out = {}
    for name in golden.POST_CONFIGS:
        f, lg, kw = golden.post_stage_inputs(name, frames, logos)
        mode = kw.pop("mode")
        _, _, jouts = jax_post_stage(f, lg, mode, golden.POST_BATCH, Patch,
                                     **kw)
        _, outs = port_post_stage(f, lg, golden.POST_BATCH, mode=mode, **kw)
        out[name] = jouts
        cfg = golden.POST_CONFIGS[name]
        if cfg.get("exact"):
            assert golden.post_digests(outs) == golden.post_digests(jouts), (
                f"{name}: the port's frames are no longer the JAX package's "
                f"bit for bit")
            one = 0
        else:
            one = golden.assert_post_matches(
                golden.stack_planes(outs), golden.stack_planes(jouts), name,
                cfg.get("tie_share", golden.POST_TIE_SHARE))
        print(f"{name}: {len(jouts)} frames, port == JAX on the CPU but for "
              f"{one} samples one code value apart")
    golden.save_post(out)
    print(f"wrote {golden.POST_PATH} ({golden.POST_PATH.stat().st_size} "
          f"bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
