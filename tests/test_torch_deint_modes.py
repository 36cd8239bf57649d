"""The double-rate deinterlace modes on the CPU against the JAX package:
yadif with the bottom field kept (ops.deint and the yadif_fieldmatch
kernel's plain version), bob, the pieces of the motion-adaptive bob and the
bob itself, and FilterGraph.run_pass3 in yadif60 and qtgmc with and
without a post chain.

Bit-equal: yadif in both parities, bob, _dilate3x3, _mc_temporal. The
motion-adaptive bob within 1e-3 (XLA on the CPU may contract its blend
`w * a + (1 - w) * b` into fused multiply-adds); its uint8 frames at most
one code value apart.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401
import torch

import jax.numpy as jnp

from amatsukaze_tpu.models import filter_graph as jfg_mod
from amatsukaze_tpu.ops import deint as jdeint
from amatsukaze_tpu.utils.context import AMTContext as JContext
from test_torch_post_chain import _jax_qp_source

from amatsukaze_tpu_torch.models.filter_graph import (FilterGraph,
                                                      build_post_chain)
from amatsukaze_tpu_torch.ops import deint as tdeint
from amatsukaze_tpu_torch.ops import fused_filter as ff
from amatsukaze_tpu_torch.ts.qp_extract import QpMapSource
from amatsukaze_tpu_torch.utils import synth_clip
from amatsukaze_tpu_torch.utils.context import AMTContext

TOL_8BIT = 1e-3


def _u8(b=6, h=32, w=40, seed=0, levels=256):
    """uint8 frames; few levels make the direction search tie often."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, (b, h, w)) * (255 // max(levels - 1, 1))
            ).astype(np.uint8)


def _neighbours(x):
    """(prev, cur, next) of a float batch with the ends replicated."""
    return (np.concatenate([x[:1], x[:-1]]), x,
            np.concatenate([x[1:], x[-1:]]))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("levels", [256, 7, 2])
@pytest.mark.parametrize("parity_top", [True, False])
def test_yadif_both_parities_bit_equal(levels, parity_top):
    x = _u8(seed=levels, levels=levels).astype(np.float32)
    p, c, n = _neighbours(x)
    want = np.asarray(jdeint.yadif_deinterlace(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(n), parity_top))
    got = tdeint.yadif_deinterlace(*_t(p, c, n), parity_top).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 16, 24), (5, 38, 33), (1, 8, 17)])
def test_bottom_parity_is_top_parity_rotated(shape):
    """Values in steps of 40 force ties: keeping the bottom field equals
    keeping the top field of the frames turned by 180 degrees, turned
    back, bit for bit (a vertical flip alone breaks ties the other way).
    For the float chain, and for the kernel's plain version on uint8."""
    b, h, w = shape
    g = (np.random.default_rng(h).integers(0, 7, shape) * 40).astype(
        np.uint8)
    rot = g[:, ::-1, ::-1]
    p, c, n = _neighbours(g.astype(np.float32))
    rp, rc, rn = _neighbours(rot.astype(np.float32))
    bottom = tdeint.yadif_deinterlace(*_t(p, c, n), False)
    top = tdeint.yadif_deinterlace(*_t(rp, rc, rn), True)
    assert torch.equal(bottom, torch.flip(top, (1, 2)))
    kb, _ = ff.yadif_fieldmatch(torch.from_numpy(g), parity_top=False)
    kt, _ = ff.yadif_fieldmatch(torch.from_numpy(np.ascontiguousarray(rot)))
    assert torch.equal(kb, torch.flip(kt, (1, 2)))
    jb = np.asarray(jdeint.yadif_deinterlace(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(n), False))
    np.testing.assert_array_equal(bottom.numpy(), jb)
    # the flip alone is not the same function on tie-heavy frames
    fp, fc, fn = _neighbours(np.ascontiguousarray(g[:, ::-1]).astype(
        np.float32))
    flipped = tdeint.yadif_deinterlace(*_t(fp, fc, fn), True)
    if h > 8:
        assert not torch.equal(bottom, torch.flip(flipped, (1,)))


@pytest.mark.parametrize("b", [1, 2, 7])
def test_kernel_plain_version_bottom_parity(b):
    """yadif_fieldmatch(parity_top=False) on a CPU tensor: the JAX
    package's yadif_deinterlace(..., False), rounded, with the batch ends
    replicated; the launch counter does not move."""
    frames = _u8(b=b, h=26, w=36, seed=b)
    p, c, n = _neighbours(frames.astype(np.float32))
    want = np.clip(np.floor(np.asarray(jdeint.yadif_deinterlace(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(n), False)) + 0.5),
        0, 255).astype(np.uint8)
    before = sum(ff.yadif_fieldmatch.launches.values())
    got, costs = ff.yadif_fieldmatch(torch.from_numpy(frames),
                                     parity_top=False)
    assert costs is None
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(ff.yadif_fieldmatch.launches.values()) == before
    np.testing.assert_array_equal(
        got[:, 1::2].numpy(), frames[:, 1::2])  # the kept field


@pytest.mark.parametrize("kw", [dict(with_costs=True),
                                dict(write_frames=False, with_costs=True),
                                dict(erase="box")])
def test_bottom_parity_is_frames_only(kw):
    x = torch.zeros((3, 8, 8), dtype=torch.uint8)
    if kw.get("erase") == "box":
        a = torch.ones((2, 2))
        kw = dict(erase=ff.EraseBox(a, a, torch.ones(3), 0, 0))
    with pytest.raises(ValueError, match="frames-only"):
        ff.yadif_fieldmatch(x, parity_top=False, **kw)


def test_mode_name_of_bottom_parity():
    assert ff.mode_name(True, False, None, parity_top=False) == "yadif_bottom"
    assert ff.mode_name(True, False, None) == "yadif"


@pytest.mark.parametrize("parity_top", [True, False])
def test_bob_field_bit_equal(parity_top):
    fld = _u8(b=3, h=12, w=20, seed=3).astype(np.float32)
    np.testing.assert_array_equal(
        tdeint.bob_field(torch.from_numpy(fld), parity_top).numpy(),
        np.asarray(jdeint.bob_field(jnp.asarray(fld), parity_top)))


@pytest.mark.parametrize("seed", [0, 1])
def test_dilate_and_mc_temporal_bit_equal(seed):
    x = _u8(b=4, h=16, w=30, seed=seed, levels=9).astype(np.float32)
    np.testing.assert_array_equal(
        tdeint._dilate3x3(torch.from_numpy(x)).numpy(),
        np.asarray(jdeint._dilate3x3(jnp.asarray(x))))
    tp, tn = x[:2], x[2:]
    for shift in (1, 3):
        got = tdeint._mc_temporal(*_t(tp, tn), max_shift=shift)
        want = jdeint._mc_temporal(jnp.asarray(tp), jnp.asarray(tn),
                                   max_shift=shift)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("levels", [256, 5])
def test_motion_adaptive_bob_within_tolerance(tff, levels):
    x = _u8(b=5, h=24, w=40, seed=levels, levels=levels).astype(np.float32)
    p, c, n = _neighbours(x)
    got = tdeint.motion_adaptive_bob(*_t(p, c, n), tff).numpy()
    want = np.asarray(jdeint.motion_adaptive_bob(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(n), tff))
    assert got.shape == (10, 24, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_8BIT)
    q = lambda v: np.clip(np.floor(v + 0.5), 0, 255)  # noqa: E731
    assert np.abs(q(got) - q(want)).max() <= 1


def _graphs(mode, post, qp_maps, resize=None):
    fg = FilterGraph(AMTContext(), mode=mode, batch=6, device="cpu",
                     post_chain=build_post_chain(post),
                     qp_source=None if qp_maps is None
                     else QpMapSource.from_maps(qp_maps))
    jfg = jfg_mod.FilterGraph(JContext(level="error"), mode=mode, batch=6,
                              post_chain=jfg_mod.build_post_chain(post))
    jfg._host_backend = False
    jfg.quantize_output = True
    if qp_maps is not None:
        jfg.qp_source = _jax_qp_source(qp_maps)
    fg.resize = jfg.resize = resize
    return fg, jfg


@pytest.mark.parametrize("mode", ["yadif60", "qtgmc"])
@pytest.mark.parametrize("post,qp,resize", [
    ("", False, None), ("nr", False, None), ("deblock,nr", True, None),
    ("", False, (48, 32))])
def test_run_pass3_double_rate_matches_jax(mode, post, qp, resize):
    """One batch with halo frames on both sides, at a start index past 0:
    2B frames in field order; QP maps indexed per field pair; the uint8
    frames equal (one code value at float rounding ties where the chain
    deblocks or the frames are resized or bobbed by motion)."""
    frames = [f[0] for f in synth_clip.golden_clip("small")[0][10:18]]
    frames = np.stack(frames)[:, :64, :96]
    maps = synth_clip.qp_maps(30, 2, 4, 6) if qp else None
    fg, jfg = _graphs(mode, post, maps, resize)
    prev, batch, nxt = frames[0], frames[1:7], frames[7]
    got = fg.run_pass3(batch, prev, nxt, start_index=11).materialize()
    want = np.asarray(jfg.run_pass3(batch, prev, nxt, start_index=11))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (
        12, *((32, 48) if resize else (64, 96)))
    d = np.abs(got.astype(int) - want.astype(int))
    exact = mode == "yadif60" and not qp and resize is None
    assert d.max() <= (0 if exact else 1)
    assert np.count_nonzero(d) <= 1e-3 * d.size
    if qp:
        # the maps of frames 11..16, each twice: another start index moves
        # them (and so the deblocked frames)
        other = fg.run_pass3(batch, prev, nxt, start_index=3).materialize()
        assert not np.array_equal(got, other)


def test_yadif60_without_chain_launches_both_parities(monkeypatch):
    """yadif60 with nothing after it goes through the kernel wrapper once
    per parity; with a chain it takes the float yadif instead."""
    calls = []
    real = ff.yadif_fieldmatch

    def counted(frames, **kw):
        calls.append(kw.get("parity_top", True))
        return real(frames, **kw)

    monkeypatch.setattr(ff, "yadif_fieldmatch", counted)
    frames = _u8(b=4, h=16, w=24, seed=4)
    fg, _ = _graphs("yadif60", "", None)
    out = fg.run_pass3(frames, None, None).materialize()
    assert calls == [True, False] and out.shape == (8, 16, 24)
    fg, _ = _graphs("yadif60", "nr", None)
    fg.run_pass3(frames, None, None)
    assert calls == [True, False]


def test_double_rate_output_spec_and_dump():
    for mode in ("yadif60", "qtgmc"):
        fg, jfg = _graphs(mode, "deblock", synth_clip.qp_maps(5, 1, 2, 2))
        fmt = synth_clip.video_format(64, 96)
        jfmt = jfg_mod.VideoFormat()
        jfmt.width, jfmt.height = 96, 64
        jfmt.frame_rate_num, jfmt.frame_rate_denom = 30000, 1001
        spec, jspec = fg.output_spec(45, fmt), jfg.output_spec(45, jfmt)
        assert spec.num_out_frames == jspec.num_out_frames == 90
        assert (spec.out_format.frame_rate_num,
                spec.out_format.frame_rate_denom,
                spec.out_format.progressive) == (
            jspec.out_format.frame_rate_num,
            jspec.out_format.frame_rate_denom, jspec.out_format.progressive)
        assert fg.debug_dump(45) == jfg.debug_dump(45)
        assert fg.debug_dump(45)["qp_source_frames"] == 5
