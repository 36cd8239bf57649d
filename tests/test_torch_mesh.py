"""The multi-device filter path on the CPU against the JAX package's mesh.

The JAX package runs its mesh on the 8 virtual CPU devices of conftest.py;
the port runs the same number of logical shards on the CPU (`["cpu"] * n`),
at n = 2, 4 and 8, over seeded numpy frames at 96x64 (the JAX tests' size):

- ops.deint.field_match_costs_from_prev: equal to field_match_costs over
  the concatenation (exact, in the dtype given);
- ShardedFilterBackend: the costs at a batch that no n divides (exact
  against the port's unsharded kernel plain version; against the JAX mesh
  within rtol 1e-5, atol 1e-4: the JAX costs are float32 sums in another
  order), deint in yadif / yadif60 / qtgmc (float frames bit-equal to the
  JAX mesh's) and K1's plain uint8 equal to the rounded float yadif,
  kfm_synth (every row, padding included, bit-equal);
- FilterGraph.set_mesh in kfm_vfr (decisions, plan, frames), kfm_vfr +
  nr,deband,edge, yadif / yadif60 / qtgmc and none + nr,deband: frames
  bit-equal to the JAX mesh's, decisions and plan identical;
- where the JAX mesh differs from the JAX single device (kfm_synth pads
  to n * ceil(n_e / n) entries, the single device to a multiple of 8, and
  temporal NR reads the padding at the batch's ends): recorded, and the
  port follows the JAX mesh;
- sharded_pipeline_step and sharded_hbd_chain: frames, presence and the
  10-bit chain bit-equal; costs within rtol 1e-5, atol 1e-4; K3's scores
  (its plain version here) within rtol 1e-5, atol 1e-5 (test_torch_logo.py:
  float32 sums in another order);
- run_filter_stage(filter_devices=n) equal to the unsharded stage in
  kfm_vfr and yadif, where the JAX mesh equals the JAX single device;
- make_mesh raising without a CUDA device.
"""

import functools

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401
import torch

import jax
import jax.numpy as jnp

from amatsukaze_tpu.models import filter_graph as jfg_mod
from amatsukaze_tpu.models.kfm import VFRPlan as JVFRPlan
from amatsukaze_tpu.ops import deint as jdeint
from amatsukaze_tpu.ops import denoise as jdn
from amatsukaze_tpu.ops.logo import LogoEvalParams as JLogoEvalParams
from amatsukaze_tpu.ops.logo_ref import LogoEvalRef as JLogoEvalRef
from amatsukaze_tpu.parallel import mesh as jmesh
from amatsukaze_tpu.parallel.sharded_filter import (
    ShardedFilterBackend as JBackend)
from amatsukaze_tpu.utils.context import AMTContext as JContext
from test_sharded_filter import _frames, _telecined  # the JAX tests' inputs

from amatsukaze_tpu_torch.models.filter_graph import (FilterGraph,
                                                      build_post_chain)
from amatsukaze_tpu_torch.models.kfm import VFRPlan
from amatsukaze_tpu_torch.ops import deint as tdeint
from amatsukaze_tpu_torch.ops import fused_filter
from amatsukaze_tpu_torch.ops.logo import LogoEvalParams
from amatsukaze_tpu_torch.ops.logo_ref import LogoEvalRef
from amatsukaze_tpu_torch.parallel import mesh as tmesh
from amatsukaze_tpu_torch.parallel.sharded_filter import ShardedFilterBackend
from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
from amatsukaze_tpu_torch.utils import synth_clip
from amatsukaze_tpu_torch.utils.context import AMTContext

W, H = 96, 64
SHARDS = (2, 4, 8)
COST_TOL = dict(rtol=1e-5, atol=1e-4)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _jmesh(n):
    return jmesh.make_mesh(jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jbackend(n):
    """One JAX backend per mesh width: it keeps its jitted functions, so
    the tests share their compilations."""
    return JBackend(_jmesh(n))


def _tmesh(n):
    return tmesh.make_mesh([CPU] * n)


# ---------------------------------------------------------------------------
# the backend's primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_costs_from_prev_equals_concat(dtype):
    fr = torch.from_numpy(_frames(9)).to(dtype)
    prev = torch.from_numpy(_frames(1, seed=3)[0]).to(dtype)
    got = tdeint.field_match_costs_from_prev(fr, prev)
    want = tdeint.field_match_costs(torch.cat([prev[None], fr]))[1:]
    assert torch.equal(got, want)
    j = jdeint.field_match_costs_from_prev(
        jnp.asarray(fr.numpy(), jnp.float32),
        jnp.asarray(prev.numpy(), jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(j), **COST_TOL)


@pytest.mark.parametrize("n", SHARDS)
def test_backend_costs(n):
    fr = _frames(21)  # no n divides 21: the padding runs
    got = ShardedFilterBackend(_tmesh(n)).field_match_costs(fr)
    _, want = fused_filter.yadif_fieldmatch(torch.from_numpy(fr),
                                            write_frames=False,
                                            with_costs=True)
    assert torch.equal(got, want)
    j = np.asarray(_jbackend(n).field_match_costs(fr))
    np.testing.assert_allclose(got.numpy(), j, **COST_TOL)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("mode", ["yadif", "yadif60", "qtgmc"])
def test_backend_deint(mode, n):
    fr = _frames(11, seed=n)
    halos = [(_frames(1, seed=1)[0], _frames(1, seed=2)[0]), (None, None)]
    tb, jb = ShardedFilterBackend(_tmesh(n)), _jbackend(n)
    for prev, nxt in halos:
        got = tb.deint(mode, fr, prev, nxt)
        want = np.asarray(jb.deint(mode, fr, prev, nxt))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        if mode == "qtgmc":
            continue
        # K1 (here its plain version) where the caller rounds to uint8
        k1 = tb.deint(mode, fr, prev, nxt, rounded=True)
        assert k1.dtype == torch.uint8
        assert torch.equal(k1, torch.floor(got + 0.5).clamp(0, 255)
                           .to(torch.uint8))


@pytest.mark.parametrize("n", SHARDS)
def test_backend_kfm_synth(n):
    fr = _frames(21, seed=4)
    prev = _frames(1, seed=5)[0]
    ops = [VFRPlan.WEAVE, VFRPlan.MERGE_PREV, VFRPlan.BOB_T, VFRPlan.BOB_B]
    entries = [(s, ops[s % 4]) for s in range(21) if s % 5 != 3]
    got, n_e = ShardedFilterBackend(_tmesh(n)).kfm_synth(fr, prev, entries)
    want, j_n_e = _jbackend(n).kfm_synth(fr, prev, entries)
    assert n_e == j_n_e == len(entries)
    assert len(got) == n * -(-n_e // n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_put_batch_pads_and_slices():
    fr = _frames(7)
    out = ShardedFilterBackend(_tmesh(4)).put_batch(fr)
    assert torch.equal(out, torch.from_numpy(fr))


# ---------------------------------------------------------------------------
# FilterGraph.set_mesh against the JAX FilterGraph on its mesh
# ---------------------------------------------------------------------------

def _drive(fg, frames, batch, materialize):
    """One plane through a FilterGraph as the JAX mesh tests drive it."""
    n = len(frames)
    outs = []
    if fg.mode in FilterGraph.KFM_FAMILY:
        fg.analyze(iter(frames), n)
        prev = None
        for s in range(0, n, batch):
            chunk = frames[s:s + batch]
            outs.append(materialize(fg.run_kfm_batch(
                chunk, prev, s, final=s + batch >= n)))
            prev = chunk[-1]
    else:
        for s in range(0, n, batch):
            nxt = frames[s + batch] if s + batch < n else None
            outs.append(materialize(fg.run_pass3(
                frames[s:s + batch], frames[s - 1] if s else None, nxt,
                start_index=s)))
    return np.concatenate(outs)


def jax_graph(mode, post, n, batch=16):
    fg = jfg_mod.FilterGraph(JContext(level="error"), mode=mode, batch=batch,
                             post_chain=jfg_mod.build_post_chain(post)
                             if post else None)
    fg.quantize_output = True
    if n:
        fg.set_mesh(_jmesh(n))
        fg._mesh_backend = _jbackend(n)
    else:
        fg._host_backend = False  # the device path
    return fg


def port_graph(mode, post, n, batch=16):
    fg = FilterGraph(AMTContext(level="error"), mode=mode, batch=batch,
                     device="cpu", post_chain=build_post_chain(post))
    if n:
        fg.set_mesh(n)
    return fg


GRAPHS = {  # name: (mode, post chain, frames, batch)
    "kfm_vfr": ("kfm_vfr", "", lambda: _telecined(45), 16),
    "kfm_vfr_chain": ("kfm_vfr", "nr,deband,edge", lambda: _telecined(30),
                      15),
    "yadif": ("yadif", "", lambda: _frames(20, seed=7), 10),
    "yadif60": ("yadif60", "", lambda: _frames(20, seed=7), 10),
    "qtgmc": ("qtgmc", "", lambda: _frames(20, seed=7), 10),
    "none_chain": ("none", "nr,deband", lambda: _frames(16, seed=9), 16),
}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_filter_graph_mesh_equals_jax_mesh(name, n):
    mode, post, make, batch = GRAPHS[name]
    frames = make()
    jfg, tfg = jax_graph(mode, post, n, batch), port_graph(mode, post, n,
                                                           batch)
    want = _drive(jfg, frames, batch, np.asarray)
    got = _drive(tfg, frames, batch, lambda r: r.materialize())
    assert tfg.mesh.size == n
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if mode == "kfm_vfr":
        assert [(d.mode, d.phase) for d in tfg.decisions] == \
            [(d.mode, d.phase) for d in jfg.decisions]
        assert tfg.vfr_plan.source_frames == jfg.vfr_plan.source_frames
        assert tfg.vfr_plan.durations == jfg.vfr_plan.durations
        assert len(got) < len(frames)  # the film decimates


def test_jax_mesh_padding_differs_from_single_device():
    """A hand-set plan with bobbed entries (half-integer samples, which
    temporal NR blends) in kfm_vfr + nr,deband,edge over one batch of 12
    frames, 10 entries: the single device pads them to 16, the JAX mesh to
    n * ceil(10 / n) = 10 and 12 at n = 2 and 4. At n = 2 the JAX mesh's
    last two entries differ from its single device's (NR reads the batch's
    ends); at n = 4 they agree. The port equals the JAX mesh at both, and
    the JAX single device unsharded."""
    yy, xx = np.mgrid[0:H, 0:W]
    base = 120 + 40 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
    frames = np.stack([np.clip(base + 0.3 * i, 0, 255).astype(np.uint8)
                       for i in range(12)])
    ops = [VFRPlan.WEAVE, VFRPlan.BOB_T, VFRPlan.BOB_B, VFRPlan.MERGE_PREV]
    entries = [(s, ops[s % 4]) for s in range(12) if s % 5 != 3]
    post = "nr,deband,edge"

    def run(fg, plan_cls, materialize):
        fg.vfr_plan = plan_cls([4] * len(entries), list(entries), [])
        return materialize(fg.run_kfm_batch(frames, None, 0))

    single = run(jax_graph("kfm_vfr", post, 0), JVFRPlan, np.asarray)
    assert np.array_equal(single, run(port_graph("kfm_vfr", post, 0),
                                      VFRPlan, lambda r: r.materialize()))
    for n in (2, 4):
        j = run(jax_graph("kfm_vfr", post, n), JVFRPlan, np.asarray)
        t = run(port_graph("kfm_vfr", post, n), VFRPlan,
                lambda r: r.materialize())
        np.testing.assert_array_equal(t, j)
        differ = [i for i in range(len(j)) if not np.array_equal(j[i],
                                                                  single[i])]
        assert differ == ([8, 9] if n == 2 else []), (n, differ)


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def logo_ref():
    yy, xx = np.mgrid[0:8, 0:16]
    alpha = (np.clip(1.0 - np.hypot((yy - 4) / 4, (xx - 8) / 8), 0, 1)
             * 0.3).astype(np.float32)
    a = (1.0 / (1.0 - alpha)).astype(np.float32)
    b = (-alpha * 200.0 / (1.0 - alpha) / 255.0).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_pipeline_step(logo_ref, n):
    a, b = logo_ref
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (32, 32, 128)).astype(np.float32)
    fades = rng.uniform(0, 1, 32).astype(np.float32)
    jm = _jmesh(n)
    jstep = jmesh.sharded_pipeline_step(
        jm, JLogoEvalParams.from_ref(JLogoEvalRef(a, b, maskratio=0.1)))
    jf, js, jc, jp = jstep(jmesh.shard_batch(jm, jnp.asarray(frames)),
                           jmesh.shard_batch(jm, jnp.asarray(fades)))
    tm = _tmesh(n)
    params = LogoEvalParams.from_ref(LogoEvalRef(a, b, maskratio=0.1), CPU)
    tf, ts, tc, tp = tmesh.sharded_pipeline_step(tm, params)(frames, fades)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCORE_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **COST_TOL)
    assert float(tp) == float(jp)
    # the same step unsharded
    one = tmesh.sharded_pipeline_step(tmesh.make_mesh([CPU]), params)
    for got, want in zip((tf, ts, tc, tp), one(frames, fades)):
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def hbd_case():
    """Frames and the JAX single-device chain over them."""
    frames = np.random.default_rng(6).integers(0, 256, (32, 32, 128)).astype(
        np.float32)
    x = jdn.to_14bit(jnp.asarray(frames))
    single = jdn.to_10bit(jdn.deband(jdn.temporal_nr(
        jnp.concatenate([x[:1], x, x[-1:]]), radius=1)[1:-1], 7))
    return frames, np.asarray(single)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_hbd_chain(hbd_case, n):
    frames, single = hbd_case
    jm = _jmesh(n)
    want = jmesh.sharded_hbd_chain(jm)(jmesh.shard_batch(jm, frames),
                                       jnp.asarray([7], jnp.uint32))
    got = tmesh.sharded_hbd_chain(_tmesh(n))(frames, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), single)


def test_shard_batch_places_contiguous_shards():
    arr = np.arange(16 * 2 * 3, dtype=np.float32).reshape(16, 2, 3)
    parts = tmesh.shard_batch(_tmesh(4), arr)
    assert [len(p) for p in parts] == [4] * 4
    assert torch.equal(torch.cat(parts), torch.from_numpy(arr))
    with pytest.raises(ValueError):
        tmesh.shard_batch(_tmesh(3), arr)


# ---------------------------------------------------------------------------
# the stage and the mesh's construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["kfm_vfr", "yadif"])
def test_run_filter_stage_filter_devices(mode):
    """Where the JAX mesh equals the JAX single device (no post chain), the
    port's sharded stage equals its unsharded one: logo, fade, decisions,
    plan and every frame."""
    clip, fmt, logos, batch = synth_clip.golden_clip("small")
    runs = []
    for devices in (1, 4, tmesh.make_mesh(["cpu"] * 3)):
        out = []
        res = run_filter_stage(AMTContext(level="error"),
                               lambda: iter(clip), len(clip), fmt, logos,
                               mode, out.append, batch=batch, device="cpu",
                               filter_devices=devices)
        runs.append((res, out))
    (one, one_out), *sharded = runs
    assert one.shards == 1 and one.graph.mesh is None
    for (res, out), n in zip(sharded, (4, 3)):
        assert res.shards == n == res.graph.mesh.size
        assert res.best_logo == one.best_logo
        np.testing.assert_array_equal(res.fade, one.fade)
        if mode == "kfm_vfr":
            assert res.graph.vfr_plan.source_frames == \
                one.graph.vfr_plan.source_frames
        assert len(out) == len(one_out) == one.spec.num_out_frames
        for a, b in zip(out, one_out):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)


def test_make_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    mesh = tmesh.make_mesh(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.axis == "data"
    fg = FilterGraph(AMTContext(level="error"), mode="yadif", device="cpu")
    fg.set_mesh(5)
    assert fg.mesh.devices == [CPU] * 5
    with pytest.raises(ValueError):
        tmesh.Mesh([])
