"""The svp and autovfr modes of the filter graph and the stage on the CPU,
against the JAX package.

svp: ops.deint.mc_frame_interp against the JAX function (within 3.1e-5,
two float32 steps at 255: XLA fuses some of its cross-fades into
multiply-adds); FilterGraph's svp synthesis as the JAX package's TestSvp
holds it (count and rate, batches that split the clip give the frames of
one batch, the interpolation follows a pan), equal to the JAX graph's
frames after the rounding; the pump's last call that holds no film frame
and emits only the frozen tail, with a post chain, against the JAX
pipeline's `_pump_filtered`. The recorded 96x128 configurations "svp" and
"svp_nr" are in tests/test_torch_post_chain.py.

autovfr: as the JAX package's TestAutoVfr (equal to the single-stream
analysis, decisions independent of `parallel`, an empty section padded,
the file contracts, here also byte-equal to the JAX package's files), the
stage in mode autovfr against the JAX composition (analysis of the source
luma in sections, output of the erased frames), and the record of the
96x128 broadcast layout at parallel 1, 2 and 3
(testdata/golden_autovfr.json):

    python tests/test_torch_fps_modes.py --write

rewrites the record from the JAX package and checks the port against it.
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
from amatsukaze_tpu.models.filter_graph import \
    FilterGraph as JFilterGraph  # noqa: E402
from amatsukaze_tpu.ops import deint as jdeint  # noqa: E402
from amatsukaze_tpu.parallel.ordered import \
    ordered_parallel as j_ordered_parallel  # noqa: E402
from amatsukaze_tpu.utils.context import AMTContext as JContext  # noqa: E402
from test_filter_fps_modes import (H, W, interlaced_video_frames,  # noqa: E402
                                   telecined_frames)
from test_torch_filter_stage import jax_format  # noqa: E402
from test_torch_post_chain import (assert_same_graph,  # noqa: E402
                                   jax_post_stage)

from amatsukaze_tpu_torch.models.filter_graph import FilterGraph  # noqa: E402
from amatsukaze_tpu_torch.models.kfm import CycleMode  # noqa: E402
from amatsukaze_tpu_torch.ops import deint  # noqa: E402
from amatsukaze_tpu_torch.parallel.ordered import \
    ordered_parallel  # noqa: E402
from amatsukaze_tpu_torch.pipeline.filter_stage import \
    run_filter_stage  # noqa: E402
from amatsukaze_tpu_torch.utils import golden, synth_clip  # noqa: E402
from amatsukaze_tpu_torch.utils.context import AMTContext  # noqa: E402

INTERP_TOL = 3.1e-5  # two float32 steps at 255


def _graph(mode, frames, batch=16):
    fg = FilterGraph(AMTContext(level="error"), mode=mode, batch=batch,
                     device="cpu")
    fg.analyze(iter(frames), len(frames))
    return fg


def _jgraph(mode, frames, batch=16):
    fg = JFilterGraph(JContext(level="error"), mode=mode, batch=batch)
    fg.analyze(iter(frames), len(frames))
    return fg


def _fmt():
    return synth_clip.video_format(H, W)


def _decisions(fg):
    return [(int(d.mode), d.phase) for d in fg.decisions]


def _jax_svp(frames, splits, final_at):
    """The JAX graph's svp output over chunks [s, e) of `frames`, rounded
    as the port rounds: float frames -> uint8."""
    fg = _jgraph("svp", frames)
    outs, prev = [], None
    for s, e in splits:
        chunk = np.stack(frames[s:e])
        out = np.asarray(fg.run_kfm_batch(chunk, prev, s, plane=0,
                                          final=e >= final_at))
        outs.append(np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8))
        prev = frames[e - 1]
    return fg, np.concatenate([o for o in outs if len(o)])


# ---------------------------------------------------------------------------
# svp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [0.2, 0.4, 0.6, 0.8])
def test_mc_frame_interp_matches_jax(frac):
    rng = np.random.default_rng(int(frac * 10))
    a = rng.integers(0, 256, (3, 32, 48)).astype(np.float32)
    b = np.roll(a, 2, axis=2) + rng.integers(-3, 4, a.shape)
    b = b.astype(np.float32)
    got = deint.mc_frame_interp(torch.from_numpy(a), torch.from_numpy(b),
                                frac).numpy()
    want = np.asarray(jdeint.mc_frame_interp(jnp.asarray(a), jnp.asarray(b),
                                             frac))
    np.testing.assert_allclose(got, want, rtol=0, atol=INTERP_TOL)


def test_svp_output_count_and_rate():
    frames = telecined_frames(50)
    spec = _graph("svp", frames).output_spec(len(frames), _fmt())
    jspec = _jgraph("svp", frames).output_spec(len(frames), jax_format(H, W))
    # 40 film frames -> ceil(40 * 2.5) = 100 at 60p
    assert spec.num_out_frames == jspec.num_out_frames == 100
    assert (spec.out_format.frame_rate_num,
            spec.out_format.frame_rate_denom) == (60000, 1001)
    assert not spec.time_codes and spec.out_format.progressive


def test_svp_batch_boundaries_match_single_batch():
    frames = telecined_frames(50)
    fg1 = _graph("svp", frames)
    whole = fg1.run_kfm_batch(np.stack(frames), None, 0, plane=0,
                              final=True).materialize()
    fg2 = _graph("svp", frames)
    parts, prev = [], None
    for s in range(0, 50, 20):
        chunk = frames[s:s + 20]
        parts.append(fg2.run_kfm_batch(np.stack(chunk), prev, s, plane=0,
                                       final=s + 20 >= 50).materialize())
        prev = chunk[-1]
    split = np.concatenate(parts)
    assert len(whole) == len(split) == 100
    np.testing.assert_array_equal(whole, split)
    _, jwhole = _jax_svp(frames, [(0, 50)], 50)
    np.testing.assert_array_equal(whole, jwhole)


def test_svp_interpolation_tracks_pan():
    """On a sharp-textured pure pan the MC interpolator beats the
    cross-fade (the point of svp over a simple blend)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(11)
    pan, n_film = 3, 20
    wide = gaussian_filter(
        rng.uniform(20, 235, (H, W + pan * n_film + 8)), 1.0)

    def film(t):
        s = pan * t
        i0 = int(np.floor(s))
        f = s - i0
        return ((1 - f) * wide[:, i0:i0 + W]
                + f * wide[:, i0 + 1:i0 + 1 + W]).astype(np.float32)

    def wv(top, bot):
        f = np.empty((H, W), np.float32)
        f[0::2] = top[0::2]
        f[1::2] = bot[1::2]
        return f.astype(np.uint8)

    frames, i = [], 0
    while len(frames) < 25:
        a, b, c, d = (film(i), film(i + 1), film(i + 2), film(i + 3))
        frames += [wv(a, a), wv(a, b), wv(b, c), wv(c, c), wv(d, d)]
        i += 4
    frames = frames[:25]
    fg = _graph("svp", frames)
    assert all(d.mode == CycleMode.FILM for d in fg.decisions)
    out = fg.run_kfm_batch(np.stack(frames), None, 0, plane=0,
                           final=True).materialize()
    assert len(out) == 50  # 20 film frames -> 50 at 60p
    crop = np.s_[2:-2, 8:-8]
    truth = film(0.4)[crop]  # j=1: frac 0.4 between film frames 0 and 1
    mc_err = np.mean(np.abs(out[1][crop].astype(np.float64) - truth))
    blend = 0.6 * film(0.0) + 0.4 * film(1.0)
    blend_err = np.mean(np.abs(blend[crop] - truth))
    assert mc_err < blend_err * 0.6, (mc_err, blend_err)
    _, jout = _jax_svp(frames, [(0, 25)], 25)
    assert np.abs(out.astype(int) - jout.astype(int)).max() <= 1


def test_svp_final_call_without_film_emits_the_tail():
    """52 frames: the plan drops the trailing partial cycle, so the last
    batch [48, 52) holds no film frame; its final call emits the frozen
    tail from the carry, as the JAX graph's does."""
    frames = telecined_frames(52)
    fg = _graph("svp", frames)
    splits = [(0, 24), (24, 48), (48, 52)]
    outs, prev = [], None
    for s, e in splits:
        res = fg.run_kfm_batch(np.stack(frames[s:e]), prev, s, plane=0,
                               final=e >= 52)
        outs.append(res.materialize())
        prev = frames[e - 1]
    assert [len(o) for o in outs][-1] > 0
    assert not fg._svp_carry
    jfg, jout = _jax_svp(frames, splits, 52)
    got = np.concatenate(outs)
    assert len(got) == fg.output_spec(52, _fmt()).num_out_frames == len(jout)
    np.testing.assert_array_equal(got, jout)


@pytest.mark.parametrize("n,post", [(42, "nr"), (45, "")])
def test_svp_stage_final_path_matches_jax(n, post, monkeypatch):
    """The stage's pump passes final=True to the last chunk: at 42 frames
    in batches of 8 that chunk [40, 42) holds no film frame, and its tail
    goes through the post chain alone; frames within the svp_nr record's
    rule of the JAX pipeline's."""
    frames, _, logos, _ = synth_clip.golden_clip("small")
    frames = frames[:n]
    jfg, jspec, jouts = jax_post_stage(frames, logos, "svp", 8, monkeypatch,
                                       post_filter=post)
    outs = []
    res = run_filter_stage(AMTContext(level="error"), lambda: iter(frames),
                           n, synth_clip.video_format(96, 128), logos, "svp",
                           outs.append, batch=8, device="cpu",
                           post_filter=post)
    assert res.num_out_frames == (len(res.graph.vfr_plan.durations) * 5
                                  + 1) // 2
    assert_same_graph(res, jfg, jspec, outs, jouts, f"svp {n} {post}",
                      golden.POST_CONFIGS["svp_nr"]["tie_share"])


# ---------------------------------------------------------------------------
# autovfr
# ---------------------------------------------------------------------------

def _opener(frames):
    def opener(start, end):
        return iter(frames[max(0, start):end])

    return opener


def _autovfr(frames, parallel, prefix=None, opener=None, batch=16):
    fg = FilterGraph(AMTContext(level="error"), mode="autovfr", batch=batch,
                     device="cpu")
    sections = []
    fg.analyze_autovfr(opener or _opener(frames), len(frames),
                       parallel=parallel, log_prefix=prefix,
                       sections_log=sections)
    return fg, sections


def _jautovfr(frames, parallel, prefix=None, opener=None, batch=16):
    fg = JFilterGraph(JContext(level="error"), mode="autovfr", batch=batch)
    sections = []
    fg.analyze_autovfr(opener or _opener(frames), len(frames),
                       parallel=parallel, log_prefix=prefix,
                       sections_log=sections)
    return fg, sections


def test_autovfr_matches_single_stream_analysis(tmp_path):
    frames = telecined_frames(30) + interlaced_video_frames(30)
    fg, _ = _autovfr(frames, 3, str(tmp_path / "t"))
    assert _decisions(fg) == _decisions(_graph("kfm_vfr", frames))
    assert _decisions(fg) == _decisions(_jgraph("kfm_vfr", frames))
    assert fg.vfr_plan.source_frames == _jautovfr(
        frames, 3)[0].vfr_plan.source_frames


def test_autovfr_parallel_width_does_not_change_decisions():
    frames = telecined_frames(30) + interlaced_video_frames(30)
    got = {par: _autovfr(frames, par) for par in (1, 2, 3, 4)}
    want = _decisions(got[1][0])
    assert all(_decisions(fg) == want for fg, _ in got.values())
    assert [len(sec) for _, sec in got.values()] == [1, 2, 3, 4]
    for par, (_, sec) in got.items():
        assert sec == _jautovfr(frames, par)[1]


def test_autovfr_empty_section_padded():
    """A section whose decoder yields nothing still gives `want` cost rows
    (zeros), so later sections stay index-aligned; as the JAX graph."""
    frames = telecined_frames(40)

    def opener(start, end):
        if end > 20:
            return iter([])  # second section (halo frame 19 on): dead
        return iter(frames[max(0, start):end])

    fg, _ = _autovfr(frames, 2, opener=opener)
    jfg, _ = _jautovfr(frames, 2, opener=opener)
    assert _decisions(fg) == _decisions(jfg)
    np.testing.assert_array_equal(fg.frame_costs[20:], 0.0)
    ref = _graph("kfm_vfr", frames[:20])
    assert _decisions(fg)[:4] == _decisions(ref)[:4]


def test_autovfr_short_section_padded_with_its_last_row():
    frames = telecined_frames(40)

    def opener(start, end):
        return iter(frames[max(0, start):min(end, 33)])

    fg, _ = _autovfr(frames, 2, opener=opener)
    jfg, _ = _jautovfr(frames, 2, opener=opener)
    assert _decisions(fg) == _decisions(jfg)
    np.testing.assert_array_equal(fg.frame_costs[33:40],
                                  np.repeat(fg.frame_costs[32:33], 7, 0))


def test_autovfr_file_contracts(tmp_path):
    frames = telecined_frames(30) + interlaced_video_frames(30)
    _autovfr(frames, 2, str(tmp_path / "x"))
    _jautovfr(frames, 2, str(tmp_path / "j"))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["j.autovfr.def", "j.autovfr1.log", "j.autovfr2.log",
                     "x.autovfr.def", "x.autovfr1.log", "x.autovfr2.log"]
    for suffix in ("autovfr.def", "autovfr1.log", "autovfr2.log"):
        assert (tmp_path / f"x.{suffix}").read_text() == \
            (tmp_path / f"j.{suffix}").read_text()
    ranges = []
    for line in (tmp_path / "x.autovfr.def").read_text().splitlines():
        if not line.startswith("#"):
            ranges.append(tuple(int(v) for v in line.split()))
    assert ranges[0][0] == 0
    assert all(r1[0] == r0[1] for r0, r1 in zip(ranges, ranges[1:]))
    assert {r[2] for r in ranges} <= {24, 30, 60} and len(ranges) >= 2


def test_ordered_parallel_is_the_jax_packages():
    """Round-robin order over producers of different lengths, an empty one
    included, and a producer's error raised on the consumer."""
    producers = lambda: [iter(range(5)), iter([]), iter("abc"),  # noqa: E731
                         iter(range(10, 12))]
    assert list(ordered_parallel(producers())) == \
        list(j_ordered_parallel(producers()))

    def broken():
        yield 1
        raise ValueError("decoder died")

    with pytest.raises(ValueError, match="decoder died"):
        list(ordered_parallel([broken(), iter(range(3))]))


def test_launch_counts_survive_threads():
    """The kernels' launch counters take increments from the autovfr
    analysis's threads: 16 threads x 500 increments each, with the
    interpreter switching threads as often as it can, lose none."""
    import threading

    from amatsukaze_tpu_torch.ops import fused_filter, logo_eval

    before = (fused_filter.yadif_fieldmatch.launches["costs"],
              logo_eval.evaluate_logo.launches)

    def work():
        for _ in range(500):
            fused_filter.count_launch("costs")
            logo_eval.count_launch()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fused_filter.yadif_fieldmatch.launches["costs"] - before[0] == 8000
    assert logo_eval.evaluate_logo.launches - before[1] == 8000
    fused_filter.yadif_fieldmatch.launches["costs"] = before[0]
    logo_eval.evaluate_logo.launches = before[1]


def jax_autovfr_stage(frames, logos, batch, monkeypatch, parallel, prefix):
    """The JAX pipeline's autovfr file: the sectioned analysis of the
    source luma (its section opener decodes, it does not erase), then the
    erased frames through `_pump_filtered` (jax_post_stage's wiring)."""
    def analyze_autovfr_instead(self, frame_iter, num_frames):
        self.analyze_autovfr(_opener([f[0] for f in frames]), num_frames,
                             parallel=parallel, log_prefix=prefix)

    monkeypatch.setattr(JFilterGraph, "analyze", analyze_autovfr_instead)
    return jax_post_stage(frames, logos, "autovfr", batch, monkeypatch)


@pytest.mark.parametrize("parallel,own_opener", [(2, False), (3, True)])
def test_autovfr_stage_matches_jax(parallel, own_opener, tmp_path,
                                   monkeypatch):
    frames, _, logos, _ = synth_clip.golden_clip("small")
    jfg, jspec, jouts = jax_autovfr_stage(frames, logos, 8, monkeypatch,
                                          parallel, str(tmp_path / "j"))
    outs, opened = [], []

    def open_section(start, end):
        opened.append((start, end))
        return iter([f[0] for f in frames[max(0, start):end]])

    res = run_filter_stage(
        AMTContext(level="error"), lambda: iter(frames), len(frames),
        synth_clip.video_format(96, 128), logos, "autovfr", outs.append,
        batch=8, device="cpu", autovfr_parallel=parallel,
        autovfr_prefix=str(tmp_path / "p"),
        open_section=open_section if own_opener else None)
    assert res.spill_frames == 0
    assert len(opened) == (parallel if own_opener else 0)
    assert_same_graph(res, jfg, jspec, outs, jouts, "autovfr stage")
    assert (tmp_path / "p.autovfr.def").read_text() == \
        (tmp_path / "j.autovfr.def").read_text()


def _port_graph():
    return FilterGraph(AMTContext(level="error"), mode="autovfr",
                       batch=golden.AUTOVFR_BATCH, device="cpu")


def test_autovfr_matches_the_record():
    recorded = golden.load_autovfr()
    got = golden.autovfr_runs(_port_graph)
    assert got == recorded
    decisions = {str(r["decisions"]) for r in got.values()}
    assert len(decisions) == 1  # independent of `parallel`


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate testdata/golden_autovfr.json")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do without --write")
    runs = golden.autovfr_runs(lambda: JFilterGraph(
        JContext(level="error"), mode="autovfr",
        batch=golden.AUTOVFR_BATCH))
    assert golden.autovfr_runs(_port_graph) == runs, \
        "the port differs from JAX"
    golden.save_autovfr(runs, dict(
        clip=golden.AUTOVFR_CLIP, batch=golden.AUTOVFR_BATCH,
        writer="tests/test_torch_fps_modes.py --write (JAX package, CPU)"))
    print(f"wrote {golden.AUTOVFR_PATH}: "
          f"{len(runs['1']['decisions'])} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
