"""The post chain's counters (models/filter_graph.py, utils/perf.StageTimer):
per-stage seconds, the frames through the chain and the frames a
deblocking chain ran without QP maps, added to the recording's trace once
per output pass (pipeline/filter_stage.pump_filtered), on the CPU's host
clock. Timing changes no output bit, the counters add up over passes, a
missing QP map is counted and warned about once, and a graph with no chain
and no resize (the kfm_vfr path) records none of them."""

import io
import time

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from amatsukaze_tpu_torch.models import filter_graph
from amatsukaze_tpu_torch.models.filter_graph import (FilterGraph,
                                                      build_post_chain)
from amatsukaze_tpu_torch.pipeline.filter_stage import (pump_filtered,
                                                        run_filter_stage)
from amatsukaze_tpu_torch.ts.qp_extract import QpMapSource
from amatsukaze_tpu_torch.types import VideoFormat
from amatsukaze_tpu_torch.utils.context import AMTContext
from amatsukaze_tpu_torch.utils.perf import StageTimer

H, W, N = 48, 64, 45  # chunks of 8, 32 and a partial 5
CHAIN = "deblock,nr,deband,edge"
STAGES = ("deblock", "nr", "deband", "edge", "resize")


def clip(n=N, seed=3):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, (h, w), dtype=np.uint8)
                  for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
            for _ in range(n)]


def qp_maps(n=N, seed=4):
    rng = np.random.default_rng(seed)
    return [np.repeat(rng.choice([8, 10, 12], ((H + 15) // 16, 1)),
                      (W + 15) // 16, axis=1).astype(np.uint8)
            for _ in range(n)]


def graph(ctx, chain=CHAIN, maps=True, resize=(32, 24)):
    fg = FilterGraph(ctx, mode="yadif", batch=32, device="cpu",
                     post_chain=build_post_chain(chain),
                     qp_source=QpMapSource.from_maps(qp_maps())
                     if maps else None)
    fg.resize = resize
    return fg


def run(fg, frames):
    out = []
    pump_filtered(fg, iter(frames), out.append, 32)
    return out


def post_counters(ctx) -> dict:
    return {k: v for k, v in ctx.trace.counters.items()
            if k.startswith("post.")}


def test_timing_changes_no_output_bit():
    frames = clip()
    timed = graph(AMTContext(level="error"))
    untimed = graph(AMTContext(level="error"))
    untimed._timer = lambda: filter_graph._untimed  # the chain untimed
    a, b = run(timed, frames), run(untimed, frames)
    assert len(a) == len(b) == N
    for fa, fb in zip(a, b):
        for pa, pb in zip(fa, fb):
            np.testing.assert_array_equal(pa, pb)
    assert set(post_counters(untimed.ctx)) == {
        "post.frames", "post.deblock_skipped_frames"}


def test_counters_add_up_over_passes():
    ctx = AMTContext(level="error")
    fg = graph(ctx)
    frames = clip()
    t0 = time.perf_counter()
    run(fg, frames)
    wall = time.perf_counter() - t0
    first = post_counters(ctx)
    assert set(first) == {f"post.{s}_s" for s in STAGES} | {
        "post.frames", "post.deblock_skipped_frames"}
    assert first["post.frames"] == N
    assert first["post.deblock_skipped_frames"] == 0
    stage_s = [first[f"post.{s}_s"] for s in STAGES]
    assert all(s > 0 for s in stage_s) and sum(stage_s) <= wall
    # a second output pass (a two-pass encode) adds to the same counters
    run(fg, frames)
    second = post_counters(ctx)
    assert second["post.frames"] == 2 * N
    for s in STAGES:
        assert second[f"post.{s}_s"] > first[f"post.{s}_s"]


def test_stage_timer_sums_by_name_on_the_host_clock():
    timer = StageTimer(torch.device("cpu"))
    for _ in range(3):
        with timer("a"):
            time.sleep(0.01)
    with timer("b"):
        pass
    got = timer.collect()
    assert set(got) == {"a", "b"} and got["a"] >= 0.03 and got["b"] >= 0
    assert timer.collect() == {}


@pytest.mark.parametrize("maps", [False, True])
def test_missing_qp_maps_counted_and_warned_once(maps):
    log = io.StringIO()
    ctx = AMTContext(level="warn", out=log)
    fg = graph(ctx, maps=maps)
    frames = clip()
    run(fg, frames)
    run(fg, frames)  # two passes, one warning
    got = post_counters(ctx)
    warnings = [ln for ln in log.getvalue().splitlines()
                if ln.startswith("deblock:")]
    if maps:
        assert got["post.deblock_skipped_frames"] == 0 and not warnings
        assert got["post.deblock_s"] > 0
    else:
        assert got["post.deblock_skipped_frames"] == 2 * N
        assert "post.deblock_s" not in got
        assert warnings == [f"deblock: {N} of {N} output frames had no QP "
                            "maps; the post chain ran without deblock on "
                            "them"]


def test_chain_without_deblock_counts_no_skip():
    ctx = AMTContext(level="error")
    run(graph(ctx, chain="nr,edge", maps=False, resize=None), clip())
    assert post_counters(ctx).keys() == {"post.nr_s", "post.edge_s",
                                         "post.frames"}


def test_kfm_vfr_path_records_no_post_counter():
    frames = clip(60)
    fmt = VideoFormat(width=W, height=H, frame_rate_num=30000,
                      frame_rate_denom=1001, progressive=False)
    ctx = AMTContext(level="error")
    out = []
    res = run_filter_stage(ctx, lambda: iter(frames), len(frames), fmt, [],
                           "kfm_vfr", out.append, device="cpu")
    assert res.num_out_frames == len(out) > 0
    assert not post_counters(ctx)
