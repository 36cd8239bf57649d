"""The family `yadif_post` (families/yadif_post.py) on the CPU: its chain
against the port's (models/filter_graph.build_post_chain, ops/resize.py,
K1's plain path) stage by stage and through the port's output pass, its
threefry against Random123's known answers and the port's draws, its
compared numbers and both controls held to a record, and a run without QP
maps judged wrong.

`PYTHONPATH=portbench:. python portbench/tests/test_portbench_yadif_post.py
--write` records the compared numbers anew
(portbench/tests/yadif_post_compared.json)."""

import json
import sys
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from pb.spec import load_cell, load_family, load_json
from test_portbench_compared_record import exactly
from test_portbench_rehearsal import (  # noqa: F401 (fixtures)
    BENCH, SMALL, altered_output, drop_half, few_threads, own_cache,
    rehearse)

from amatsukaze_tpu_torch.models.filter_graph import (FilterGraph,
                                                      build_post_chain)
from amatsukaze_tpu_torch.ops import denoise, threefry
from amatsukaze_tpu_torch.ops.fused_filter import yadif_fieldmatch_plain
from amatsukaze_tpu_torch.ops.resize import resize_lanczos3
from amatsukaze_tpu_torch.pipeline.filter_stage import pump_filtered
from amatsukaze_tpu_torch.ts.qp_extract import QpMapSource
from amatsukaze_tpu_torch.utils.context import AMTContext

CELL = "post720.cm_logo"
FAM = load_family(load_cell(CELL, BENCH))
RECORDED = Path(__file__).with_name("yadif_post_compared.json")
H, W, N = 96, 128, 45  # chunks of 8, 32 and a partial 5
OUT = (112, 64)  # a downscale in both directions, as 1440x1080 -> 1280x720
CHAIN = "deblock,nr,deband,edge"


def clip(seed=3):
    """Smooth moving planes with noise and per-row quantiser scales, so
    that every filter changes pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for k in range(N):
        planes = []
        for s in (1, 2, 2):
            h, w = H // s, W // s
            base = 120 + 60 * np.sin((xx[:h, :w] + 3 * k) / (9.0 / s)) \
                * np.cos(yy[:h, :w] / (13.0 / s))
            planes.append(np.clip(base + rng.integers(-3, 4, (h, w)), 0,
                                  255).astype(np.uint8))
        frames.append(tuple(planes))
    row_qs = rng.choice([8, 10, 12], (N, (H + 15) // 16))
    return frames, row_qs


class Rec:
    """The recording as the reference reads it: frames and row scales."""
    h, w = H, W

    def __init__(self, frames, row_qs):
        self.frames, self.row_qs = frames, row_qs

    def reconstruct(self, k):
        return self.frames[k]


def reference(frames, row_qs, out=OUT, chain=CHAIN):
    config = dict(cli_args=["--filter-mode", "yadif", "--post-filter", chain,
                            "--resize", f"{out[0]}x{out[1]}"])
    truth = dict(frames=N, parts=[dict(first=0)], logos_given=False)
    geometry = dict(width=W, height=H, logo_box=[0, 0, 16, 16])
    return FAM.reference(config, Rec(frames, row_qs), truth, geometry, None,
                         torch.float32, "cpu")


def port(frames, row_qs, out=OUT, chain=CHAIN):
    maps = [np.repeat(q[:, None], (W + 15) // 16, axis=1).astype(np.uint8)
            for q in row_qs]
    fg = FilterGraph(AMTContext(level="error"), mode="yadif", batch=32,
                     device="cpu", post_chain=build_post_chain(chain),
                     qp_source=QpMapSource.from_maps(maps))
    fg.resize = out
    got = []
    pump_filtered(fg, iter(frames), got.append, 32)
    return got


# -- the chain, stage by stage -------------------------------------------------

def planes(seed, n=6, h=H, w=W, lo=0, hi=256):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, (n, h, w))
                            .astype(np.float32))


def test_yadif_is_k1s_plain_path():
    """Bit for bit: both take the same half-integer means and round half
    up."""
    x = planes(1).to(torch.uint8)
    want = yadif_fieldmatch_plain(x)[0]
    prev = torch.cat([x[:1], x[:-1]])
    nxt = torch.cat([x[1:], x[-1:]])
    torch.testing.assert_close(FAM.yadif(prev, x, nxt, torch.float32), want,
                               rtol=0, atol=0)


def test_deblock_against_the_port():
    """Within 2e-4 of a level: the reference takes each DCT in float64 and
    rounds it once to float32, the port sums eight float32 products in
    XLA's order, twice per transform, so the two differ by float32 steps of
    coefficients up to ~2000. The samples are not whole numbers here:
    coefficients whose basis rows are (0, 4) are multiples of 1/8 of whole
    samples and can sit exactly on a threshold (2q), where a float step
    decides the test and moves the block by about a level (the chain's
    test below meets those)."""
    rng = np.random.default_rng(2)
    for h, per_mb in ((H, 2), (H // 2, 1), (44, 1)):
        x = planes(2, h=h, w=64) + torch.from_numpy(
            rng.random((6, h, 64)).astype(np.float32))
        mbh, mbw = -(-h // (8 * per_mb)), 64 // (8 * per_mb)
        qp = torch.from_numpy(rng.choice([8.0, 10.0, 12.0], (6, mbh, mbw))
                              .astype(np.float32))
        hp = -(-h // 8) * 8
        xp = torch.nn.functional.pad(x[:, None], (0, 0, 0, hp - h),
                                     mode="replicate")[:, 0]
        want = denoise.deblock_qp(xp, qp, qp_block_scale=per_mb)[:, :h]
        got = FAM.deblock(x, qp, per_mb, torch.float32)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


def test_nr_deband_edge_bit_equal_to_the_port():
    """Bit for bit: the same float32 operations in the same order (NR's
    neighbours +1, -1, +2, -2; deband's pixel, then each step's pair; edge
    level's sharpening rounded once)."""
    x = planes(3, n=32, lo=0, hi=16384) * 1.0
    nr = denoise.temporal_nr(x)
    slots = dict(enumerate(x))
    for i in (0, 1, 15, 30, 31):
        torch.testing.assert_close(FAM.temporal_nr(slots, i, torch.float32),
                                   nr[i], rtol=0, atol=0)
    smooth = planes(4, n=32, lo=4000, hi=4200)
    db = denoise.deband(smooth, 0)
    offs = FAM.deband_offsets("cpu")
    for i in (0, 7, 31):
        torch.testing.assert_close(FAM.deband(smooth[i], i, offs,
                                              torch.float32),
                                   db[i], rtol=0, atol=0)
    edges = planes(5, n=2, lo=0, hi=3000)
    want = denoise.edge_level(edges)
    for i in range(2):
        torch.testing.assert_close(FAM.edge_level(edges[i], torch.float32),
                                   want[i], rtol=0, atol=0)


@pytest.mark.parametrize("size", [(112, 64), (1280, 720), (128, 96)])
def test_resize_against_the_port(size):
    """Within 2.5e-4 of a level: the same weights (jax.image.resize's,
    computed in float32), summed by a matrix product here and tap by tap
    in the port; each of up to 14 taps a side rounds its sum to a float32
    step of 256 (1.5e-5), in another order."""
    x = planes(6, n=3)
    want = resize_lanczos3(x, size[1], size[0])
    got = FAM.resize(x, size[1], size[0], torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=2.5e-4)


def test_chain_through_the_ports_output_pass():
    """The whole chain over 45 frames in the port's output pass (chunks of
    8, 32 and a partial 5): the float steps above tip NR's and deband's
    threshold tests and the final rounding at a few pixels, so a pixel may
    be off by a level and very few by two; none by more."""
    frames, row_qs = clip()
    got = port(frames, row_qs)
    want = reference(frames, row_qs).frames(list(range(N)))
    assert len(got) == N
    gaps = np.concatenate([
        np.abs(g.astype(np.int32) - w.astype(np.int32)).ravel()
        for k in range(N) for g, w in zip(got[k], want[k][0][0])])
    assert gaps.max() <= 2
    assert (gaps > 0).mean() < 1e-4 and (gaps > 1).mean() < 1e-5


def test_batches_are_the_output_pass_chunks():
    assert FAM.batches(45) == [(0, 8), (8, 32), (40, 5)]
    assert FAM.batches(900)[-1] == (872, 28) and len(FAM.batches(900)) == 29
    assert FAM.batches(8) == [(0, 8)]
    assert FAM.batches(40) == [(0, 8), (8, 32)]


# -- threefry ------------------------------------------------------------------

@pytest.mark.parametrize("key, ctr, want", [
    # Random123's kat_vectors for threefry2x32_20: (key, counter, output)
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    got = FAM.threefry2x32(key, ctr)
    assert tuple(int(v) for v in got) == want


def test_threefry_draws_are_the_ports():
    keys = FAM.fold_in(FAM.prng_key(5)[None], torch.arange(6))
    torch.testing.assert_close(
        keys, threefry.fold_in(threefry.prng_key(5), torch.arange(6)),
        rtol=0, atol=0)
    a, b = FAM.split2(keys)
    torch.testing.assert_close(torch.stack([a, b], 1), threefry.split(keys),
                               rtol=0, atol=0)
    for shape, lo, hi in (((9, 13), 0, 8), ((8, 2), -15, 16)):
        torch.testing.assert_close(FAM.randint(keys, shape, lo, hi),
                                   threefry.randint(keys, shape, lo, hi),
                                   rtol=0, atol=0)
    assert FAM.deband_offsets("cpu") == [denoise.deband_offsets(0, s)
                                         for s in range(2)]


# -- the compared numbers and the controls, held to a record ------------------

def no_qp_maps():
    """The chain without deblock: the pipeline finds no QP maps."""
    from amatsukaze_tpu_torch.pipeline.transcode import TranscodePipeline

    return mock.patch.object(TranscodePipeline, "_qp_source",
                             lambda self, key, file: None)


FAULTS = dict(no_qp_maps=no_qp_maps,
              drop_half=lambda: altered_output(drop_half))
# case: (seed, fault or None)
CASES = {"seed5": (5, None), "no_qp_maps": (5, "no_qp_maps"),
         "drop_half": (6, "drop_half")}
CONTROL_SEED = 17


def case_out(case: str) -> dict:
    seed, fault = CASES[case]
    with exactly(1), (FAULTS[fault]() if fault else nullcontext()):
        return rehearse(load_cell(CELL, BENCH), seed=seed)


def numbers(out: dict) -> dict:
    return {k: v["value"] for k, v in out["compared"].items()}


def control_case() -> dict:
    from pb import control

    return control.control_numbers(load_cell(CELL, BENCH), CONTROL_SEED,
                                   "cpu", SMALL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compared_numbers_as_recorded(case):
    out = case_out(case)
    assert numbers(out) == load_json(RECORDED)["runs"][case]
    assert out["correct"] is (FAULTS.get(CASES[case][1]) is None)


def test_controls_as_recorded_and_wrong():
    from pb import control

    got = control_case()
    assert got == load_json(RECORDED)["controls"]
    limits = load_cell(CELL, BENCH).limits
    for kind in ("lower", "guarantee"):
        assert not control.judged(got[kind], limits), (kind, got[kind])


def write_recorded(tmp: Path) -> None:
    """The record, made with the recordings and work directories under
    tmp, as the tests' fixtures make them."""
    import tempfile

    from pb import traffic

    orig = traffic.ensure_recording

    def ensure(*a, **kw):
        kw.setdefault("cache_dir", tmp / "cache")
        return orig(*a, **kw)

    traffic.CACHE_DIR = tmp / "cache"
    traffic.ensure_recording = ensure
    (tmp / "tmp").mkdir(parents=True, exist_ok=True)
    tempfile.tempdir = str(tmp / "tmp")
    torch.set_num_threads(2)
    out = dict(runs={c: numbers(case_out(c)) for c in sorted(CASES)},
               controls=control_case())
    RECORDED.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__" and "--write" in sys.argv:
    import tempfile as _tf

    with _tf.TemporaryDirectory() as d:
        write_recorded(Path(d))
