"""The harness's parts on the CPU: discovery by name, the window, the device
trace's arithmetic, the roofline work, the import guard, the fake encoder
and the reference against the writer's truth."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pb import compare, delogo, fake_encoder, roofline, synth, trace, traffic
from pb import window as win
from pb.probes import Span, interval_union
from pb.spec import (BENCH_DIR, REPO_DIR, load_cell, load_family, load_json,
                     load_metric_reader)

BENCH = load_json(REPO_DIR / "BENCHMARK.json")
SMALL = dict(width=128, height=96, logo_box=[96, 8, 24, 16])
KFM = load_family(load_cell("kfm_vfr.cm_logo", BENCH))


# -- discovery ---------------------------------------------------------------

@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = load_cell(cell, BENCH)
    assert c.config["geometry"]["width"] == 1440
    assert c.traffic["parts"] and c.traffic["entry"] in ("cli", "server")
    assert "outside_gap" in c.limits
    names = {m["name"] for m in c.end_to_end}
    assert names == {"device_memory_gb", "setup_s"}
    for m in c.per_layer:
        assert hasattr(load_metric_reader(m["name"]), "read")
        assert cell in m["workloads"]


def test_contract_shape():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in b["configs"]:
        conf = load_json(REPO_DIR / c["file"])
        assert all(k in conf for k in c["reduced"])
    for m in b["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert {w["chips"] for w in b["workloads"]} == {1}


def test_queue_mix_takes_cm_logo_recordings():
    queue = dict(name="kfm_vfr.queue2", config="isdb-mpeg2-kfm_vfr",
                 traffic="cm_logo_queue2", chips=1, why="the queue")
    c = load_cell("kfm_vfr.queue2",
                  dict(BENCH, workloads=BENCH["workloads"] + [queue]))
    assert c.traffic_name == "cm_logo"
    assert (c.traffic["entry"], c.traffic["clients"]) == ("server", 2)
    base = load_cell("kfm_vfr.cm_logo", BENCH)
    assert traffic._digest(c.traffic, SMALL) == \
        traffic._digest(base.traffic, SMALL)


# -- the window --------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("per, seconds, want", [
    (16.0, 40.0, 2), (16.0, 10.0, 1), (11.0, 40.0, 3), (21.0, 42.0, 2),
    (21.0, 41.9, 1)])
def test_window_holds_whole_recordings(per, seconds, want):
    clock = Clock()

    def run_one(i):
        clock.t += per
        return dict(ok=True)

    w = win.run_sequential(run_one, 900, seconds, clock)
    assert len(w.recordings) == want
    assert w.seconds == pytest.approx(per * want)
    assert w.fps == pytest.approx(900 / per)


def test_may_start_minimum_and_fit():
    assert win.may_start(50.0, None, 10.0, 0, 1)
    assert win.may_start(50.0, 30.0, 10.0, 1, 2)
    assert not win.may_start(20.0, 21.0, 40.0, 2, 2)
    assert win.may_start(19.0, 21.0, 40.0, 2, 2)


# -- the trace ---------------------------------------------------------------

def ev(a, b, name="k", cat="kernel"):
    return trace.DeviceEvent(name, cat, a, b)


def test_interval_union_and_idle_share():
    assert interval_union([(0, 2), (1, 3), (5, 6)]) == 4
    events = [ev(0.0, 2.0), ev(1.0, 3.0), ev(5.0, 6.0, cat="gpu_memcpy")]
    assert trace.busy_seconds(events, 0.0, 10.0) == 4.0
    assert trace.busy_seconds(events, 1.5, 5.5) == 2.0
    assert trace.idle_gaps(events, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    mod = load_metric_reader("device.idle_share")

    class Run:
        t0, t1 = 0.0, 10.0

    r = Run()
    r.events = events
    assert mod.read(r) == pytest.approx(60.0)
    r.events = []
    assert mod.read(r) is None


def test_device_events_on_the_host_clock():
    raw = [dict(ph="X", cat="kernel", name="marker", ts=1_000_000.0, dur=1),
           dict(ph="X", cat="cpu_op", name="aten::add", ts=1_000_010.0,
                dur=5),
           dict(ph="X", cat="kernel", name="k", ts=1_500_000.0, dur=250_000)]
    got = trace.device_events(raw, 42.0)
    assert [(e.name, e.t0, e.t1) for e in got] == [
        ("k", pytest.approx(42.5), pytest.approx(42.75))]


def test_breakdown_names_gaps_by_host_activity():
    spans = [Span("recording", 1, 0.0, 10.0),
             Span("cm_pass", 1, 0.0, 3.5),
             Span("decode", 1, 0.0, 4.0, 2,
                  dict(busy=1.0, intervals=[(0.5, 1.5)]))]
    events = [ev(0.0, 0.5, "a"), ev(1.5, 2.0, "b"), ev(6.0, 10.0, "a")]
    b = trace.breakdown(events, spans, 0.0, 10.0)
    assert b["device_ops"][0] == ["a", 4.5]
    assert b["idle_gaps"] == [["recording", 4.0], ["decode", 1.0]]


@pytest.mark.parametrize("name, want", [
    ("void yadif_fieldmatch_kernel<true, false, false, true, true>(Params)",
     (True, False)),
    ("void yadif_fieldmatch_kernel<false, true, false, true, true>(Params)",
     (False, True)),
    ("void yadif_fieldmatch_kernel<(bool)1, (bool)0, (bool)0, (bool)1>(P)",
     (True, False)),
    ("void logo_eval_kernel<true, 256, 2, false>(...)", None)])
def test_kernel_modes_from_names(name, want):
    assert roofline.yadif_mode(name) == want


# -- roofline work -----------------------------------------------------------

def test_roofline_work_from_shapes():
    # chip_smoke's K1 bound: 34x1080x1440 read and written once
    assert roofline.least_seconds(2 * 34 * 1080 * 1440, 0) * 1e3 == \
        pytest.approx(0.0316, abs=1e-4)
    n, h, w = 900, 1080, 1440
    assert roofline.field_match_costs(n, h, w) == pytest.approx(
        (n * h * w + 12 * n) / roofline.HBM_BYTES_PER_S)
    # K3 at the CM pass's shape: bound by operations, none fused
    n_mask = int(96 * 256 * 0.1)
    ops = 32 * (3 * n_mask + 11 * 109 * n_mask)
    assert roofline.logo_scores(32, 1, 96, 256) == pytest.approx(
        ops / (roofline.FP32_OPS_PER_S / 2))


def test_roofline_share_reads_kernel_time():
    mod = load_metric_reader("kernel.k2_roofline")

    class Run:
        t0, t1 = 0.0, 10.0
        geometry = dict(width=1440, height=1080)
        source_frames = 900

    r = Run()
    least = roofline.field_match_costs(900, 1080, 1440)
    name = "void yadif_fieldmatch_kernel<false, true, false, true, true>(P)"
    r.events = [ev(1.0, 1.0 + 2 * least, name),
                ev(2.0, 3.0, "void yadif_fieldmatch_kernel<true, false, "
                   "false, true, true>(P)")]
    assert mod.read(r) == pytest.approx(50.0)
    r.events = [ev(2.0, 3.0, "other")]
    assert mod.read(r) is None


# -- the import guard --------------------------------------------------------

def test_forbidden_modules_by_top_level_name():
    sys.path.insert(0, str(BENCH_DIR))
    import run

    names = ["jax", "jax.numpy", "jaxlib.xla", "flax", "amatsukaze_tpu",
             "amatsukaze_tpu.ops.deint", "amatsukaze_tpu_torch",
             "amatsukaze_tpu_torch.cli", "jaxtyping", "torch"]
    assert run.forbidden_modules(names) == [
        "amatsukaze_tpu", "amatsukaze_tpu.ops.deint", "flax", "jax",
        "jax.numpy", "jaxlib.xla"]
    assert run.forbidden_modules(["amatsukaze_tpu_torch.pipeline"]) == []


def test_run_refuses_without_the_repository(tmp_path):
    (tmp_path / "portbench").mkdir()
    (tmp_path / "BENCHMARK.json").write_text("{}")
    script = tmp_path / "portbench" / "run.py"
    script.write_text((BENCH_DIR / "run.py").read_text())
    r = subprocess.run([sys.executable, str(script), "--workload",
                        "kfm_vfr.cm_logo", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout == ""


# -- the fake encoder --------------------------------------------------------

def test_fake_encoder_keeps_digests_and_samples(tmp_path):
    rng = np.random.default_rng(1)
    w, h = 32, 16
    frames = [tuple(rng.integers(0, 256, s, dtype=np.uint8)
                    for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
              for _ in range(5)]
    stream = f"YUV4MPEG2 W{w} H{h} F30000:1001 Ip A1:1 C420mpeg2\n".encode()
    for f in frames:
        stream += b"FRAME\n" + b"".join(p.tobytes() for p in f)
    out = tmp_path / "o.bin"
    env = dict(os.environ, **{fake_encoder.KEEP_ENV: "1,4"})
    r = subprocess.run([sys.executable, fake_encoder.__file__, "--crf", "20",
                        "-o", str(out), "-"], input=stream, env=env)
    assert r.returncode == 0
    got = fake_encoder.load(str(out))
    assert got["n_frames"] == 5
    assert got["digests"] == [fake_encoder.frame_digest(f) for f in frames]
    assert sorted(got["frames"]) == [1, 4]
    for k in (1, 4):
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["frames"][k], frames[k]))
    assert not out.read_bytes().startswith(b"YUV4MPEG2")


# -- the reference against the writer's truth --------------------------------

def test_reconstruction_is_what_the_decoder_returns(tmp_path):
    """The writer's reconstruction equals the port's MPEG-2 decode of its
    pictures (the frames the reference starts from)."""
    from amatsukaze_tpu_torch.pipeline.decoders import decode_mpeg2_ps_file

    mix = load_json(BENCH_DIR / "traffic" / "cm_logo.json")
    rec, _ = traffic.layout(mix, SMALL, 7)
    es = b"".join(synth.encode_intra_picture(
        rec.frame(k), rec.row_qs[k], temporal_reference=k,
        with_sequence=k == 0) for k in range(3)) + b"\x00\x00\x01\xB7"
    path = tmp_path / "v.m2v"
    path.write_bytes(es)
    got = list(decode_mpeg2_ps_file(str(path), is_ps=False))
    assert len(got) == 3
    for k, frame in enumerate(got):
        assert all(np.array_equal(np.asarray(a), b)
                   for a, b in zip(frame, rec.reconstruct(k)))


def test_kfm_plan_from_the_layout():
    mix = load_json(BENCH_DIR / "traffic" / "cm_logo.json")
    rec, truth = traffic.layout(mix, SMALL, 11)
    plan, ticks = KFM.kfm_plan(rec, truth["frames"])
    film = [k for s in rec.scenes if s.film for k in range(s.first, s.end)]
    video = [k for s in rec.scenes if not s.film
             for k in range(s.first, s.end)]
    assert ticks.count(KFM.FILM_TICKS) == len(film) * 4 // 5
    assert ticks.count(KFM.VIDEO_TICKS) == len(video)
    for (top, bottom), t in zip(plan, ticks):
        _, tt, _ = rec.field_times(top)
        _, _, bb = rec.field_times(bottom)
        if t == KFM.FILM_TICKS:
            assert tt == bb  # one film instant in both fields
    tc = KFM.timecodes(ticks)
    assert tc[1] == pytest.approx(5 * 1001 / 120)


def test_truth_of_the_layout():
    mix = load_json(BENCH_DIR / "traffic" / "cm_logo.json")
    for seed in (1, 2**31 + 5):
        _, truth = traffic.layout(mix, SMALL, seed)
        assert truth["trims"] == [0, 225, 675, 900]
        assert truth["cm_zones"] == [[225, 675]]
        assert sorted(truth["logo_order"]) == [0, 1]
        cuts = [s["first"] for s in truth["scenes"]]
        assert all(c % 5 == 0 for c in cuts)
    fade = delogo.fade_curve(truth)
    assert fade[0] == 1.0 and fade[450] == 0.0
    assert 0.0 < fade[224] < 1.0


@pytest.mark.parametrize("fade", [0.0, 0.6, 1.0])
def test_fit_box_finds_the_fade(fade):
    mix = load_json(BENCH_DIR / "traffic" / "cm_logo.json")
    rec, truth = traffic.layout(mix, SMALL, 3)
    planes = synth.make_logos(96, 128, tuple(SMALL["logo_box"]))[0]
    config = load_cell("kfm_vfr.cm_logo", BENCH).config
    ref = KFM.reference(config, rec, truth, SMALL, planes)
    ref.raw = {0: rec.reconstruct(0), 1: rec.reconstruct(1)}
    f = np.float32(round(fade * 90) / 90)
    got = KFM.weave(ref.erased(ref.raw[0], f), ref.erased(ref.raw[1], 0.0))
    gap, fades = ref.fit_box(got, ("weave", 0, 1))
    assert gap == 0.0
    assert fades == pytest.approx((float(f), 0.0))
    low = KFM.reference(config, rec, truth, SMALL, planes,
                        dtype=torch.bfloat16)
    low_got = KFM.weave(low.erased(ref.raw[0], 1.0),
                        low.erased(ref.raw[1], 1.0))
    assert ref.fit_box(low_got, ("weave", 0, 1))[0] > 0.05


def test_recordings_differ_by_their_digests():
    same = dict(n_frames=3, digests=[b"a", b"b", b"c"], frames={})
    other = dict(same, digests=[b"a", b"x", b"c"])
    assert compare.recordings_differ([same]) == 0
    assert compare.recordings_differ([same, dict(same), None]) == 0
    assert compare.recordings_differ([same, other, dict(same)]) == 1
    assert compare.recordings_differ([None, other, same]) == 1


def test_sample_indices_from_the_seed():
    a = compare.sample_indices(810, 5, 10, [179, 180])
    assert a == compare.sample_indices(810, 5, 10, [179, 180])
    assert {0, 809, 179, 180} <= set(a) and len(a) == 14
    assert a != compare.sample_indices(810, 6, 10, [179, 180])


def test_lgd_round_trip(tmp_path):
    planes = synth.make_logos(96, 128, tuple(SMALL["logo_box"]))[0]
    p = tmp_path / "l.lgd"
    traffic.write_lgd(str(p), planes, SMALL, "painted", synth.SERVICE_ID)
    from pb.harness import read_lgd_planes

    assert all(np.array_equal(a, b) for a, b in zip(read_lgd_planes(str(p)),
                                                     planes))
    from amatsukaze_tpu_torch.models.lgd import load_lgd

    lg = load_lgd(str(p))
    assert lg.header.service_id == synth.SERVICE_ID
    assert np.array_equal(lg.a_y, planes[0])
    assert (lg.header.imgx, lg.header.imgy) == (96, 8)
